"""The reference-source stage of `batch.core`: where each reference
sample of every TU comes from.

`ref_sources` is stage 2a of heif_tpu.ops.batch._core (its lines 509-516,
jax_recon.ref_sources_device). No Pallas kernel stands behind it there:
XLA fuses its jnp code. On a CUDA tensor the wrapper launches the kernel
of csrc/refsrc.cu (built on first use by ops._build) once for the
worklist, on the current stream, and raises if the launch fails. On a CPU
tensor it runs ref_sources_plain (recon.ref_sources), the plain PyTorch
version, which is also the kernel's oracle on the card. There is no
fallback from one to the other. LAUNCHES counts kernel launches only.
"""

from __future__ import annotations

import ctypes

import torch

from heif_tpu_torch.ops import recon as R

LAUNCHES = {"ref_sources": 0}
# csrc/refsrc.cu: interior HEVC tile boundaries it holds (HEVC allows 20
# tile columns and 22 tile rows, so 19 and 21 interior ones)
MAX_TILE_COLS = 20
MAX_TILE_ROWS = 22
_FIELDS = 3  # x, y, size


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_args(steps, comp, W, H, ctb_log2, tile_col_bd, tile_row_bd):
    if steps.dtype != torch.int32:
        raise TypeError(f"steps: dtype {steps.dtype}, expected torch.int32")
    if steps.dim() != 3 or steps.shape[2] < _FIELDS:
        raise ValueError(f"steps: shape {tuple(steps.shape)}, expected "
                         f"[N, S, >={_FIELDS}] (x, y, size, ...)")
    if not steps.is_contiguous():
        raise ValueError("steps: not contiguous")
    if steps.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {steps.device}")
    if comp not in (0, 1):
        raise ValueError(f"comp {comp}: 0 (luma) or 1 (chroma)")
    if W <= 0 or H <= 0:
        raise ValueError(f"picture of {W}x{H}")
    if not 4 <= ctb_log2 <= 6:
        raise ValueError(f"ctb_log2 {ctb_log2}: HEVC CTBs are 16 to 64")
    if len(tile_col_bd) > MAX_TILE_COLS or len(tile_row_bd) > MAX_TILE_ROWS:
        raise ValueError(f"{len(tile_col_bd)} x {len(tile_row_bd)} interior "
                         f"tile boundaries, at most {MAX_TILE_COLS} x "
                         f"{MAX_TILE_ROWS}")


def ref_sources_plain(steps, *, comp: int, W: int, H: int, ctb_log2: int,
                      tile_col_bd: tuple = (), tile_row_bd: tuple = ()):
    """Plain PyTorch source tables on any device; same contract as
    ref_sources: recon.ref_sources on the step fields x, y and size."""
    return R.ref_sources(steps[..., 0], steps[..., 1], steps[..., 2],
                         comp=comp, W=W, H=H, ctb_log2=ctb_log2,
                         tile_col_bd=tile_col_bd, tile_row_bd=tile_row_bd)


def ref_sources(steps, *, comp: int, W: int, H: int, ctb_log2: int,
                tile_col_bd: tuple = (), tile_row_bd: tuple = ()):
    """The [N, S, 2, 65] uint8 source table of a worklist (recon.ref_sources'
    contract). steps: [N, S, >=3] int32, fields x, y, size (component
    samples; size 0 marks padding steps); comp: 0 luma, 1 chroma (4:2:0);
    W, H: the luma picture size; ctb_log2: log2 of the luma CTB size;
    tile_col_bd / tile_row_bd: interior HEVC tile boundaries in luma
    samples."""
    _check_args(steps, comp, W, H, ctb_log2, tile_col_bd, tile_row_bd)
    dev = steps.device
    if dev.type == "cpu":
        return ref_sources_plain(steps, comp=comp, W=W, H=H,
                                 ctb_log2=ctb_log2, tile_col_bd=tile_col_bd,
                                 tile_row_bd=tile_row_bd)
    from heif_tpu_torch.ops import _build

    n, s, f = steps.shape
    out = torch.empty((n, s, 2, R.REF_LEN), dtype=torch.uint8, device=dev)
    cols = (ctypes.c_int * MAX_TILE_COLS)(*tile_col_bd)
    rows = (ctypes.c_int * MAX_TILE_ROWS)(*tile_row_bd)
    rc = _build.load().heif_ref_sources(
        steps.data_ptr(), out.data_ptr(), n, s, f, comp, W, H, ctb_log2,
        cols, len(tile_col_bd), rows, len(tile_row_bd),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"heif_ref_sources launch failed: "
                           f"{'bad arguments' if rc == -1 else 'CUDA error'}"
                           f" {rc}")
    if n * s:
        LAUNCHES["ref_sources"] += 1
    return out


def refsrc_bytes(steps) -> int:
    """The bytes a source table of these steps must move (its time bound
    at the card's memory rate): the three fields of each step read once
    and its 130 table bytes written once. The availability tests are a
    few dozen integer operations a walk position, far below the card's
    integer rate, so bytes bound the kernel."""
    n_steps = steps.shape[0] * steps.shape[1]
    return n_steps * (_FIELDS * 4 + 2 * R.REF_LEN)
