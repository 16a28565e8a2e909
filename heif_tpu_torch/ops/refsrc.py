"""The reference-source stage of `batch.core`: where each reference
sample of every TU comes from.

`ref_sources2` is stage 2a of heif_tpu.ops.batch._core (its lines
509-516, jax_recon.ref_sources_device on the luma and the chroma
worklist). No Pallas kernel stands behind it there: XLA fuses its jnp
code. On CUDA tensors the wrapper launches the kernel of csrc/refsrc.cu
(built on first use by ops._build) once for both worklists, on the
current stream, and raises if the launch fails; `ref_sources` does the
same for one worklist. On CPU tensors both run ref_sources_plain
(recon.ref_sources), the plain PyTorch version, which is also the
kernel's oracle on the card. There is no fallback from one to the other.
LAUNCHES counts kernel launches only.

The kernel tests availability once per 4x4 luma block, which is exact
where the picture's sides and its interior tile boundaries are multiples
of 8 luma samples, as HEVC makes them (MinCbSizeY >= 8, tiles of whole
CTBs): both wrappers raise on other geometry, on the CPU too.
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
ALIGN = 8  # luma samples: picture sides and tile boundaries
_FIELDS = 3  # x, y, size


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_steps(name, steps):
    if steps.dtype != torch.int32:
        raise TypeError(f"{name}: dtype {steps.dtype}, expected torch.int32")
    if steps.dim() != 3 or steps.shape[2] < _FIELDS:
        raise ValueError(f"{name}: shape {tuple(steps.shape)}, expected "
                         f"[N, S, >={_FIELDS}] (x, y, size, ...)")
    if not steps.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if steps.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {steps.device}")


def _check_geometry(W, H, ctb_log2, tile_col_bd, tile_row_bd):
    if W <= 0 or H <= 0 or W % ALIGN or H % ALIGN:
        raise ValueError(f"picture of {W}x{H}: sides must be positive "
                         f"multiples of {ALIGN} (HEVC: of MinCbSizeY)")
    if not 4 <= ctb_log2 <= 6:
        raise ValueError(f"ctb_log2 {ctb_log2}: HEVC CTBs are 16 to 64")
    if len(tile_col_bd) > MAX_TILE_COLS or len(tile_row_bd) > MAX_TILE_ROWS:
        raise ValueError(f"{len(tile_col_bd)} x {len(tile_row_bd)} interior "
                         f"tile boundaries, at most {MAX_TILE_COLS} x "
                         f"{MAX_TILE_ROWS}")
    if any(b % ALIGN for b in (*tile_col_bd, *tile_row_bd)):
        raise ValueError(f"tile boundaries {tile_col_bd} x {tile_row_bd}: "
                         f"multiples of {ALIGN} (HEVC: of the CTB size)")


def _check_args(steps, comp, W, H, ctb_log2, tile_col_bd, tile_row_bd):
    _check_steps("steps", steps)
    if comp not in (0, 1):
        raise ValueError(f"comp {comp}: 0 (luma) or 1 (chroma)")
    _check_geometry(W, H, ctb_log2, tile_col_bd, tile_row_bd)


def ref_sources_plain(steps, *, comp: int, W: int, H: int, ctb_log2: int,
                      tile_col_bd: tuple = (), tile_row_bd: tuple = ()):
    """Plain PyTorch source tables on any device; same contract as
    ref_sources: recon.ref_sources on the step fields x, y and size."""
    return R.ref_sources(steps[..., 0], steps[..., 1], steps[..., 2],
                         comp=comp, W=W, H=H, ctb_log2=ctb_log2,
                         tile_col_bd=tile_col_bd, tile_row_bd=tile_row_bd)


def _launch(lists, W, H, ctb_log2, tile_col_bd, tile_row_bd) -> list:
    """One kernel launch for lists = [luma steps or None, chroma steps or
    None] on one CUDA device; returns their tables (None where absent)."""
    from heif_tpu_torch.ops import _build

    dev = next(st.device for st in lists if st is not None)
    args, outs = [], []
    for st in lists:
        if st is None:
            outs.append(None)
            args += [None, None, 0, 0, _FIELDS]
            continue
        n, s, f = st.shape
        out = torch.empty((n, s, 2, R.REF_LEN), dtype=torch.uint8, device=dev)
        outs.append(out)
        args += [st.data_ptr(), out.data_ptr(), n, s, f]
    cols = (ctypes.c_int * MAX_TILE_COLS)(*tile_col_bd)
    rows = (ctypes.c_int * MAX_TILE_ROWS)(*tile_row_bd)
    rc = _build.load().heif_ref_sources2(
        *args, W, H, ctb_log2, cols, len(tile_col_bd), rows, len(tile_row_bd),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"heif_ref_sources2 launch failed: "
                           f"{'bad arguments' if rc == -1 else 'CUDA error'}"
                           f" {rc}")
    if any(o is not None and o.numel() for o in outs):
        LAUNCHES["ref_sources"] += 1
    return outs


def ref_sources(steps, *, comp: int, W: int, H: int, ctb_log2: int,
                tile_col_bd: tuple = (), tile_row_bd: tuple = ()):
    """The [N, S, 2, 65] uint8 source table of a worklist (recon.ref_sources'
    contract). steps: [N, S, >=3] int32, fields x, y, size (component
    samples; size 0 marks padding steps); comp: 0 luma, 1 chroma (4:2:0);
    W, H: the luma picture size; ctb_log2: log2 of the luma CTB size;
    tile_col_bd / tile_row_bd: interior HEVC tile boundaries in luma
    samples."""
    _check_args(steps, comp, W, H, ctb_log2, tile_col_bd, tile_row_bd)
    if steps.device.type == "cpu":
        return ref_sources_plain(steps, comp=comp, W=W, H=H,
                                 ctb_log2=ctb_log2, tile_col_bd=tile_col_bd,
                                 tile_row_bd=tile_row_bd)
    lists = [None, None]
    lists[comp] = steps
    return _launch(lists, W, H, ctb_log2, tile_col_bd, tile_row_bd)[comp]


def ref_sources2(steps_luma, steps_chroma, *, W: int, H: int, ctb_log2: int,
                 tile_col_bd: tuple = (), tile_row_bd: tuple = ()) -> list:
    """[luma, chroma] source tables of the two worklists of a batch (each
    as ref_sources gives it), in one kernel launch on CUDA."""
    _check_steps("steps_luma", steps_luma)
    _check_steps("steps_chroma", steps_chroma)
    if steps_luma.device != steps_chroma.device:
        raise ValueError(f"worklists on {steps_luma.device} and "
                         f"{steps_chroma.device}")
    _check_geometry(W, H, ctb_log2, tile_col_bd, tile_row_bd)
    if steps_luma.device.type == "cpu":
        return [ref_sources_plain(st, comp=c, W=W, H=H, ctb_log2=ctb_log2,
                                  tile_col_bd=tile_col_bd,
                                  tile_row_bd=tile_row_bd)
                for c, st in enumerate((steps_luma, steps_chroma))]
    return _launch([steps_luma, steps_chroma], W, H, ctb_log2, tile_col_bd,
                   tile_row_bd)


def refsrc_bytes(steps) -> int:
    """The bytes a source table of these steps must move (its time bound
    at the card's memory rate): the three fields of each step read once
    and its 130 table bytes written once. The availability tests are a
    few dozen integer operations a 4x4 block of the walk, far below the
    card's integer rate, so bytes bound the kernel."""
    n_steps = steps.shape[0] * steps.shape[1]
    return n_steps * (_FIELDS * 4 + 2 * R.REF_LEN)
