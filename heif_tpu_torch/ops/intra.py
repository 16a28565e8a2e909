"""Intra-walk wrappers: the CUDA kernels on CUDA tensors, the plain walk
on CPU tensors.

intra_scan_luma replaces heif_tpu.ops.pallas_intra.intra_scan_pallas and
intra_scan_chroma2 replaces intra_scan_pallas_chroma2. On a CUDA tensor
each launches its kernel from csrc/intra.cu (built on first use by
ops._build) on the current stream, and raises if the launch fails. On a
CPU tensor each runs recon.intra_scan_component, the plain PyTorch walk
that is also the kernels' oracle. There is no fallback from one to the
other. LAUNCHES counts kernel launches (not plain runs), so a caller can
show that a decode went through the kernels.
"""

from __future__ import annotations

import torch

from heif_tpu_torch.ops import recon as R
from heif_tpu_torch.tables import tables_on

LAUNCHES = {"luma": 0, "chroma": 0}

_STEP_FIELDS = 6


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_walk(res, pcm, steps, src, counts, h, w):
    n = res.shape[0]
    dev = res.device
    s = steps.shape[1]
    _check("res", res, torch.int32, (n, h + R.PAD, w + R.PAD), dev)
    if pcm is not None:
        _check("pcm", pcm, torch.int32, (n, h + R.PAD, w + R.PAD), dev)
    _check("steps", steps, torch.int32, (n, s, _STEP_FIELDS), dev)
    _check("src", src, torch.uint8, (n, s, 2, R.REF_LEN), dev)
    _check("counts", counts, torch.int32, (n,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def _plane(n, h, w, dev):
    return torch.zeros((n, 1 + h + R.SPAD, 1 + w + R.SPAD), dtype=torch.int32,
                       device=dev)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def intra_scan_luma(res, steps, src, counts, pcm=None, *, h: int, w: int,
                    strong_smoothing: bool, bd: int) -> torch.Tensor:
    """Luma intra walk over N tiles.

    res / pcm: [N, h+PAD, w+PAD] int32 (pcm None when no tile has PCM);
    steps: [N, S, 6] int32 per-TU (x, y, size, mode, filter, pcm);
    src: [N, S, 2, 65] uint8 (recon.ref_sources); counts: [N] int32.
    Returns [N, h, w] int32 reconstructed planes.
    """
    _check_walk(res, pcm, steps, src, counts, h, w)
    if res.device.type == "cpu":
        return luma_plain(res, steps, src, counts, pcm, h=h, w=w,
                          strong_smoothing=strong_smoothing, bd=bd)
    from heif_tpu_torch.ops import _build

    n, s = steps.shape[0], steps.shape[1]
    plane = _plane(n, h, w, res.device)
    rc = _build.load().heif_intra_luma(
        plane.data_ptr(), res.data_ptr(), _ptr(pcm), steps.data_ptr(),
        src.data_ptr(), counts.data_ptr(), n, s, plane.shape[1],
        plane.shape[2], res.shape[1], res.shape[2], bd,
        int(bool(strong_smoothing)),
        torch.cuda.current_stream(res.device).cuda_stream,
    )
    _raise_on(rc, "heif_intra_luma")
    LAUNCHES["luma"] += 1
    return plane[:, 1 : 1 + h, 1 : 1 + w]


def intra_scan_chroma2(res_cb, res_cr, steps, src, counts, pcm_cb=None,
                       pcm_cr=None, *, h: int, w: int, bd: int):
    """Cb + Cr intra walk over N tiles sharing one worklist (HEVC shares
    chroma TU geometry and mode). Shapes as in intra_scan_luma, at the
    chroma plane size (h, w). Returns (cb, cr) [N, h, w] int32."""
    _check_walk(res_cb, pcm_cb, steps, src, counts, h, w)
    _check_walk(res_cr, pcm_cr, steps, src, counts, h, w)
    dev = res_cb.device
    if dev.type == "cpu":
        return chroma2_plain(res_cb, res_cr, steps, src, counts, pcm_cb,
                             pcm_cr, h=h, w=w, bd=bd)
    from heif_tpu_torch.ops import _build

    n, s = steps.shape[0], steps.shape[1]
    cb = _plane(n, h, w, dev)
    cr = _plane(n, h, w, dev)
    rc = _build.load().heif_intra_chroma2(
        cb.data_ptr(), cr.data_ptr(), res_cb.data_ptr(), res_cr.data_ptr(),
        _ptr(pcm_cb), _ptr(pcm_cr), steps.data_ptr(), src.data_ptr(),
        counts.data_ptr(), n, s, cb.shape[1], cb.shape[2],
        res_cb.shape[1], res_cb.shape[2], bd,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "heif_intra_chroma2")
    LAUNCHES["chroma"] += 1
    return cb[:, 1 : 1 + h, 1 : 1 + w], cr[:, 1 : 1 + h, 1 : 1 + w]


# plain versions: the CPU path of the wrappers, and on the card the
# oracle each kernel is held against (chip_smoke.py)


def luma_plain(res, steps, src, counts, pcm=None, *, h: int, w: int,
               strong_smoothing: bool, bd: int) -> torch.Tensor:
    """Plain PyTorch luma walk on any device; same contract as
    intra_scan_luma."""
    plane = _plane(res.shape[0], h, w, res.device)
    R.intra_scan_component(
        plane, res, pcm, steps, src, counts, is_luma=True,
        strong_smoothing=strong_smoothing, bd=bd, tables=tables_on(res.device),
    )
    return plane[:, 1 : 1 + h, 1 : 1 + w]


def chroma2_plain(res_cb, res_cr, steps, src, counts, pcm_cb=None,
                  pcm_cr=None, *, h: int, w: int, bd: int):
    """Plain PyTorch Cb + Cr walk on any device: both planes run as one
    batch of 2N chains. Same contract as intra_scan_chroma2."""
    n = res_cb.shape[0]
    pcm = None
    if pcm_cb is not None or pcm_cr is not None:
        pcm = torch.cat([
            torch.zeros_like(res_cb) if pcm_cb is None else pcm_cb,
            torch.zeros_like(res_cr) if pcm_cr is None else pcm_cr,
        ])
    both = _plane(2 * n, h, w, res_cb.device)
    R.intra_scan_component(
        both, torch.cat([res_cb, res_cr]), pcm, steps.repeat(2, 1, 1),
        src.repeat(2, 1, 1, 1), counts.repeat(2), is_luma=False,
        strong_smoothing=False, bd=bd, tables=tables_on(res_cb.device),
    )
    both = both[:, 1 : 1 + h, 1 : 1 + w]
    return both[:n], both[n:]
