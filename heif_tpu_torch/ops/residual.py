"""The residual stage of `batch.core`: every transform class of N tiles
dequantised, inverse-transformed and placed in residual planes.

`residual_planes` is stage 1 of heif_tpu.ops.batch._core (its lines
469-501: jax_recon.residual_class per (component, size) class, then a
row-scatter of whole blocks). No Pallas kernel stands behind it there:
XLA fuses its jnp code. On CUDA tensors the wrapper launches the kernel
of csrc/residual.cu (built on first use by ops._build) once for all
classes, on the current stream, into planes zero-filled by one fill, and
raises if the launch fails. The kernel carries HEVC's transform and
level-scale tables itself (tests/test_torch_residual_stage.py holds them
against tables.ReconTables). On CPU tensors it runs `residual_plain`:
recon.residual_class composed with recon.scatter_classes, which is also
the kernel's oracle on the card. There is no fallback from one to the
other. LAUNCHES counts kernel launches only.

`d` is what batch.plan_to_device ships: d["classes"], a list of (comp,
size, coeffs [k, s, s] int16, qp [k] int32, dst, skip, bypass [k] bool,
org [k] int32) where org is the flat index of the TU's top-left sample in
the [N, h+PAD, w+PAD] planes of its component (negative for cap-padding
rows), d["scaling"][(size, comp)] the [s, s] int32 scaling factors, and
d["steps"] (its device names the planes' device). `bp` is any object with
a BatchPlan's n, height, width, bit_depth_y and bit_depth_c.
"""

from __future__ import annotations

import ctypes

import torch

from heif_tpu_torch.ops import recon as R
from heif_tpu_torch.ops.intra import _check
from heif_tpu_torch.tables import tables_on

LAUNCHES = {"residual": 0}
MAX_CLASSES = 12  # csrc/residual.cu: descriptors a launch takes
SIZES = (4, 8, 16, 32)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class ResClass(ctypes.Structure):
    """One class descriptor, laid out as csrc/residual.cu's ResClass."""
    _fields_ = [(name, ctypes.c_void_p) for name in
                ("coeffs", "qp", "dst", "skip", "bypass", "org", "scaling",
                 "plane")] + [(name, ctypes.c_int) for name in
                              ("k", "size", "bd", "pitch")]


def plane_dims(bp) -> list:
    """(h, w) of the Y, Cb and Cr planes (4:2:0)."""
    H, W = bp.height, bp.width
    return [(H, W), (H // 2, W // 2), (H // 2, W // 2)]


def bit_depth(bp, comp: int) -> int:
    return bp.bit_depth_y if comp == 0 else bp.bit_depth_c


def _check_args(d, bp) -> torch.device:
    if bp.height <= 0 or bp.width <= 0 or bp.height % 2 or bp.width % 2:
        raise ValueError(f"planes of {bp.height}x{bp.width}: height and "
                         "width must be positive and even")
    for name, bd in (("bit_depth_y", bp.bit_depth_y),
                     ("bit_depth_c", bp.bit_depth_c)):
        if not 8 <= bd <= 16:
            raise ValueError(f"{name} {bd}: 8 to 16 bits")
    dev = d["steps"][0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    classes = d["classes"]
    if len(classes) > MAX_CLASSES:
        raise ValueError(f"{len(classes)} classes, at most {MAX_CLASSES}")
    for comp, size, coeffs, qp, dst, skip, byp, org in classes:
        if comp not in (0, 1, 2) or size not in SIZES:
            raise ValueError(f"class {(comp, size)}: components 0-2, sizes "
                             f"{SIZES}")
        k = coeffs.shape[0]
        name = f"class {(comp, size)}"
        _check(f"{name} coeffs", coeffs, torch.int16, (k, size, size), dev)
        _check(f"{name} qp", qp, torch.int32, (k,), dev)
        for field, t in (("dst", dst), ("skip", skip), ("bypass", byp)):
            _check(f"{name} {field}", t, torch.bool, (k,), dev)
        _check(f"{name} org", org, torch.int32, (k,), dev)
        _check(f"{name} scaling", d["scaling"][(size, comp)], torch.int32,
               (size, size), dev)
    return dev


def residual_planes(d: dict, bp) -> list:
    """Stage 1 of `core`: [Y, Cb, Cr] int32 residual planes [N, h+PAD,
    w+PAD], zero where no TU lies (the padding included)."""
    dev = _check_args(d, bp)
    if dev.type == "cpu":
        return residual_plain(d, bp)
    from heif_tpu_torch.ops import _build

    dims = plane_dims(bp)
    sizes = [bp.n * (h + R.PAD) * (w + R.PAD) for h, w in dims]
    flat = torch.zeros(sum(sizes), dtype=torch.int32, device=dev)
    planes = [p.view(bp.n, h + R.PAD, w + R.PAD)
              for p, (h, w) in zip(flat.split(sizes), dims)]
    classes = d["classes"]
    if not classes:  # nothing coded: no launch
        return planes
    descs = (ResClass * len(classes))()
    for i, (comp, size, coeffs, qp, dst, skip, byp, org) in enumerate(classes):
        descs[i] = ResClass(
            coeffs.data_ptr(), qp.data_ptr(), dst.data_ptr(), skip.data_ptr(),
            byp.data_ptr(), org.data_ptr(),
            d["scaling"][(size, comp)].data_ptr(), planes[comp].data_ptr(),
            coeffs.shape[0], size, bit_depth(bp, comp), dims[comp][1] + R.PAD)
    rc = _build.load().heif_residual(
        ctypes.addressof(descs), len(classes),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"heif_residual launch failed: "
                           f"{'bad descriptor' if rc == -1 else 'CUDA error'}"
                           f" {rc}")
    LAUNCHES["residual"] += 1
    return planes


# the plain version: the CPU path of the wrapper, and on the card the
# oracle the kernel is held against (chip_smoke.py)


def residual_plain(d: dict, bp) -> list:
    """Plain PyTorch stage 1 on any device; same contract as
    residual_planes: recon.residual_class per class (two exact float64
    batched matmuls), then recon.scatter_classes."""
    dev = d["steps"][0].device
    tables = tables_on(dev)
    out = []
    for comp, size, coeffs, qp, dst, skip, byp, org in d["classes"]:
        r = R.residual_class(coeffs, qp, dst, skip, byp,
                             d["scaling"][(size, comp)], size,
                             bit_depth(bp, comp), tables)
        out.append((comp, size, r, org))
    return R.scatter_classes(out, bp.n, plane_dims(bp), dev)


def residual_bytes(d: dict, bp) -> int:
    """The bytes stage 1 of this plan must move (its time bound at the
    card's memory rate): each real TU's levels (int16) and its qp and
    three flags read once, every row's origin, each class's scaling
    matrix, and the three planes written once. Reads the origins back
    from the device."""
    n_bytes = sum(bp.n * (h + R.PAD) * (w + R.PAD) * 4
                  for h, w in plane_dims(bp))
    for comp, size, coeffs, qp, dst, skip, byp, org in d["classes"]:
        k_real = int((org >= 0).sum())
        n_bytes += (k_real * (size * size * 2 + 4 + 3) + org.numel() * 4
                    + size * size * 4)
    return n_bytes


# Multiply-adds of one 1-D inverse transform of s points in the partial
# butterfly form (odd half s/2 * s/2, then the even half recursively);
# DST-4's fast form takes 8 as DCT-4 does.
_BUTTERFLY_MACS = {4: 8, 8: 8 + 16, 16: 24 + 64, 32: 88 + 256}


def residual_macs(d: dict, bp) -> int:
    """The multiply-adds the two transform stages need, 2 * s 1-D passes
    of _BUTTERFLY_MACS[s] each, of every real TU that is neither
    transform-skipped nor bypassed: this plan's data, not the worst case
    (its time bound at the card's integer rate)."""
    return sum(2 * size * _BUTTERFLY_MACS[size]
               * int(((org >= 0) & ~skip & ~byp).sum())
               for comp, size, coeffs, qp, dst, skip, byp, org
               in d["classes"])
