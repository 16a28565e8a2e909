"""Seeded random inputs for the loop filters' contracts.

The deblocking and SAO kernels (csrc/loopfilter.cu) must equal their
plain PyTorch versions (ops.loopfilter.deblock_plain, sao_plain) on any
plan, not only on the flagship's. These inputs reach the corners that a
decoded stream rarely does, in the layouts batch.plan_to_device ships:

- planes of 8x8 patches, half of them flat, plus noise, so that every
  deblocking decision (off, weak with and without p1/q1, strong) and
  every SAO edge category occurs; bit depths 8 and 10 (one case mixes
  them); non-square pictures, three with chroma planes that are not a
  multiple of 8 on either axis (36x20, 20x68 and 12x8: the last chroma
  edge, at 8 * floor(size / 8), has only 4 samples on its q side) and
  one, 12x8, with no vertical chroma edge at all;
- CTB 16, 32 and 64, most with a partial last CTB row or column, one
  picture lower than its CTB;
- edge maps with every 4x4 position set or clear at random (the filters
  read only the 8-sample grid), whole edge columns and rows forced on or
  off; QpY values spread over the range and heaped at its ends
  (-QpBdOffset, 0, 15-18, 50, 51), so beta, tc and the chroma QP table
  are read at both clamps with offsets of up to +-12 (beta, tc and each
  chroma QP offset); islands of bypass blocks (nf_map: PCM with the
  loop filter off, or transquant bypass) and single ones;
- per CTB and component every SAO type (0, band, edge, and two types
  that mean nothing, which must leave the samples alone), band positions
  heaped at 28-31 (the four bands wrap past 31), edge classes 0-3 with
  the spec's offset signs; the four corner CTBs of the first tile take
  edge classes 0-3, so every class meets the picture's edges;
- stages switched off: deblocking, SAO on luma, SAO on chroma, both;
- for the kernels' regions (csrc/loopfilter.cu: a block owns 32 x 64
  luma samples and the chroma under them, with a halo): pictures larger
  than a region on both sides and not a multiple of it (136x200), a
  10-bit CTB-64 picture with chroma QP offsets and chroma sides of 4 mod
  8 (72x136), and flat 8x8 patches on both sides of every region border
  (`flat_borders`), so that the strong luma filter falls on the regions'
  edges.

Numpy only; the same case gives the same arrays everywhere
(tests/test_torch_loopfilter_stage.py holds the plain versions against
heif_tpu's JAX stage on them, and the chroma of the cases with a partial
last chroma edge, which that stage skips, against ops.ref_recon; the card
tests and chip_smoke.py hold the kernels against the plain versions).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Case:
    """One seeded plan. Its fields carry a BatchPlan's names, so a Case
    is the `bp` argument of the loop filters."""
    seed: int
    n: int
    height: int
    width: int
    ctb_log2: int
    bit_depth_y: int = 8
    bit_depth_c: int = 8
    beta_off: int = 0
    tc_off: int = 0
    cb_qp_off: int = 0
    cr_qp_off: int = 0
    deblock_disabled: bool = False
    sao_luma: bool = True
    sao_chroma: bool = True
    flat_borders: tuple = ()  # luma (rows, columns): flat patches beside
    # every multiple of them (chroma: half of each)


CASES = (
    Case(1, 2, 48, 80, 4),                          # CTB 16, whole CTBs
    Case(2, 2, 72, 40, 5, 10, 10, 6, -4, -12, 12),  # CTB 32, partial, tall;
    # chroma 36x20: edge rows 8-32, edge columns 8 and 16, both last partial
    Case(3, 1, 40, 136, 6, 10, 10, -12, 12, 12, -12),  # CTB 64, wide
    Case(4, 3, 64, 64, 4, 8, 8, 12, 12, 5, -7),
    Case(5, 2, 56, 48, 5, 10, 10, -6, 6, deblock_disabled=True,
         sao_chroma=False),                         # SAO on luma only
    Case(6, 2, 32, 96, 6, 8, 8, 4, -12, sao_luma=False),  # lower than a CTB
    Case(7, 1, 48, 48, 5, 8, 10, -2, 2, 3, 3, sao_luma=False,
         sao_chroma=False),                         # SAO off
    Case(8, 2, 24, 16, 4, 10, 10, 2, 4, -1, 1),     # chroma 12x8: one
    # edge row (8, partial), no edge column
    Case(9, 2, 136, 200, 5),                        # past a region both
    # ways, not a multiple of it; chroma 68x100: both last edges partial
    Case(10, 1, 72, 136, 6, 10, 10, 3, -2, 7, -5),  # CTB 64; chroma 36x68
    Case(11, 2, 96, 192, 5, 8, 8, 6, 6, flat_borders=(32, 64)),
)

_QP_ENDS = (0, 15, 16, 17, 18, 50, 51)


def _planes(rng, n: int, h: int, w: int, bd: int) -> np.ndarray:
    """Blocky [n, h, w] int32 planes: 8x8 patches, half of them flat."""
    base = rng.integers(0, 1 << bd, (n, h // 8 + 1, w // 8 + 1))
    p = np.repeat(np.repeat(base, 8, 1), 8, 2)[:, :h, :w]
    p = p + rng.integers(-3, 4, (n, h, w)) * (1 << (bd - 8))
    flat = rng.random((n, h // 8 + 1, w // 8 + 1)) < 0.5
    mask = np.repeat(np.repeat(flat, 8, 1), 8, 2)[:, :h, :w]
    p = np.where(mask, (1 << (bd - 1)) + (p & 7), p)
    return np.clip(p, 0, (1 << bd) - 1).astype(np.int32)


def _flatten_borders(rng, p: np.ndarray, rows: int, cols: int,
                     bd: int) -> None:
    """Make every 8x8 patch of `p` [n, h, w] that touches a multiple of
    `rows` (from above or below) or of `cols` (from the left or right)
    flat: one level a patch, mid-grey plus a step of up to 2 (in 8-bit
    units), so that the edges between them take the strong luma filter
    wherever the QP allows it."""
    n, h, w = p.shape
    ph, pw = h // 8, w // 8
    ys = np.arange(ph) * 8
    xs = np.arange(pw) * 8
    beside_r = (ys % rows == 0) | ((ys + 8) % rows == 0)
    beside_c = (xs % cols == 0) | ((xs + 8) % cols == 0)
    flat = beside_r[:, None] | beside_c[None, :]
    level = (1 << (bd - 1)) + rng.integers(-2, 3, (n, ph, pw)) * (1 << (bd - 8))
    patches = np.repeat(np.repeat(level, 8, 1), 8, 2)
    mask = np.repeat(np.repeat(flat, 8, 0), 8, 1)
    p[:, mask] = patches[:, mask]


def _edges(rng, shape) -> np.ndarray:
    e = rng.random(shape) < 0.75
    e[:, :, rng.integers(0, shape[2])] = True
    e[:, rng.integers(0, shape[1]), :] = False
    return e


def _bypass(rng, shape) -> np.ndarray:
    nf = rng.random(shape) < 0.03
    n, h4, w4 = shape
    for t in range(n):
        for _ in range(2):
            y, x = rng.integers(0, h4), rng.integers(0, w4)
            dy, dx = rng.integers(1, 5), rng.integers(1, 5)
            nf[t, y : y + dy, x : x + dx] = True
    return nf


def _sao(rng, case: Case, rows: int, cols: int) -> np.ndarray:
    n = case.n
    out = np.zeros((n, rows, cols, 3, 6), np.int32)
    for c in range(3):
        bd = case.bit_depth_y if c == 0 else case.bit_depth_c
        mag = (1 << (min(bd, 10) - 5)) - 1
        shape = (n, rows, cols)
        stype = rng.choice([0, 1, 2, 3, -1], size=shape,
                           p=[0.2, 0.3, 0.3, 0.1, 0.1])
        band = np.where(rng.random(shape) < 0.5, rng.integers(28, 32, shape),
                        rng.integers(0, 32, shape))
        eo = rng.integers(0, 4, shape)
        sclass = np.where(stype == 1, band, np.where(stype == 2, eo, 0))
        offs = rng.integers(-mag, mag + 1, (*shape, 4))
        # edge offsets carry the spec's signs: two >= 0, two <= 0
        eoffs = np.abs(offs) * np.array([1, 1, -1, -1])
        offs = np.where((stype == 2)[..., None], eoffs, offs)
        # the first tile's four corner CTBs: edge classes 0-3
        for k, (y, x) in enumerate(((0, 0), (0, cols - 1), (rows - 1, 0),
                                    (rows - 1, cols - 1))):
            stype[0, y, x], sclass[0, y, x] = 2, (k + c) % 4
        out[..., c, 0] = stype
        out[..., c, 1] = sclass
        out[..., c, 2:] = offs
    return out


def inputs(case: Case) -> tuple:
    """([Y, Cb, Cr] int32 planes, the plan's loop-filter maps as
    plan_to_device ships them: vert_edges, horiz_edges, nf_map bool and
    qp_map int32 [n, H/4, W/4], sao int32 [n, R, C, 3, 6])."""
    rng = np.random.default_rng(case.seed)
    n, H, W = case.n, case.height, case.width
    planes = [_planes(rng, n, H, W, case.bit_depth_y),
              _planes(rng, n, H // 2, W // 2, case.bit_depth_c),
              _planes(rng, n, H // 2, W // 2, case.bit_depth_c)]
    if case.flat_borders:
        rows, cols = case.flat_borders
        for p, sub, bd in ((planes[0], 1, case.bit_depth_y),
                           (planes[1], 2, case.bit_depth_c),
                           (planes[2], 2, case.bit_depth_c)):
            _flatten_borders(rng, p, rows // sub, cols // sub, bd)
    m = (n, H // 4, W // 4)
    lo = -6 * (case.bit_depth_y - 8)
    qp = rng.integers(lo, 52, m)
    ends = rng.choice(np.array((lo, lo + 1) + _QP_ENDS), size=m)
    qp = np.where(rng.random(m) < 0.4, ends, qp).astype(np.int32)
    cs = 1 << case.ctb_log2
    rows, cols = -(-H // cs), -(-W // cs)
    maps = {
        "vert_edges": _edges(rng, m),
        "horiz_edges": _edges(rng, m),
        "qp_map": qp,
        "nf_map": _bypass(rng, m),
        "sao": _sao(rng, case, rows, cols),
    }
    return planes, maps


def tensors(case: Case, device) -> tuple:
    """inputs(case) as torch tensors on `device`: ([Y, Cb, Cr], d)."""
    import torch

    planes, maps = inputs(case)
    return ([torch.from_numpy(p).to(device) for p in planes],
            {k: torch.from_numpy(v).to(device) for k, v in maps.items()})
