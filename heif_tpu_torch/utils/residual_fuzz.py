"""Seeded random class sets for the residual stage's contract.

The residual kernel (csrc/residual.cu) must equal its plain PyTorch
version (ops.residual.residual_plain) on any plan, not only on the
flagship's. These inputs reach the corners that a decoded stream rarely
does, in the layout batch.plan_to_device ships (d["classes"],
d["scaling"]):

- every (component, size) class of batch.CLASSES, laid out as the HEVC
  quadtree lays TUs out: each 32x32 luma (16x16 chroma) region of a tile
  cut into blocks of one size, most of them coded, none crossing the
  plane's edge; planes that are not a multiple of 32 (72x40: chroma
  36x20) and several tiles a batch;
- DST-4 set and clear on 4x4 rows of every component, transform skip and
  transquant bypass (which wins over skip) on any size;
- cap-padding rows (origin -1) with nonzero levels, qp 63 and every flag
  set, which must change nothing, and one class of padding rows only;
- flat (None), default and random scaling lists;
- bit depths 8, 10 and 12, one case with luma and chroma apart;
- qp 0 to 63, heaped at 0, 51 and 63, and levels spread over +-3000 with
  most of them 0, or heaped at the int16 ends: at qp 51 and above a 4x4
  block's dequant product shifted left wraps past 2^31, as int32 does in
  the plain version and in heif_tpu;
- levels only in a top-left corner of each TU (its first 1, S/4, S/2 or
  S rows and columns, drawn apart), as a coarse quantiser leaves them:
  the trailing zero rows and columns that the kernel skips.

Numpy only; the same case gives the same arrays everywhere
(tests/test_torch_residual_stage.py holds the plain version against
heif_tpu's `_core` stage 1 on them, the card tests and chip_smoke.py the
kernel against the plain version).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PAD = 32  # ops.recon.PAD: residual-plane padding on bottom and right
CLASSES = [
    (0, 4), (0, 8), (0, 16), (0, 32),
    (1, 4), (1, 8), (1, 16),
    (2, 4), (2, 8), (2, 16),
]


@dataclass(frozen=True)
class Case:
    """One seeded class set. Its fields carry a BatchPlan's names, so a
    Case is the `bp` argument of the residual stage."""
    seed: int
    n: int
    height: int
    width: int
    bit_depth_y: int = 8
    bit_depth_c: int = 8
    lists: str = "flat"  # scaling lists: "flat", "default" or "random"
    pad_rows: int = 0  # cap-padding rows appended to every class
    saturate: bool = False  # levels heaped at the int16 ends
    empty: tuple = ()  # classes of padding rows only
    corner: bool = False  # levels only in a top-left corner of each TU


CASES = (
    Case(1, 2, 64, 64, 8, 8, "flat", 3),
    Case(2, 2, 96, 64, 10, 10, "default"),
    Case(3, 1, 128, 96, 12, 12, "random", 5, empty=((2, 16),)),
    Case(4, 3, 72, 40, 8, 10, "random", 2, True),  # not a multiple of 32
    Case(5, 2, 64, 128, 12, 8, "default", 0, True),
    Case(6, 2, 64, 64, 8, 8, "random", 1, empty=((0, 32), (1, 4))),
    Case(7, 2, 64, 96, 10, 10, "default", 2, corner=True),
    Case(8, 2, 128, 128, 8, 8, "flat", 1, True, corner=True),
)


def scaling(case: Case, rng) -> dict:
    """{(size, comp): [size, size] int32} scaling factors of the intra
    matrices (matrixId = comp), as batch._scaling_for_sps gives them."""
    from heif_tpu_torch.hevc.grammar import ScalingListData
    from heif_tpu_torch.ops.ref_tables import scaling_factor_matrix

    lists = None
    if case.lists == "default":
        lists = ScalingListData.default()
    elif case.lists == "random":
        lists = ScalingListData.default()
        lists.scaling_list = [
            [list(rng.integers(1, 256, len(m))) for m in per_size]
            for per_size in lists.scaling_list
        ]
        lists.dc = [list(rng.integers(1, 256, len(d))) for d in lists.dc]
    return {(size, comp): scaling_factor_matrix(size, comp, lists)
            for comp, size in CLASSES}


def _layout(rng, case: Case) -> dict:
    """{(comp, size): [(tile, y, x), ...]}: TU origins of every tile and
    component, each 32x32 luma (16x16 chroma) region cut into blocks of
    one size, 80% of them coded."""
    out = {k: [] for k in CLASSES}
    for comp in range(3):
        sub = 1 if comp == 0 else 2
        h, w = case.height // sub, case.width // sub
        sizes = [s for c, s in CLASSES if c == comp]
        reg = max(sizes)
        for t in range(case.n):
            for ry in range(0, h, reg):
                for rx in range(0, w, reg):
                    s = int(rng.choice(sizes))
                    for y in range(ry, min(ry + reg, h - s + 1), s):
                        for x in range(rx, min(rx + reg, w - s + 1), s):
                            if rng.random() < 0.8:
                                out[(comp, s)].append((t, y, x))
    return out


def _levels(rng, k: int, s: int, saturate: bool,
            corner: bool) -> np.ndarray:
    lv = rng.integers(-3000, 3001, (k, s, s))
    lv[rng.random((k, s, s)) < 0.6] = 0
    if saturate:
        ends = rng.choice(np.array([-32768, 32767]), (k, s, s))
        full = rng.integers(-32768, 32768, (k, s, s))
        pick = rng.random((k, s, s))
        lv = np.where(pick < 0.5, ends, np.where(pick < 0.7, full, lv))
    if corner:
        ends = np.array([1, max(s // 4, 1), s // 2, s])
        rows = rng.choice(ends, k)[:, None, None]
        cols = rng.choice(ends, k)[:, None, None]
        i = np.arange(s)
        lv = np.where((i[:, None] < rows) & (i[None] < cols), lv, 0)
    return lv.astype(np.int16)


def inputs(case: Case) -> tuple:
    """(classes, scaling): classes a list of (comp, size, coeffs [k, s, s]
    int16, qp [k] int32, dst, skip, bypass [k] bool, org [k] int32) in
    CLASSES order, rows shuffled; scaling as `scaling`."""
    rng = np.random.default_rng(case.seed)
    sc = scaling(case, rng)
    layout = _layout(rng, case)
    classes = []
    for comp, size in CLASSES:
        sub = 1 if comp == 0 else 2
        h, w = case.height // sub, case.width // sub
        stride = (h + PAD) * (w + PAD)
        tus = [] if (comp, size) in case.empty else layout[(comp, size)]
        k = len(tus)
        kp = case.pad_rows + ((comp, size) in case.empty)
        org = np.full(k + kp, -1, np.int32)
        for i, (t, y, x) in enumerate(tus):
            org[i] = t * stride + y * (w + PAD) + x
        coeffs = _levels(rng, k + kp, size, case.saturate, case.corner)
        qp = rng.integers(0, 64, k + kp)
        qp = np.where(rng.random(k + kp) < 0.3,
                      rng.choice(np.array([0, 51, 63]), k + kp), qp)
        dst = np.full(k + kp, comp == 0 and size == 4)
        if size == 4:
            dst ^= rng.random(k + kp) < 0.3
        skip = rng.random(k + kp) < 0.2
        byp = rng.random(k + kp) < 0.1
        # padding rows: garbage that must change nothing
        qp[k:] = 63
        skip[k:] = byp[k:] = True
        order = rng.permutation(k + kp)
        classes.append((comp, size, coeffs[order], qp[order].astype(np.int32),
                        dst[order], skip[order], byp[order], org[order]))
    return classes, sc


def tensors(case: Case, device) -> dict:
    """inputs(case) as plan_to_device ships them on `device`: "classes",
    "scaling" and "steps" (three empty [n, 0, 6] int32 worklists, which
    name the device)."""
    import torch

    classes, sc = inputs(case)
    t = [(comp, size, *(torch.from_numpy(a).to(device) for a in arrays))
         for comp, size, *arrays in classes]
    return {
        "classes": t,
        "scaling": {k: torch.from_numpy(v).to(device) for k, v in sc.items()},
        "steps": [torch.zeros((case.n, 0, 6), dtype=torch.int32,
                              device=device) for _ in range(3)],
    }
