"""Seeded random worklists for the reference-source stage's contract.

The source-table kernel (csrc/refsrc.cu) must equal its plain PyTorch
version (ops.recon.ref_sources) on any worklist, not only on a decoded
one. These worklists reach what a decode rarely does, in the layout
batch.plan_to_device ships (d["steps"][c]: [N, S, 6] int32, fields x, y,
size first):

- TUs of every size at random size-aligned places, the picture's edges
  and corners included (left and top neighbours outside it; below-left
  and above-right runs past its bottom and right edge), in no decode
  order, so every availability pattern of z-order occurs;
- padding steps (size 0) with garbage positions, which must give 255;
- CTB 16, 32 and 64; luma and chroma (positions scaled by 2 before the
  tests); pictures that are not a multiple of the CTB size;
- no HEVC tiles, a few, and the most HEVC allows (19 interior tile
  columns, 21 rows: a tile a CTB).

Numpy only; the same case gives the same worklist everywhere
(tests/test_torch_refsrc.py holds the plain version against heif_tpu's
jax_recon.ref_sources_device and a transcription of the kernel on them,
the card tests and chip_smoke.py the kernel against the plain version).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Case:
    """One seeded worklist of comp (0 luma, 1 chroma) in a width x height
    luma picture with CTBs of 1 << ctb_log2 luma samples."""
    seed: int
    n: int
    steps: int
    height: int
    width: int
    ctb_log2: int
    comp: int = 0
    tile_col_bd: tuple = ()
    tile_row_bd: tuple = ()


CASES = (
    Case(1, 2, 300, 64, 96, 4),
    Case(2, 2, 300, 72, 40, 5, comp=1),  # chroma 36x20
    Case(3, 1, 400, 128, 192, 6, tile_col_bd=(64,), tile_row_bd=(64,)),
    Case(4, 2, 400, 96, 160, 5, comp=1, tile_col_bd=(32, 96),
         tile_row_bd=(64,)),
    # a tile a CTB: 19 interior columns and 21 rows
    Case(5, 1, 1200, 352, 320, 4, tile_col_bd=tuple(range(16, 320, 16)),
         tile_row_bd=tuple(range(16, 352, 16))),
    Case(6, 1, 600, 352, 320, 4, comp=1,
         tile_col_bd=tuple(range(16, 320, 16)),
         tile_row_bd=tuple(range(16, 352, 16))),
)


def inputs(case: Case) -> np.ndarray:
    """[n, S, 6] int32 steps: x, y, size, then three fields the stage does
    not read (random)."""
    rng = np.random.default_rng(case.seed)
    sub = 1 if case.comp == 0 else 2
    h, w = case.height // sub, case.width // sub
    shape = (case.n, case.steps)
    size = rng.choice(np.array([4, 8, 16, 32]), shape)
    size = np.minimum(size, 16 if case.comp else 32)
    # positions aligned to the size, inside the plane
    y = rng.integers(0, 1 << 30, shape) % np.maximum(h // size, 1) * size
    x = rng.integers(0, 1 << 30, shape) % np.maximum(w // size, 1) * size
    # a quarter of the steps on an edge or corner of the plane
    edge = rng.random(shape)
    x = np.where(edge < 0.08, 0, np.where(edge < 0.16, (w - size) // size
                                          * size, x))
    y = np.where((edge > 0.12) & (edge < 0.25),
                 np.where(edge < 0.19, 0, (h - size) // size * size), y)
    pad = rng.random(shape) < 0.1
    size = np.where(pad, 0, size)
    x = np.where(pad, rng.integers(-64, 4 * w, shape), x)
    y = np.where(pad, rng.integers(-64, 4 * h, shape), y)
    rest = rng.integers(-5, 40, (*shape, 3))
    return np.concatenate([np.stack([x, y, size], -1), rest],
                          -1).astype(np.int32)
