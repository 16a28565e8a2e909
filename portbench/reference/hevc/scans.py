"""Coefficient scan orders (H.265 §6.5.2-6.5.4), shared by entropy decode
and reconstruction kernels.

scanIdx: 0 = up-right diagonal, 1 = horizontal, 2 = vertical.
All tables are returned as numpy arrays of (x, y) pairs, cached per size.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def scan_order(blk_size: int, scan_idx: int) -> np.ndarray:
    """Array [blk_size*blk_size, 2] of (x, y) positions in scan order."""
    if scan_idx == 0:
        out = []
        x = y = 0
        while True:
            while y >= 0:
                if x < blk_size and y < blk_size:
                    out.append((x, y))
                y -= 1
                x += 1
            y = x
            x = 0
            if len(out) >= blk_size * blk_size:
                break
        return np.asarray(out, dtype=np.int32)
    if scan_idx == 1:  # horizontal: row by row
        return np.asarray(
            [(x, y) for y in range(blk_size) for x in range(blk_size)],
            dtype=np.int32,
        )
    if scan_idx == 2:  # vertical: column by column
        return np.asarray(
            [(x, y) for x in range(blk_size) for y in range(blk_size)],
            dtype=np.int32,
        )
    raise ValueError(f"bad scanIdx {scan_idx}")


@lru_cache(maxsize=None)
def scan_pos_of(blk_size: int, scan_idx: int) -> np.ndarray:
    """Inverse map: [y, x] -> scan index."""
    order = scan_order(blk_size, scan_idx)
    inv = np.zeros((blk_size, blk_size), dtype=np.int32)
    for i, (x, y) in enumerate(order):
        inv[y, x] = i
    return inv


def intra_scan_idx(log2_trafo_size: int, pred_mode: int, c_idx: int,
                   chroma_array_type: int = 1) -> int:
    """scanIdx selection for intra blocks (§7.4.9.11).

    Mode-dependent scans apply to 4x4 and luma 8x8 (and chroma 8x8 when
    ChromaArrayType==3); otherwise diagonal.
    """
    if log2_trafo_size == 2 or (
        log2_trafo_size == 3 and (c_idx == 0 or chroma_array_type == 3)
    ):
        if 6 <= pred_mode <= 14:
            return 2  # near-horizontal modes -> vertical scan
        if 22 <= pred_mode <= 30:
            return 1  # near-vertical modes -> horizontal scan
    return 0
