"""Numeric constant tables for HEVC reconstruction (H.265 §8.4-8.7).

The port's copy of heif_tpu/ops/tables.py (logic unchanged), used by
the numpy reference reconstruction (ops/ref_recon.py), the device tables
(heif_tpu_torch/tables.py) and the packer. It takes another name because
heif_tpu_torch/tables.py already holds the device tables. Everything here
is a spec constant.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

# --------------------------------------------------------------------------
# Inverse transform matrices (§8.6.4.2)
# --------------------------------------------------------------------------

# Odd-row coefficient sets of the integer DCT matrices (values for basis
# rows with odd index; even rows recurse to the half-size matrix).
_ODD_COEFS = {
    4: [83, 36],
    8: [89, 75, 50, 18],
    16: [90, 87, 80, 70, 57, 43, 25, 9],
    32: [90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4],
}

DST4 = np.array(
    [
        [29, 55, 74, 84],
        [74, 74, 0, -74],
        [84, -29, -74, 55],
        [55, -84, 74, -29],
    ],
    dtype=np.int32,
)


@lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """HEVC integer DCT basis matrix T[n][n]; row k = k-th basis vector.

    Even rows are the half-size matrix's rows (mirrored with sign
    (-1)^row); odd rows are signed permutations of the odd coefficient set,
    following cos((2n+1)k*pi/2N) sign/magnitude structure.
    """
    if n == 1:
        return np.array([[64]], dtype=np.int32)
    t = np.zeros((n, n), dtype=np.int32)
    half = dct_matrix(n // 2) if n > 4 else None
    if n == 4:
        return np.array(
            [
                [64, 64, 64, 64],
                [83, 36, -36, -83],
                [64, -64, -64, 64],
                [36, -83, 83, -36],
            ],
            dtype=np.int32,
        )
    odd = _ODD_COEFS[n]
    for k in range(n):
        if k % 2 == 0:
            # even basis rows: half-size row, mirrored symmetrically
            # (T[k][N-1-c] = (-1)^k T[k][c]; k even -> +)
            for col in range(n // 2):
                v = half[k // 2][col]
                t[k][col] = v
                t[k][n - 1 - col] = v
        else:
            for col in range(n):
                a = ((2 * col + 1) * k) % (4 * n)
                if a < n:
                    sign, mag = 1, a
                elif a <= 2 * n:
                    sign, mag = -1, 2 * n - a
                elif a < 3 * n:
                    sign, mag = -1, a - 2 * n
                else:
                    sign, mag = 1, 4 * n - a
                # mag is odd: odd coefficient index (mag-1)//2
                t[k][col] = sign * odd[(mag - 1) // 2]
    return t


# --------------------------------------------------------------------------
# Dequantization (§8.6.3)
# --------------------------------------------------------------------------

LEVEL_SCALE = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)


def scaling_factor_matrix(
    size: int, matrix_id: int, scaling_lists
) -> np.ndarray:
    """ScalingFactor[size][size] for one matrixId (§8.6.3).

    scaling_lists: grammar.ScalingListData or None (-> flat 16s).
    """
    if scaling_lists is None:
        return np.full((size, size), 16, dtype=np.int32)
    from portbench.reference.hevc.params import diag_scan_order

    m = np.zeros((size, size), dtype=np.int32)
    if size == 4:
        lst = scaling_lists.scaling_list[0][matrix_id]
        for i, (x, y) in enumerate(diag_scan_order(4)):
            m[y, x] = lst[i]
    elif size == 8:
        lst = scaling_lists.scaling_list[1][matrix_id]
        for i, (x, y) in enumerate(diag_scan_order(8)):
            m[y, x] = lst[i]
    elif size == 16:
        lst = scaling_lists.scaling_list[2][matrix_id]
        base = np.zeros((8, 8), dtype=np.int32)
        for i, (x, y) in enumerate(diag_scan_order(8)):
            base[y, x] = lst[i]
        m = np.repeat(np.repeat(base, 2, axis=0), 2, axis=1)
        m[0, 0] = scaling_lists.dc[0][matrix_id]
    elif size == 32:
        lst = scaling_lists.scaling_list[3][matrix_id]
        base = np.zeros((8, 8), dtype=np.int32)
        for i, (x, y) in enumerate(diag_scan_order(8)):
            base[y, x] = lst[i]
        m = np.repeat(np.repeat(base, 4, axis=0), 4, axis=1)
        m[0, 0] = scaling_lists.dc[1][matrix_id]
    else:
        raise ValueError(size)
    return m


# --------------------------------------------------------------------------
# Intra prediction (§8.4.4.2.6)
# --------------------------------------------------------------------------

# intraPredAngle for modes 2..34
INTRA_PRED_ANGLE = np.array(
    [32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
     -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32],
    dtype=np.int32,
)

# invAngle for negative angles -2..-32 (indexed by |angle| position)
_INV_ANGLE = {-2: -4096, -5: -1638, -9: -910, -13: -630, -17: -482,
              -21: -390, -26: -315, -32: -256}


def intra_angle(mode: int) -> int:
    return int(INTRA_PRED_ANGLE[mode - 2])


def inv_angle(angle: int) -> int:
    return _INV_ANGLE[angle]


# reference-filter distance thresholds per nTbS (§8.4.4.2.3)
INTRA_FILTER_THRES = {8: 7, 16: 1, 32: 0}


# --------------------------------------------------------------------------
# Deblocking (§8.7.2, Tables 8-12)
# --------------------------------------------------------------------------

BETA_TABLE = np.array(
    [0] * 16
    + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28,
       30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62,
       64],
    dtype=np.int32,
)  # Q' 0..51

TC_TABLE = np.array(
    [0] * 18
    + [1] * 9        # Q 18..26
    + [2] * 4        # Q 27..30
    + [3] * 4        # Q 31..34
    + [4] * 3        # Q 35..37
    + [5, 5, 6, 6]   # Q 38..41
    + [7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24],  # Q 42..53
    dtype=np.int32,
)  # Q' 0..53
