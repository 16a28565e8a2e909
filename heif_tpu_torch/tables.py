"""Spec constant tables as device buffers.

Counterpart of the module-level constants of heif_tpu/ops/jax_recon.py
(inverse-angle index, chroma QP LUT, BETA/TC, LEVEL_SCALE) and of
heif_tpu/ops/tables.py (DCT/DST matrices, intraPredAngle). A
ReconTables module carries them all as int32 buffers, so `.to(device)`
moves the whole set at once. CabacTables does the same for the CABAC
kernels' constants (heif_tpu/ops/pallas_cabac.py and pallas_cabac_gen.py).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from heif_tpu_torch.cabac.syntax import chroma_qp_from_luma
from heif_tpu_torch.ops import ref_tables as TB

MAX_S = 32  # largest transform / prediction block

# buffer name -> shape, in registration order
TABLE_SHAPES = {
    "dct4": (4, 4),
    "dct8": (8, 8),
    "dct16": (16, 16),
    "dct32": (32, 32),
    "dst4": (4, 4),
    "level_scale": (6,),
    "beta": (52,),
    "tc": (54,),
    "chroma_qp_lut": (58,),
    "intra_pred_angle": (33,),  # modes 2..34
    "inv_idx": (35, MAX_S),
}


def _inv_idx() -> np.ndarray:
    """inv_idx[mode, k]: index into the side reference array (0 = corner)
    that supplies ref[-1-k] of the inverse-angle extension (§8.4.4.2.6)."""
    out = np.zeros((35, MAX_S), np.int32)
    for mode in range(2, 35):
        angle = TB.intra_angle(mode)
        if angle < 0:
            ia = TB.inv_angle(angle)
            for k in range(MAX_S):
                x = -1 - k
                out[mode, k] = min(max((x * ia + 128) >> 8, 0), 2 * MAX_S)
    return out


def _spec_arrays() -> dict[str, np.ndarray]:
    return {
        "dct4": TB.dct_matrix(4),
        "dct8": TB.dct_matrix(8),
        "dct16": TB.dct_matrix(16),
        "dct32": TB.dct_matrix(32),
        "dst4": TB.DST4,
        "level_scale": TB.LEVEL_SCALE,
        "beta": TB.BETA_TABLE,
        "tc": TB.TC_TABLE,
        "chroma_qp_lut": np.asarray(
            [chroma_qp_from_luma(q, 0) for q in range(58)], np.int32
        ),
        "intra_pred_angle": TB.INTRA_PRED_ANGLE,
        "inv_idx": _inv_idx(),
    }


class ReconTables(nn.Module):
    """The constant tables of the reconstruction stages, as int32 buffers."""

    def __init__(self, arrays: dict[str, np.ndarray]):
        super().__init__()
        missing = set(TABLE_SHAPES) - set(arrays)
        if missing:
            raise ValueError(f"missing tables: {sorted(missing)}")
        for name, shape in TABLE_SHAPES.items():
            a = np.asarray(arrays[name])
            if a.shape != shape:
                raise ValueError(f"table {name}: shape {a.shape} != {shape}")
            self.register_buffer(
                name, torch.from_numpy(a.astype(np.int32, copy=True))
            )

    @classmethod
    def build(cls) -> "ReconTables":
        """Build every table from the spec constants in heif_tpu.ops.tables."""
        return cls(_spec_arrays())

    def dct(self, size: int) -> torch.Tensor:
        return getattr(self, f"dct{size}")


def tables_from_numpy(d: dict[str, np.ndarray]) -> ReconTables:
    """ReconTables from named numpy arrays (e.g. the JAX package's
    module constants), checked against TABLE_SHAPES."""
    return ReconTables(d)


_CACHE: dict[torch.device, ReconTables] = {}


def tables_on(device: torch.device) -> ReconTables:
    """The shared ReconTables instance on `device` (built once)."""
    device = torch.device(device)
    t = _CACHE.get(device)
    if t is None:
        t = ReconTables.build().to(device)
        _CACHE[device] = t
    return t


# --------------------------------------------------------------------------
# CABAC engine constants (counterparts of heif_tpu/ops/pallas_cabac.py
# _TBL / _tbl_device_packed and pallas_cabac_gen.py _SIG4_LO/HI,
# _sb_tables, _coef_tables)
# --------------------------------------------------------------------------

CABAC_SHAPES = {
    # p*4+q -> transIdxMps | transIdxLps<<8 | rangeTabLps<<16
    "tbl": (256,),
    # windowed engine: [p] rangeTabLps q0..q3 one byte each; [64+p]
    # transIdxMps | transIdxLps<<8
    "tbl_win": (128,),
    # subblock scans, index scan*256 + (log2-2)*64 + key
    "sb_fwd": (768,),  # key = subblock scan index -> xs | ys<<8
    "sb_inv": (768,),  # key = ys*8+xs -> scan index
    # 4x4 coefficient scans, index scan*16 + key
    "co_fwd": (48,),  # key = n -> xp | yp<<8
    "co_inv": (48,),  # key = yp*4+xp -> n
    # §9.3.4.2.5 4x4 sig ctxIdxMap, 4 bits per entry: entries 0-7, 8-15
    "sig4": (2,),
}

_SIG4_MAP = (0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8)


def _cabac_arrays() -> dict[str, np.ndarray]:
    from heif_tpu_torch.cabac import engine as E
    from heif_tpu_torch.hevc.scans import scan_order, scan_pos_of

    tbl = np.zeros(256, np.int64)
    win = np.zeros(128, np.int64)
    for p in range(64):
        for q in range(4):
            lps = int(E.RANGE_TAB_LPS[p * 4 + q])
            tbl[p * 4 + q] = (E.TRANS_IDX_MPS[p] | (E.TRANS_IDX_LPS[p] << 8)
                              | (lps << 16))
            win[p] |= lps << (8 * q)
        win[64 + p] = E.TRANS_IDX_MPS[p] | (E.TRANS_IDX_LPS[p] << 8)
    sb_fwd = np.zeros(768, np.int32)
    sb_inv = np.zeros(768, np.int32)
    co_fwd = np.zeros(48, np.int32)
    co_inv = np.zeros(48, np.int32)
    for scan in range(3):
        for lg in range(4):  # log2 size 2..5 -> 1, 2, 4, 8 subblocks a side
            sb = 1 << lg
            so, po = scan_order(sb, scan), scan_pos_of(sb, scan)
            base = scan * 256 + lg * 64
            for i in range(sb * sb):
                sb_fwd[base + i] = int(so[i, 0]) | (int(so[i, 1]) << 8)
            for sy in range(sb):
                for sx in range(sb):
                    sb_inv[base + sy * 8 + sx] = int(po[sy, sx])
        so, po = scan_order(4, scan), scan_pos_of(4, scan)
        for n in range(16):
            co_fwd[scan * 16 + n] = int(so[n, 0]) | (int(so[n, 1]) << 8)
        for yp in range(4):
            for xp in range(4):
                co_inv[scan * 16 + yp * 4 + xp] = int(po[yp, xp])
    sig4 = [sum(v << (4 * i) for i, v in enumerate(_SIG4_MAP[h : h + 8]))
            for h in (0, 8)]
    return {
        "tbl": tbl.astype(np.int32),
        "tbl_win": win.astype(np.uint32).view(np.int32),
        "sb_fwd": sb_fwd, "sb_inv": sb_inv,
        "co_fwd": co_fwd, "co_inv": co_inv,
        "sig4": np.asarray(sig4, np.uint32).view(np.int32),
    }


class CabacTables(nn.Module):
    """The CABAC kernels' constants as int32 buffers. The kernels have no
    weights: these tables and each lane's initial context state are all
    they are given besides the stream."""

    def __init__(self, arrays: dict[str, np.ndarray]):
        super().__init__()
        missing = set(CABAC_SHAPES) - set(arrays)
        if missing:
            raise ValueError(f"missing tables: {sorted(missing)}")
        for name, shape in CABAC_SHAPES.items():
            a = np.asarray(arrays[name])
            if a.shape != shape:
                raise ValueError(f"table {name}: shape {a.shape} != {shape}")
            self.register_buffer(
                name, torch.from_numpy(a.astype(np.int32, copy=True)))

    @classmethod
    def build(cls) -> "CabacTables":
        """Build every table from heif_tpu.cabac.engine and hevc.scans."""
        return cls(_cabac_arrays())

    @classmethod
    def from_numpy(cls, d: dict[str, np.ndarray]) -> "CabacTables":
        """CabacTables from named numpy arrays (e.g. the JAX modules'
        constants), checked against CABAC_SHAPES."""
        return cls(d)


_CABAC_CACHE: dict[torch.device, CabacTables] = {}


def cabac_tables_on(device: torch.device) -> CabacTables:
    """The shared CabacTables instance on `device` (built once)."""
    device = torch.device(device)
    t = _CABAC_CACHE.get(device)
    if t is None:
        t = CabacTables.build().to(device)
        _CABAC_CACHE[device] = t
    return t
