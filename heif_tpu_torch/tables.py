"""Spec constant tables as device buffers.

Counterpart of the module-level constants of heif_tpu/ops/jax_recon.py
(inverse-angle index, chroma QP LUT, BETA/TC, LEVEL_SCALE) and of
heif_tpu/ops/tables.py (DCT/DST matrices, intraPredAngle). A
ReconTables module carries them all as int32 buffers, so `.to(device)`
moves the whole set at once.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from heif_tpu.cabac.syntax import chroma_qp_from_luma
from heif_tpu.ops import tables as TB

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
