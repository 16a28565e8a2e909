"""Tile-parallel decode over several devices (pipeline) and processes
(distributed: python -m heif_tpu_torch.parallel.distributed)."""

from heif_tpu_torch.parallel.pipeline import (
    decode_grid_sharded,
    decode_grid_sharded_streamed,
    make_mesh,
    reconstruct_sharded,
)

__all__ = [
    "make_mesh",
    "reconstruct_sharded",
    "decode_grid_sharded",
    "decode_grid_sharded_streamed",
]
