"""heif_tpu_torch tables and device selection vs the JAX package.

The JAX package's module constants (heif_tpu/ops/jax_recon.py) carried
across with tables_from_numpy must equal ReconTables.build(), which uses
only the spec tables of heif_tpu.ops.tables. Tolerance 0: integer tables.
"""

import numpy as np
import pytest
import torch

from heif_tpu.ops import jax_recon as J
from heif_tpu.ops.tables import DST4, dct_matrix
from heif_tpu_torch.device import resolve_device
from heif_tpu_torch.tables import TABLE_SHAPES, ReconTables, tables_from_numpy


def _jax_arrays():
    return {
        "dct4": dct_matrix(4),
        "dct8": dct_matrix(8),
        "dct16": dct_matrix(16),
        "dct32": dct_matrix(32),
        "dst4": DST4,
        "level_scale": J._LEVEL_SCALE,
        "beta": J._BETA,
        "tc": J._TC,
        "chroma_qp_lut": J._CHROMA_QP_LUT,
        "intra_pred_angle": J._ANGLES,
        "inv_idx": J._INV_IDX,
    }


@pytest.mark.parametrize("name", sorted(TABLE_SHAPES))
def test_tables_from_jax_equal_build(name):
    carried = tables_from_numpy(_jax_arrays())
    built = ReconTables.build()
    a, b = getattr(carried, name), getattr(built, name)
    assert a.dtype == torch.int32 and tuple(a.shape) == TABLE_SHAPES[name]
    assert torch.equal(a, b), name
    np.testing.assert_array_equal(b.numpy(), np.asarray(_jax_arrays()[name]))


def test_tables_reject_bad_input():
    arrays = _jax_arrays()
    with pytest.raises(ValueError, match="missing"):
        tables_from_numpy({k: v for k, v in arrays.items() if k != "beta"})
    arrays["tc"] = arrays["tc"][:10]
    with pytest.raises(ValueError, match="shape"):
        tables_from_numpy(arrays)


def test_tables_move_as_one_module():
    t = ReconTables.build()
    names = [n for n, _ in t.named_buffers()]
    assert names == list(TABLE_SHAPES)
    assert all(b.device.type == "cpu" for b in t.buffers())


def test_resolve_device_is_explicit():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        assert resolve_device(None).type == "cuda"
    else:
        # no silent fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError):
            resolve_device(None)
