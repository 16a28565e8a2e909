"""heif_tpu_torch residual stage vs heif_tpu.ops.jax_recon (bit-exact).

Random levels made from a seed with numpy go through J.residual_class and
the port's residual_class (float64 batched matmuls) for all 10
(component, size) classes, DST, transform skip, bypass, flat / default /
random scaling lists and bit depths 8 and 10; extreme levels prove the
float64 path exact where float32 is not. Tolerance 0.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from heif_tpu.hevc.grammar import ScalingListData
from heif_tpu.ops import jax_recon as J
from heif_tpu.ops.tables import scaling_factor_matrix
from heif_tpu_torch.ops import batch as TB
from heif_tpu_torch.ops import recon as R
from heif_tpu_torch.ops import residual as RS
from heif_tpu_torch.tables import ReconTables
from heif_tpu_torch.utils.synthetic import synthetic_batch

TABLES = ReconTables.build()


def _random_lists(rng) -> ScalingListData:
    lists = ScalingListData.default()
    lists.scaling_list = [
        [list(rng.integers(1, 256, len(m))) for m in per_size]
        for per_size in lists.scaling_list
    ]
    lists.dc = [list(rng.integers(1, 256, len(d))) for d in lists.dc]
    return lists


def _run_both(coeffs, qp, dst, skip, byp, scaling, size, bd):
    want = np.asarray(J.residual_class(
        jnp.asarray(coeffs), jnp.asarray(qp), jnp.asarray(dst),
        jnp.asarray(skip), jnp.asarray(byp), jnp.asarray(scaling), size, bd,
    ))
    got = R.residual_class(
        torch.from_numpy(coeffs), torch.from_numpy(qp), torch.from_numpy(dst),
        torch.from_numpy(skip), torch.from_numpy(byp),
        torch.from_numpy(scaling), size, bd, TABLES,
    ).numpy()
    return got, want


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("lists_kind", ["flat", "default", "random"])
@pytest.mark.parametrize("comp,size", TB.CLASSES)
def test_residual_class_bit_exact(comp, size, lists_kind, bd):
    rng = np.random.default_rng(1000 * size + 10 * comp + bd)
    n = 24
    coeffs = rng.integers(-3000, 3000, (n, size, size)).astype(np.int16)
    coeffs[rng.random((n, size, size)) < 0.6] = 0
    qp = rng.integers(0, 52 + 6 * (bd - 8), n).astype(np.int32)
    dst = np.full(n, comp == 0 and size == 4)
    if size == 4:
        dst[::3] = ~dst[::3]
    skip = rng.random(n) < 0.2
    byp = rng.random(n) < 0.1
    lists = {"flat": None, "default": ScalingListData.default(),
             "random": _random_lists(rng)}[lists_kind]
    scaling = scaling_factor_matrix(size, comp, lists)
    got, want = _run_both(coeffs, qp, dst, skip, byp, scaling, size, bd)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_residual_extreme_levels_exact(size):
    """Saturated levels at the dequant clip: |d| = 32768 in every slot
    drives |T^T D| to s * 32768 * 90 (9.4e7 at s=32), past float32's
    2^24 exact range; the float64 products must stay exact."""
    n = 6
    coeffs = np.full((n, size, size), 32767, np.int16)
    coeffs[1] = -32768
    coeffs[2, ::2] = -32768
    coeffs[3, :, 1::2] = -32768
    rng = np.random.default_rng(size)
    coeffs[4] = rng.choice([-32768, 32767], (size, size))
    coeffs[5] = rng.integers(-32768, 32768, (size, size))
    qp = np.asarray([51, 51, 40, 30, 51, 45], np.int32)
    zeros = np.zeros(n, bool)
    dst = np.full(n, size == 4)
    scaling = np.full((size, size), 255, np.int32)
    for bd in (8, 10):
        got, want = _run_both(coeffs, qp, dst, zeros, zeros, scaling, size, bd)
        np.testing.assert_array_equal(got, want)


def test_scatter_classes_matches_flat_scatter():
    """Block row-scatter into [N, h+PAD, w+PAD] planes equals the JAX
    package's flat scatter (J.scatter_blocks) at the plan's org indices."""
    syn = synthetic_batch(n=3, size=64, height=96, bd=8, pcm=True, seed=5)
    bp = TB.pack_batch(*syn)
    d = TB.plan_to_device(bp, torch.device("cpu"))
    got = RS.residual_planes(d, bp)
    n, H, W = bp.n, bp.height, bp.width
    for comp in range(3):
        h, w = (H, W) if comp == 0 else (H // 2, W // 2)
        flat = jnp.zeros((n * (h + R.PAD) * (w + R.PAD),), jnp.int32)
        for (c, size) in bp.tc_coeffs:
            if c != comp:
                continue
            k = (c, size)
            r = J.residual_class(
                jnp.asarray(bp.tc_coeffs[k]), jnp.asarray(bp.tc_qp[k]),
                jnp.asarray(bp.tc_dst[k]), jnp.asarray(bp.tc_skip[k]),
                jnp.asarray(bp.tc_bypass[k]),
                jnp.asarray(bp.scaling[(size, c)]), size,
                bp.bit_depth_y if c == 0 else bp.bit_depth_c,
            )
            flat = J.scatter_blocks(flat, r, jnp.stack(
                [jnp.asarray(bp.tc_org[k]) // (w + R.PAD),
                 jnp.asarray(bp.tc_org[k]) % (w + R.PAD)], axis=1), size,
                w + R.PAD)
        want = np.asarray(flat).reshape(n, h + R.PAD, w + R.PAD)
        np.testing.assert_array_equal(got[comp].numpy(), want)
