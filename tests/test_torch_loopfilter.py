"""heif_tpu_torch deblocking and SAO vs heif_tpu.ops.jax_recon.

Random non-square planes and per-edge / per-pixel parameters, made from a
seed with numpy, go through the JAX passes (vmapped over tiles, as
batch._core runs them) and the port's batched passes. Tolerance 0.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from heif_tpu.ops import jax_recon as J
from heif_tpu_torch.ops import recon as R
from heif_tpu_torch.tables import ReconTables

TABLES = ReconTables.build()
T = torch.from_numpy


def _plane(rng, n, h, w, bd):
    """Blocky planes: smooth 8x8 patches plus noise, so that every
    deblocking decision (off / weak / strong) occurs."""
    base = rng.integers(0, 1 << bd, (n, h // 8 + 1, w // 8 + 1))
    p = np.repeat(np.repeat(base, 8, 1), 8, 2)[:, :h, :w]
    p = p + rng.integers(-3, 4, (n, h, w)) * (1 << (bd - 8))
    flat = rng.random((n, h // 8 + 1, w // 8 + 1)) < 0.5
    mask = np.repeat(np.repeat(flat, 8, 1), 8, 2)[:, :h, :w]
    p = np.where(mask, (1 << (bd - 1)) + (p & 7), p)
    return np.clip(p, 0, (1 << bd) - 1).astype(np.int32)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("h,w", [(32, 64), (48, 24), (64, 64)])
def test_deblock_luma_pass(h, w, bd):
    rng = np.random.default_rng(h * w + bd)
    n = 3
    ne = w // 8 - 1
    plane = _plane(rng, n, h, w, bd)
    shp = (n, h // 4, ne)
    edge = rng.random(shp) < 0.8
    qp_p = rng.integers(10, 52, shp).astype(np.int32)
    qp_q = rng.integers(10, 52, shp).astype(np.int32)
    nf_p = rng.random(shp) < 0.1
    nf_q = rng.random(shp) < 0.1
    for beta_off, tc_off in ((0, 0), (6, -4)):
        want = np.asarray(jax.vmap(partial(
            J._deblock_luma_pass, beta_off=beta_off, tc_off=tc_off, bd=bd,
        ))(plane, edge, qp_p, qp_q, nf_p, nf_q))
        got = R.deblock_luma_pass(
            T(plane), T(edge), T(qp_p), T(qp_q), T(nf_p), T(nf_q), beta_off,
            tc_off, bd, TABLES,
        ).numpy()
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(got, plane)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("h,w", [(16, 32), (24, 16), (32, 32)])
def test_deblock_chroma_pass(h, w, bd):
    rng = np.random.default_rng(h * w + bd + 1)
    n = 3
    ne = w // 8 - 1
    plane = _plane(rng, n, h, w, bd)
    shp = (n, h // 2, ne)
    edge = rng.random(shp) < 0.8
    qpc = rng.integers(10, 52, shp).astype(np.int32)
    nf_p = rng.random(shp) < 0.1
    nf_q = rng.random(shp) < 0.1
    for tc_off in (0, 8, -6):
        want = np.asarray(jax.vmap(partial(
            J._deblock_chroma_pass, tc_off=tc_off, bd=bd,
        ))(plane, edge, qpc, nf_p, nf_q))
        got = R.deblock_chroma_pass(
            T(plane), T(edge), T(qpc), T(nf_p), T(nf_q), tc_off, bd, TABLES,
        ).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("h,w", [(24, 40), (40, 24)])
def test_sao_component(h, w, bd):
    rng = np.random.default_rng(h + w + bd)
    n = 3
    plane = _plane(rng, n, h, w, bd)
    stype = rng.integers(0, 3, (n, h, w)).astype(np.int32)
    band = rng.integers(0, 32, (n, h, w))
    eo = rng.integers(0, 4, (n, h, w))
    sclass = np.where(stype == 1, band, eo).astype(np.int32)
    offs = rng.integers(-7, 8, (n, h, w, 4)).astype(np.int32)
    nf_pix = rng.random((n, h, w)) < 0.1
    want = np.asarray(jax.vmap(partial(J.sao_component, bd=bd))(
        plane, stype, sclass, offs, nf_pix))
    got = R.sao_component(T(plane), T(stype), T(sclass), T(offs), T(nf_pix),
                          bd).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, plane)
