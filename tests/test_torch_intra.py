"""heif_tpu_torch intra stage vs heif_tpu (bit-exact, tolerance 0).

- ref_sources vs jax_recon.ref_sources_device (real tiles, padding steps,
  interior tile boundaries);
- predict_block / filter_refs (direct spec formulas) vs the JAX package's
  linear-weight formulation, every mode and size, 8 and 10 bit;
- the plain intra walk (the CPU path of the kernel wrappers) vs the
  vmapped XLA scan (jax_recon.intra_scan_component) and vs the Pallas
  kernels in interpret mode (pallas_intra.intra_scan_pallas /
  intra_scan_pallas_chroma2), on two real halfmoonbay tiles;
- a synthetic 10-bit batch with PCM and strong smoothing vs the XLA scan
  (the Pallas kernels never took those);
- on a CUDA card only: the CUDA kernels vs the plain walk.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heif_tpu import native
from heif_tpu.cabac.syntax import TileSyntaxDecoder
from heif_tpu.container.reader import HeifReader
from heif_tpu.hevc import params
from heif_tpu.hevc import slice as sl
from heif_tpu.hevc.rbsp import remove_emulation_prevention
from heif_tpu.ops import jax_recon as J
from heif_tpu.ops import pallas_intra as PI
from heif_tpu_torch.ops import batch as TB
from heif_tpu_torch.ops import intra as I
from heif_tpu_torch.ops import recon as R
from heif_tpu_torch.tables import ReconTables
from heif_tpu_torch.utils.synthetic import synthetic_batch

TILES = (1, 24)  # sky (trivial) + a detailed tile (1405 luma TUs)
CPU = torch.device("cpu")
TABLES = ReconTables.build()


@pytest.fixture(scope="module")
def flagship(halfmoonbay_bytes):
    r = HeifReader(halfmoonbay_bytes)
    rec = r.read().hevc_configuration_record()
    sps = params.parse_sps(
        remove_emulation_prevention(rec.nal_units_of_type(33)[0][2:]))
    pps = params.parse_pps(
        remove_emulation_prevention(rec.nal_units_of_type(34)[0][2:]))
    slices = [
        sl.parse_slice_header(
            sl.split_length_prefixed_nals(r.get_item_data(t), 4)[0], sps, pps)
        for t in TILES
    ]
    if native.available():
        sts = native.decode_tiles_parallel(sps, pps, slices)
    else:
        sts = [TileSyntaxDecoder(sps, pps, ps).decode() for ps in slices]
    return TB.pack_batch(sts, sps, pps, slices)


def _inputs(bp):
    """Device dict, residual planes and source tables of a plan (CPU)."""
    d = TB.plan_to_device(bp, CPU)
    return d, TB.residual_planes(d, bp, CPU), TB.source_tables(d, bp)


def _jax_src(bp, comp, **tiles):
    xs = bp.xs[comp]
    return np.asarray(jax.jit(partial(
        J.ref_sources_device, comp=comp, W=bp.width, H=bp.height,
        ctb_log2=bp.ctb_log2, **tiles,
    ))(xs[0], xs[1], xs[2]))


def _xla_scan(bp, res, comp, xs_comp, src):
    """jax_recon.intra_scan_component vmapped over tiles, as batch._core
    runs it off the Pallas path."""
    n = bp.n
    h = bp.height if comp == 0 else bp.height // 2
    w = bp.width if comp == 0 else bp.width // 2
    pcm = (bp.pcm[comp] if bp.pcm[comp] is not None
           else np.zeros((n, h + J.PAD, w + J.PAD), np.int32))
    plane0 = jnp.zeros((n, 1 + h + J.SPAD, 1 + w + J.SPAD), jnp.int32)
    fn = jax.jit(jax.vmap(partial(
        J.intra_scan_component, is_luma=comp == 0,
        strong_smoothing=bp.strong_smoothing,
        bd=bp.bit_depth_y if comp == 0 else bp.bit_depth_c,
    )))
    xs = tuple(jnp.asarray(a) for a in bp.xs[xs_comp]) + (jnp.asarray(src),)
    out = fn(plane0, jnp.asarray(res.numpy()), jnp.asarray(pcm), xs)
    return np.asarray(out)[:, 1 : 1 + h, 1 : 1 + w]


def _port_walks(bp, d, res, srcs):
    H, W = bp.height, bp.width
    y = I.intra_scan_luma(
        res[0], d["steps"][0], srcs[0], d["counts"][0], d["pcm"][0], h=H,
        w=W, strong_smoothing=bp.strong_smoothing, bd=bp.bit_depth_y)
    cb, cr = I.intra_scan_chroma2(
        res[1], res[2], d["steps"][1], srcs[1], d["counts"][1], d["pcm"][1],
        d["pcm"][2], h=H // 2, w=W // 2, bd=bp.bit_depth_c)
    return [p.cpu().numpy() for p in (y, cb, cr)]


# --------------------------------------------------------------------------
# reference sources
# --------------------------------------------------------------------------


@pytest.mark.parametrize("comp", [0, 1, 2])
def test_ref_sources_match_jax(flagship, comp):
    bp = flagship
    xs = bp.xs[comp]
    got = R.ref_sources(
        torch.from_numpy(xs[0]), torch.from_numpy(xs[1]),
        torch.from_numpy(xs[2]), comp=comp, W=bp.width, H=bp.height,
        ctb_log2=bp.ctb_log2,
    ).numpy()
    want = _jax_src(bp, comp)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    pad = xs[2] == 0  # padding steps are all-255
    assert pad.any() and (got[pad] == 255).all()


@pytest.mark.parametrize("comp", [0, 1])
def test_ref_sources_tile_boundaries(comp):
    """Interior tile boundaries (§6.4.1) on a non-square synthetic plan."""
    bp = TB.pack_batch(*synthetic_batch(n=2, size=96, height=64, bd=8,
                                        pcm=False, seed=11))
    tiles = dict(tile_col_bd=(32, 64), tile_row_bd=(32,))
    xs = bp.xs[comp]
    got = R.ref_sources(
        torch.from_numpy(xs[0]), torch.from_numpy(xs[1]),
        torch.from_numpy(xs[2]), comp=comp, W=bp.width, H=bp.height,
        ctb_log2=bp.ctb_log2, **tiles,
    ).numpy()
    want = _jax_src(bp, comp, **tiles)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(want, _jax_src(bp, comp))


# --------------------------------------------------------------------------
# prediction and filtering, per block
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("is_luma", [True, False])
def test_predict_block_matches_weights(is_luma, bd):
    rng = np.random.default_rng(bd + 2 * is_luma)
    modes = np.repeat(np.arange(35), 4).astype(np.int32)
    sizes = np.tile([4, 8, 16, 32], 35).astype(np.int32)
    n = modes.size
    left = rng.integers(0, 1 << bd, (n, R.REF_LEN)).astype(np.int32)
    top = rng.integers(0, 1 << bd, (n, R.REF_LEN)).astype(np.int32)
    log2 = np.log2(sizes).astype(np.int32)
    want = np.asarray(jax.vmap(
        lambda l, t, s, lg, m: J._predict_block(l, t, s, lg, m, is_luma,
                                                False, bd)
    )(left, top, sizes, log2, modes))
    got = R.predict_block(
        torch.from_numpy(left), torch.from_numpy(top),
        torch.from_numpy(sizes), torch.from_numpy(modes).long(), is_luma, bd,
        TABLES,
    ).numpy()
    r = np.arange(32)
    inside = (r[None, :, None] < sizes[:, None, None]) & (
        r[None, None, :] < sizes[:, None, None])
    np.testing.assert_array_equal(np.where(inside, got, 0),
                                  np.where(inside, want, 0))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("strong", [False, True])
def test_filter_refs_match_jax(strong, bd):
    rng = np.random.default_rng(7 + bd)
    n = 64
    sizes = np.tile([4, 8, 16, 32], n // 4).astype(np.int32)
    filt = rng.integers(0, 2, n).astype(np.int32)
    base = rng.integers(0, 1 << bd, (n, 1))
    # flat-ish references so the bilinear (strong) condition triggers
    left = np.clip(base + rng.integers(-2, 3, (n, R.REF_LEN)), 0,
                   (1 << bd) - 1).astype(np.int32)
    top = np.clip(base + rng.integers(-2, 3, (n, R.REF_LEN)), 0,
                  (1 << bd) - 1).astype(np.int32)
    left[::3] = rng.integers(0, 1 << bd, (len(left[::3]), R.REF_LEN))
    wl, wt = jax.vmap(
        lambda l, t, s, f: J._filter_refs(l, t, s, 0, 0, f, strong, bd)
    )(left, top, sizes, filt)
    gl, gt = R.filter_refs(torch.from_numpy(left), torch.from_numpy(top),
                           torch.from_numpy(sizes), torch.from_numpy(filt),
                           strong, bd)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))


# --------------------------------------------------------------------------
# the plain walk (CPU path of the kernel wrappers)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flagship_walks(flagship):
    d, res, srcs = _inputs(flagship)
    return d, res, srcs, _port_walks(flagship, d, res, srcs)


@pytest.mark.parametrize("comp", [0, 1, 2])
def test_plain_walk_matches_xla_scan(flagship, flagship_walks, comp):
    d, res, srcs, got = flagship_walks
    # the XLA scan runs each component on its own worklist; the port runs
    # Cr on the Cb worklist (identical geometry and mode in 4:2:0)
    want = _xla_scan(flagship, res[comp], comp, comp, srcs[min(comp, 1)].numpy())
    np.testing.assert_array_equal(got[comp], want)


def test_plain_walk_matches_pallas_luma_interpret(flagship, flagship_walks):
    bp = flagship
    d, res, srcs, got = flagship_walks
    out = PI.intra_scan_pallas(
        jnp.asarray(res[0].numpy()), jnp.asarray(PI.build_meta(bp.xs[0])),
        jnp.asarray(srcs[0].numpy()), bp.height, bp.width, True,
        bp.strong_smoothing, interpret=True,
        counts=jnp.asarray(bp.counts[0]),
    )
    np.testing.assert_array_equal(got[0], np.asarray(out))


def test_plain_walk_matches_pallas_chroma_interpret(flagship, flagship_walks):
    bp = flagship
    d, res, srcs, got = flagship_walks
    cb, cr = PI.intra_scan_pallas_chroma2(
        jnp.asarray(res[1].numpy()), jnp.asarray(res[2].numpy()),
        jnp.asarray(PI.build_meta(bp.xs[1])), jnp.asarray(srcs[1].numpy()),
        bp.height // 2, bp.width // 2, interpret=True,
        counts=jnp.asarray(bp.counts[1]),
    )
    np.testing.assert_array_equal(got[1], np.asarray(cb))
    np.testing.assert_array_equal(got[2], np.asarray(cr))


@pytest.mark.parametrize("comp", [0, 1, 2])
def test_plain_walk_10bit_pcm_matches_xla_scan(comp):
    bp = TB.pack_batch(*synthetic_batch(n=2, size=64, height=96, bd=10,
                                        pcm=True, seed=3))
    assert all(p is not None for p in bp.pcm) and bp.strong_smoothing
    d, res, srcs = _inputs(bp)
    got = _port_walks(bp, d, res, srcs)[comp]
    want = _xla_scan(bp, res[comp], comp, comp, srcs[min(comp, 1)].numpy())
    np.testing.assert_array_equal(got, want)
    assert got.max() > 255  # 10-bit samples really occur


# --------------------------------------------------------------------------
# wrapper contract
# --------------------------------------------------------------------------


def test_wrappers_check_inputs_and_count_only_launches():
    bp = TB.pack_batch(*synthetic_batch(n=1, size=32, bd=8, pcm=False))
    d, res, srcs = _inputs(bp)
    I.reset_launches()
    y = I.intra_scan_luma(res[0], d["steps"][0], srcs[0], d["counts"][0],
                          h=32, w=32, strong_smoothing=False, bd=8)
    assert y.shape == (1, 32, 32) and y.dtype == torch.int32
    assert I.LAUNCHES == {"luma": 0, "chroma": 0}  # plain walks do not count
    with pytest.raises(TypeError):
        I.intra_scan_luma(res[0].long(), d["steps"][0], srcs[0],
                          d["counts"][0], h=32, w=32,
                          strong_smoothing=False, bd=8)
    with pytest.raises(ValueError):
        I.intra_scan_luma(res[0], d["steps"][0], srcs[0], d["counts"][0],
                          h=64, w=32, strong_smoothing=False, bd=8)
    with pytest.raises(ValueError):
        I.intra_scan_luma(res[0][:, ::2], d["steps"][0], srcs[0],
                          d["counts"][0], h=32, w=32,
                          strong_smoothing=False, bd=8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bd,pcm", [(8, False), (10, True)])
def test_cuda_kernels_match_plain_walk(cuda_device, bd, pcm):
    bp = TB.pack_batch(*synthetic_batch(n=3, size=128, height=64, bd=bd,
                                        pcm=pcm, seed=bd))
    d = TB.plan_to_device(bp, cuda_device)
    res = TB.residual_planes(d, bp, cuda_device)
    srcs = TB.source_tables(d, bp)
    I.reset_launches()
    got = _port_walks(bp, d, res, srcs)
    assert I.LAUNCHES == {"luma": 1, "chroma": 1}
    dc, resc, srcc = _inputs(bp)
    want = _port_walks(bp, dc, resc, srcc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
