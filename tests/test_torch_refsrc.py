"""heif_tpu_torch.ops.refsrc vs stage 2a of heif_tpu.ops.batch._core.

The reference-source tables ([N, S, 2, 65] uint8) of each worklist go
through heif_tpu's jax_recon.ref_sources_device, as `_core` calls it, and
through the port's wrapper on CPU tensors, which runs the plain version
(recon.ref_sources): on the seeded worklists of utils.refsrc_fuzz (edges
and corners, padding steps, CTB 16-64, luma and chroma, up to a tile a
CTB), on synthetic plans with and without HEVC tile boundaries, and on a
2-tile flagship plan. Tolerance 0. The CUDA kernel runs only on a card
(tests/test_torch_card.py holds it against the plain version); here a
numpy transcription of its own logic (a warp a TU: five 32-lane rounds
of availability gathered into a 129-bit mask, the substitution as a
lookup of the last available position at or before each one, else the
walk's first) is held against the plain version on the same worklists.
Also without CUDA: the wrapper's argument checks and the byte count.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heif_tpu.ops import jax_recon as J
from heif_tpu_torch.ops import batch as B
from heif_tpu_torch.ops import recon as R
from heif_tpu_torch.ops import refsrc as RF
from heif_tpu_torch.utils import refsrc_fuzz as F
from heif_tpu_torch.utils.synthetic import synthetic_batch

REF_LEN = R.REF_LEN


def jax_sources(steps, comp, W, H, ctb_log2, cols=(), rows=()):
    return np.asarray(J.ref_sources_device(
        jnp.asarray(steps[..., 0]), jnp.asarray(steps[..., 1]),
        jnp.asarray(steps[..., 2]), comp=comp, W=W, H=H, ctb_log2=ctb_log2,
        tile_col_bd=cols, tile_row_bd=rows))


# a numpy transcription of csrc/refsrc.cu


def _z_addr(g4y, g4x, cl, ctbs_x):
    ctb = (g4y >> cl) * ctbs_x + (g4x >> cl)
    m = (1 << cl) - 1
    ix, iy = g4x & m, g4y & m
    z = np.zeros_like(g4x)
    for b in range(cl):
        z |= ((ix >> b) & 1) << (2 * b) | ((iy >> b) & 1) << (2 * b + 1)
    return (ctb << (2 * cl)) + z


def _tile_of(v, bd):
    return sum((v >= b).astype(np.int64) for b in bd) if bd else 0 * v


def kernel_model(steps, comp, W, H, ctb_log2, cols=(), rows=()):
    """What ref_sources_kernel writes, all TUs at once: lane l of a TU's
    warp takes walk positions l + 32 r (r = 0..4); five ballots give the
    mask; `first` is its lowest set bit; byte o of the output draws from
    walk position 2N (o = 0 or 65), 2N - p (left, p = o) or 2N + p (top,
    p = o - 65) for p - 1 < 2N; its source is the last available position
    at or before that one, else `first`; padding steps and TUs with no
    available position give 255."""
    n, s = steps.shape[:2]
    st = steps.reshape(-1, steps.shape[2]).astype(np.int64)
    x, y, size = st[:, 0:1], st[:, 1:2], st[:, 2:3]
    sub = 1 if comp == 0 else 2
    cl = ctb_log2 - 2
    ctbs_x = ((W >> 2) + (1 << cl) - 1) >> cl
    s2 = 2 * size
    w = np.arange(160)[None]  # 5 rounds of 32 lanes
    left = w <= s2
    cx = np.where(left, x - 1, x + (w - s2 - 1))
    cy = np.where(left, y + (s2 - 1 - w), y - 1)
    lx, ly = cx * sub, cy * sub
    z_cur = _z_addr((y * sub) >> 2, (x * sub) >> 2, cl, ctbs_x)
    zn = _z_addr(np.clip(ly, 0, H - 1) >> 2, np.clip(lx, 0, W - 1) >> 2, cl,
                 ctbs_x)
    avail = ((w < 129) & (w <= 2 * s2) & (lx >= 0) & (ly >= 0) & (lx < W)
             & (ly < H) & (zn < z_cur)
             & (_tile_of(lx, cols) == _tile_of(x * sub, cols))
             & (_tile_of(ly, rows) == _tile_of(y * sub, rows)))
    bits = (avail.reshape(-1, 5, 32).astype(np.uint64)
            << np.arange(32, dtype=np.uint64))
    masks = bits.sum(-1).astype(np.uint64)  # [T, 5] words of 32 bits
    first = np.full(len(st), -1)
    for r in range(4, -1, -1):
        m = masks[:, r]
        low = np.log2((m & (~m + np.uint64(1))).astype(np.float64) + (m == 0))
        first = np.where(m != 0, 32 * r + low.astype(np.int64), first)
    out = np.full((len(st), 2 * REF_LEN), 255, np.uint8)
    s2v = s2[:, 0]
    for o in range(2 * REF_LEN):
        side, p = divmod(o, REF_LEN)
        pos = np.where(p == 0, s2v, np.where(side == 1, s2v + p, s2v - p))
        drawn = (p == 0) | (p - 1 < s2v)
        # last available at or before pos: its word, then the words below
        word = pos >> 5
        keep = (np.uint64(0xFFFFFFFF) >> (31 - (pos & 31)).astype(np.uint64))
        cur = masks[np.arange(len(st)), np.clip(word, 0, 4)] & keep
        src = np.full(len(st), -1)
        done = cur != 0
        src = np.where(done, 32 * word + np.floor(np.log2(
            cur.astype(np.float64) + (cur == 0))).astype(np.int64), src)
        for k in range(1, 5):
            wk = word - k
            ok = ~done & (wk >= 0)
            mk = masks[np.arange(len(st)), np.clip(wk, 0, 4)]
            hit = ok & (mk != 0)
            src = np.where(hit, 32 * wk + np.floor(np.log2(
                mk.astype(np.float64) + (mk == 0))).astype(np.int64), src)
            done |= hit
        src = np.where(src < 0, first, src)
        val = np.where(src <= s2v, s2v - src, src - s2v + REF_LEN)
        ok = drawn & (first >= 0) & (size[:, 0] > 0)
        out[:, o] = np.where(ok, val, 255)
    return out.reshape(n, s, 2, REF_LEN)


def _fuzz_args(case):
    return (F.inputs(case), case.comp, case.width, case.height,
            case.ctb_log2, case.tile_col_bd, case.tile_row_bd)


def _wrapper(steps, comp, W, H, ctb_log2, cols=(), rows=()):
    RF.reset_launches()
    got = RF.ref_sources(torch.from_numpy(np.ascontiguousarray(steps)),
                         comp=comp, W=W, H=H, ctb_log2=ctb_log2,
                         tile_col_bd=cols, tile_row_bd=rows).numpy()
    assert RF.LAUNCHES == {"ref_sources": 0}  # no kernel on the CPU
    assert got.dtype == np.uint8
    return got


@pytest.mark.parametrize("case", F.CASES, ids=lambda c: f"seed{c.seed}")
def test_ref_sources_equal_jax_on_fuzz(case):
    args = _fuzz_args(case)
    got = _wrapper(*args)
    np.testing.assert_array_equal(got, jax_sources(*args))
    pad = args[0][..., 2] == 0
    assert pad.any() and (got[pad] == 255).all()


@pytest.mark.parametrize("case", F.CASES, ids=lambda c: f"seed{c.seed}")
def test_kernel_model_equals_plain_on_fuzz(case):
    args = _fuzz_args(case)
    np.testing.assert_array_equal(kernel_model(*args), _wrapper(*args))


def test_fuzz_covers_the_contract():
    """Every size, padding steps, TUs with no position available and with
    some, walk position 0 substituted from the walk's first available
    position, and a tile a CTB at the HEVC limit."""
    none = some = subst = 0
    sizes = set()
    for case in F.CASES:
        args = _fuzz_args(case)
        got = _wrapper(*args)
        st = args[0]
        real = st[..., 2] > 0
        sizes |= set(st[..., 2][real].tolist())
        allbad = (got == 255).all(axis=(-1, -2))
        none += int((real & allbad).sum())
        some += int((real & ~allbad).sum())
        # the first left-side source (walk position 0) drawn from further
        # along the walk: the substitution of §8.4.4.2.2's first step
        s2 = 2 * st[..., 2]
        bottom = np.take_along_axis(got[..., 0, :],
                                    np.clip(s2, 0, 64)[..., None], -1)[..., 0]
        subst += int((real & (bottom != 255) & (bottom != s2)).sum())
    assert sizes == {4, 8, 16, 32}
    assert none > 0 and some > 0 and subst > 0
    assert max(len(c.tile_col_bd) for c in F.CASES) == 19
    assert max(len(c.tile_row_bd) for c in F.CASES) == 21


def _plan(tiles: bool):
    bp = B.pack_batch(*synthetic_batch(n=2, size=96, height=64, bd=8,
                                       pcm=False, seed=11))
    if tiles:
        bp = dataclasses.replace(bp, tile_col_bd=(32, 64), tile_row_bd=(32,))
    return bp


@pytest.mark.parametrize("tiles", [False, True], ids=["no_tiles", "tiles"])
@pytest.mark.parametrize("comp", [0, 1])
def test_source_tables_of_a_plan_equal_jax(tiles, comp):
    """batch.source_tables (the wrappers, as core calls them) on a
    synthetic plan with and without interior tile boundaries; the model
    of the kernel agrees."""
    bp = _plan(tiles)
    d = B.plan_to_device(bp, torch.device("cpu"))
    got = B.source_tables(d, bp)[comp].numpy()
    args = (np.stack(bp.xs[comp], -1), comp, bp.width,
            bp.height, bp.ctb_log2, bp.tile_col_bd, bp.tile_row_bd)
    np.testing.assert_array_equal(got, jax_sources(*args))
    np.testing.assert_array_equal(kernel_model(*args), got)


@pytest.fixture(scope="module")
def flagship_pair(halfmoonbay_bytes):
    from heif_tpu_torch import native
    from heif_tpu_torch.tools import image_slices

    sps, pps, slices, _ = image_slices(halfmoonbay_bytes)
    slices = slices[:2]
    sts = native.decode_tiles_parallel(sps, pps, slices)
    return B.pack_batch(sts, sps, pps, slices)


@pytest.mark.parametrize("comp", [0, 1])
def test_source_tables_of_flagship_tiles_equal_jax(flagship_pair, comp):
    bp = flagship_pair
    d = B.plan_to_device(bp, torch.device("cpu"))
    got = B.source_tables(d, bp)[comp].numpy()
    steps = np.stack(bp.xs[comp], -1)
    args = (steps, comp, bp.width, bp.height, bp.ctb_log2)
    np.testing.assert_array_equal(got, jax_sources(*args))
    np.testing.assert_array_equal(kernel_model(*args), got)


def _bad(kind: str):
    case = F.CASES[0]
    steps = torch.from_numpy(F.inputs(case))
    kw = dict(comp=0, W=case.width, H=case.height, ctb_log2=case.ctb_log2)
    if kind == "dtype":
        steps = steps.long()
    elif kind == "fields":
        steps = steps[..., :2].contiguous()
    elif kind == "rank":
        steps = steps[0]
    elif kind == "layout":
        steps = steps.transpose(0, 1)
    elif kind == "comp":
        kw["comp"] = 2
    elif kind == "ctb":
        kw["ctb_log2"] = 7
    elif kind == "size":
        kw["W"] = 0
    elif kind == "tiles":
        kw["tile_col_bd"] = tuple(range(8, 8 * 22, 8))
    elif kind == "device":
        steps = steps.to("meta")
    return steps, kw


BAD = ("dtype", "fields", "rank", "layout", "comp", "ctb", "size", "tiles",
       "device")


@pytest.mark.parametrize("kind", BAD)
def test_wrapper_raises_on_bad_arguments(kind):
    """The checks run before any build or launch, so they hold without
    CUDA; nothing is counted."""
    steps, kw = _bad(kind)
    RF.reset_launches()
    with pytest.raises((TypeError, ValueError)):
        RF.ref_sources(steps, **kw)
    assert RF.LAUNCHES == {"ref_sources": 0}


def test_refsrc_bytes():
    """Each step's x, y and size read, its 130 table bytes written."""
    steps = torch.zeros((3, 50, 6), dtype=torch.int32)
    assert RF.refsrc_bytes(steps) == 150 * (12 + 130)
