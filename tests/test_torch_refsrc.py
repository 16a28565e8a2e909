"""heif_tpu_torch.ops.refsrc vs stage 2a of heif_tpu.ops.batch._core.

The reference-source tables ([N, S, 2, 65] uint8) of each worklist go
through heif_tpu's jax_recon.ref_sources_device, as `_core` calls it, and
through the port's wrapper on CPU tensors, which runs the plain version
(recon.ref_sources): on the seeded worklists of utils.refsrc_fuzz (edges
and corners, padding steps, CTB 16-64, luma and chroma, up to a tile a
CTB), on synthetic plans with and without HEVC tile boundaries, and on a
2-tile flagship plan. Tolerance 0. The CUDA kernel runs only on a card
(tests/test_torch_card.py holds it against the plain version); here a
numpy transcription of its own logic (one launch for the luma and the
chroma worklist, blocks of 128 TUs; a thread a TU tests availability
once per 4x4 luma block of its walk into a bit mask, then writes its
table unit by unit into the block's staged run of 130-byte tables, which
the block copies out 16 bytes a thread) is held against the plain
version on the same
worklists, and its block-level availability against the per-position
test on every worklist. Also without CUDA: the wrappers' argument checks
(pictures and tile boundaries that are not multiples of 8 among them)
and the byte count.
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

THREADS = 128  # TUs a block
NONE = 255
N_REF = 2 * REF_LEN


def _spread4(v):
    v = v & 15
    v = (v | (v << 2)) & 0x33
    return (v | (v << 1)) & 0x55


def _z_addr(g4y, g4x, cl, ctbs_x):
    """z_addr: the CTB's raster index, then the bit-spread interleave."""
    m = (1 << cl) - 1
    ctb = (g4y >> cl) * ctbs_x + (g4x >> cl)
    return (ctb << (2 * cl)) + (_spread4(g4x & m) | (_spread4(g4y & m) << 1))


def _span(v, bd):
    """tile_span: [lo, hi) between the interior boundaries around v."""
    lo = np.zeros_like(v)
    hi = np.full_like(v, 2 ** 31 - 1)
    for b in bd:
        lo = np.where(b <= v, np.maximum(lo, b), lo)
        hi = np.where(b > v, np.minimum(hi, b), hi)
    return lo, hi


def _geometry(comp, W, H, ctb_log2):
    sub = 1 if comp == 0 else 2
    cl = ctb_log2 - 2
    return sub, 2 if comp == 0 else 1, cl, ((W >> 2) + (1 << cl) - 1) >> cl


def unit_availability(steps, comp, W, H, ctb_log2, cols=(), rows=()):
    """The first phase's availability, a thread a TU: per TU (flattened)
    its s2 = 2N (0: padding or a size past 32) and per unit U of its walk
    (left units from the bottom, the corner, top units) the unit's first
    and last walk positions and whether it is available (False past
    2 * (2N / u))."""
    st = steps.reshape(-1, steps.shape[-1]).astype(np.int64)
    x, y, size = st[:, 0:1], st[:, 1:2], st[:, 2:3]
    sub, ushift, cl, ctbs_x = _geometry(comp, W, H, ctb_log2)
    u = 1 << ushift
    s2 = np.where((size > 0) & (size <= 32), 2 * size, 0)
    nl = s2 >> ushift
    U = np.arange(65)[None]
    left, corner = U < nl, U == nl
    j = (U - nl - 1) * u
    w0 = np.where(left, U * u, np.where(corner, s2, s2 + 1 + j))
    w1 = np.where(left, U * u + u - 1, np.where(corner, s2, s2 + j + u))
    cx = np.where(left | corner, x - 1, x + j)
    cy = np.where(left, y + s2 - 1 - U * u, y - 1)
    lx, ly = cx * sub, cy * sub
    tx0, tx1 = _span(x * sub, cols)
    ty0, ty1 = _span(y * sub, rows)
    z_cur = _z_addr((y * sub) >> 2, (x * sub) >> 2, cl, ctbs_x)
    avail = ((U <= 2 * nl) & (s2 > 0) & (lx >= 0) & (ly >= 0) & (lx < W)
             & (ly < H) & (lx >= tx0) & (lx < tx1) & (ly >= ty0) & (ly < ty1)
             & (_z_addr(np.clip(ly, 0, H - 1) >> 2, np.clip(lx, 0, W - 1) >> 2,
                        cl, ctbs_x) < z_cur))
    return s2[:, 0], w0, w1, avail


def tu_tables(steps, comp, W, H, ctb_log2, cols=(), rows=()):
    """tu_table of every TU (flattened), vectorised over TUs: the units in
    walk order, each writing its u bytes (an available unit: its own
    local index; else that of the last position of the last available
    unit before it, or of the first position of the first available unit,
    or 255), the corner both sides' index 0, then 255 past 2N; padding
    steps 255 throughout. Returns [T, 130] uint8."""
    s2, w0, w1, avail = unit_availability(steps, comp, W, H, ctb_log2, cols,
                                          rows)
    ushift = 2 if comp == 0 else 1
    u = 1 << ushift
    nl = s2 >> ushift
    t = np.full((len(s2), N_REF), NONE, np.int64)
    rows_ = np.arange(len(s2))
    any_ = avail.any(1)
    first = np.argmax(avail, 1)
    last = np.where(any_, w0[rows_, first], -1)

    def local(w):
        return np.where(w <= s2, s2 - w, w - s2 + REF_LEN)

    for U in range(65):
        on = (s2 > 0) & (U <= 2 * nl)
        a = avail[:, U]
        src = np.where(last < 0, NONE, local(last))
        corner, left = on & (U == nl), on & (U < nl)
        top = on & (U > nl)
        for side in (0, REF_LEN):
            t[corner, side] = np.where(a, 0, src)[corner]
        for i in range(u):
            p = s2 - w0[:, U] - i  # left: byte 2N - w
            t[left, np.clip(p, 0, N_REF - 1)[left]] = np.where(a, p, src)[left]
            o = REF_LEN + w0[:, U] + i - s2  # top: byte 65 + w - 2N
            t[top, np.clip(o, 0, N_REF - 1)[top]] = np.where(a, o, src)[top]
        last = np.where(on & a, w1[:, U], last)
    return t.astype(np.uint8)


def kernel_model2(lists, W, H, ctb_log2, cols=(), rows=()):
    """What ref_sources_kernel writes for lists = [luma steps or None,
    chroma steps or None] in one launch: blocks of THREADS TUs, the luma
    worklist's first; per block its TUs' tables staged as one contiguous
    run, then copied out 16 bytes a thread and store, thread t taking
    bytes 16 t, 16 (t + THREADS), ... (every byte exactly once)."""
    firsts, blocks = [], 0
    for st in lists:
        firsts.append(blocks)
        if st is not None:
            blocks += -(-(st.shape[0] * st.shape[1]) // THREADS)
    outs = [None if st is None else np.full(st.shape[0] * st.shape[1] * N_REF,
                                            77, np.uint8) for st in lists]
    tables = [None if st is None else
              tu_tables(st, c, W, H, ctb_log2, cols, rows).reshape(-1)
              for c, st in enumerate(lists)]
    for blk in range(blocks):
        c = int(blk >= firsts[1])
        base = (blk - firsts[c]) * THREADS * N_REF
        total = min(THREADS * N_REF, len(tables[c]) - base)
        stage = tables[c][base:base + total]
        written = np.zeros(total, int)
        for t in range(THREADS):
            for b in range(16 * t, total, 16 * THREADS):
                outs[c][base + b:base + b + 16] = stage[b:b + 16]
                written[b:b + 16] += 1
        assert (written == 1).all()
    return [None if o is None else o.reshape(*st.shape[:2], 2, REF_LEN)
            for o, st in zip(outs, lists)]


def kernel_model(steps, comp, W, H, ctb_log2, cols=(), rows=()):
    """The one-worklist launch (ref_sources): kernel_model2 with the other
    list absent."""
    lists = [None, None]
    lists[comp] = steps
    return kernel_model2(lists, W, H, ctb_log2, cols, rows)[comp]


def position_availability(steps, comp, W, H, ctb_log2, cols=(), rows=()):
    """§6.4.1 per walk position w = 0..128, as recon.ref_sources tests it
    (in the picture, same tile, earlier in z-order, w <= 4N)."""
    st = steps.reshape(-1, steps.shape[-1]).astype(np.int64)
    x, y, size = st[:, 0:1], st[:, 1:2], st[:, 2:3]
    sub, _, cl, ctbs_x = _geometry(comp, W, H, ctb_log2)
    s2 = 2 * size
    w = np.arange(129)[None]
    left = w <= s2
    cx = np.where(left, x - 1, x + (w - s2 - 1))
    cy = np.where(left, y + (s2 - 1 - w), y - 1)
    lx, ly = cx * sub, cy * sub

    def tile_of(v, bd):
        return sum((v >= b).astype(np.int64) for b in bd) if bd else 0 * v

    z_cur = _z_addr((y * sub) >> 2, (x * sub) >> 2, cl, ctbs_x)
    zn = _z_addr(np.clip(ly, 0, H - 1) >> 2, np.clip(lx, 0, W - 1) >> 2, cl,
                 ctbs_x)
    return ((w <= 2 * s2) & (lx >= 0) & (ly >= 0) & (lx < W) & (ly < H)
            & (zn < z_cur) & (tile_of(lx, cols) == tile_of(x * sub, cols))
            & (tile_of(ly, rows) == tile_of(y * sub, rows)))


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


def _real_positions(steps, comp, W, H, ctb_log2, cols=(), rows=()):
    """Per real TU and walk position w <= 4N: (per-position availability,
    the availability of the unit that holds w)."""
    s2, w0, w1, avail = unit_availability(steps, comp, W, H, ctb_log2, cols,
                                          rows)
    pos = position_availability(steps, comp, W, H, ctb_log2, cols, rows)
    ushift = 2 if comp == 0 else 1
    s2c = s2[:, None]
    w = np.arange(129)[None]
    U = np.where(w < s2c, w >> ushift, np.where(
        w == s2c, s2c >> ushift, (s2c >> ushift) + 1 + ((w - s2c - 1) >> ushift)))
    unit = np.take_along_axis(avail, np.clip(U, 0, 64), 1)
    keep = (s2c > 0) & (w <= 2 * s2c)
    return pos[keep], unit[keep]


@pytest.mark.parametrize("case", F.CASES, ids=lambda c: f"seed{c.seed}")
def test_block_availability_equals_position_availability_on_fuzz(case):
    """Every walk position has its 4x4 block's availability, and the
    unit's first and last positions bound it: the kernel's once-per-block
    test is the per-position one on these worklists."""
    pos, unit = _real_positions(*_fuzz_args(case))
    assert pos.size > 0 and pos.any() and not pos.all()
    np.testing.assert_array_equal(unit, pos)


@pytest.mark.parametrize("comp", [0, 1])
def test_block_availability_equals_position_availability_on_flagship(
        flagship_pair, comp):
    bp = flagship_pair
    pos, unit = _real_positions(np.stack(bp.xs[comp], -1), comp, bp.width,
                                bp.height, bp.ctb_log2)
    np.testing.assert_array_equal(unit, pos)


@pytest.mark.parametrize("tiles", [False, True], ids=["no_tiles", "tiles"])
def test_two_worklist_launch_model_equals_ref_sources2(tiles):
    """ref_sources2 on a plan's two worklists (CPU: the plain version of
    each) equals the model of the one launch that takes both, and each
    equals the one-worklist wrapper."""
    bp = _plan(tiles)
    d = B.plan_to_device(bp, torch.device("cpu"))
    geo = dict(W=bp.width, H=bp.height, ctb_log2=bp.ctb_log2,
               tile_col_bd=bp.tile_col_bd, tile_row_bd=bp.tile_row_bd)
    RF.reset_launches()
    got = RF.ref_sources2(d["steps"][0], d["steps"][1], **geo)
    assert RF.LAUNCHES == {"ref_sources": 0}
    model = kernel_model2([d["steps"][c].numpy() for c in range(2)],
                          bp.width, bp.height, bp.ctb_log2, bp.tile_col_bd,
                          bp.tile_row_bd)
    for c in range(2):
        np.testing.assert_array_equal(model[c], got[c].numpy())
        assert torch.equal(got[c], RF.ref_sources(d["steps"][c], comp=c,
                                                  **geo))


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
    elif kind == "side":
        kw["W"] = case.width + 4  # a side of 4 mod 8
    elif kind == "boundary":
        kw["tile_row_bd"] = (20,)
    return steps, kw


BAD = ("dtype", "fields", "rank", "layout", "comp", "ctb", "size", "tiles",
       "device", "side", "boundary")


@pytest.mark.parametrize("kind", BAD)
def test_wrapper_raises_on_bad_arguments(kind):
    """The checks run before any build or launch, so they hold without
    CUDA; nothing is counted."""
    steps, kw = _bad(kind)
    RF.reset_launches()
    with pytest.raises((TypeError, ValueError)):
        RF.ref_sources(steps, **kw)
    assert RF.LAUNCHES == {"ref_sources": 0}


def _bad2(kind: str):
    case = F.CASES[0]
    luma = torch.from_numpy(F.inputs(case))
    chroma = luma[:, :100].contiguous()
    kw = dict(W=case.width, H=case.height, ctb_log2=case.ctb_log2)
    if kind == "luma_dtype":
        luma = luma.long()
    elif kind == "chroma_fields":
        chroma = chroma[..., :2].contiguous()
    elif kind == "chroma_layout":
        chroma = chroma.transpose(0, 1)
    elif kind == "devices":
        chroma = chroma.to("meta")
    elif kind == "ctb":
        kw["ctb_log2"] = 3
    elif kind == "side":
        kw["H"] = case.height - 4
    elif kind == "boundary":
        kw["tile_col_bd"] = (36,)
    elif kind == "tiles":
        kw["tile_row_bd"] = tuple(range(8, 8 * 24, 8))
    return luma, chroma, kw


BAD2 = ("luma_dtype", "chroma_fields", "chroma_layout", "devices", "ctb",
        "side", "boundary", "tiles")


@pytest.mark.parametrize("kind", BAD2)
def test_two_worklist_wrapper_raises_on_bad_arguments(kind):
    """ref_sources2 checks both worklists and the geometry before any
    build or launch; nothing is counted."""
    luma, chroma, kw = _bad2(kind)
    RF.reset_launches()
    with pytest.raises((TypeError, ValueError)):
        RF.ref_sources2(luma, chroma, **kw)
    assert RF.LAUNCHES == {"ref_sources": 0}


def test_refsrc_bytes():
    """Each step's x, y and size read, its 130 table bytes written."""
    steps = torch.zeros((3, 50, 6), dtype=torch.int32)
    assert RF.refsrc_bytes(steps) == 150 * (12 + 130)
