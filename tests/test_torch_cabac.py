"""heif_tpu_torch CABAC replay engines vs heif_tpu (bit-exact, tolerance 0).

- CabacTables (built from cabac.engine and hevc.scans alone) vs the JAX
  modules' constant arrays;
- the numpy copies of the packers vs heif_tpu.ops.pallas_cabac's, field
  by field;
- the plain replay (the CPU path of the kernel wrappers) vs the Pallas
  kernels in interpret mode, on prefixes of tile 0's 16 WPP substreams of
  the flagship image: whole bin and state planes, pad region included;
- the plain replay and windowed replay vs the Pallas kernels on the
  seeded contract inputs of utils.cabac_fuzz (the card tests hold the
  kernels to the plain versions on the same inputs), bit 7 of the packed
  context bytes kept; the longest-lane and byte counts that
  chip_smoke.py prints;
- the plain replay over tile 0's full streams vs the host trace golden;
- on a CUDA card only: the CUDA kernels vs the plain versions.
"""

import numpy as np
import pytest
import torch

from heif_tpu.cabac.trace import KIND_PAD, TraceSegment, trace_tile
from heif_tpu.container.reader import HeifReader
from heif_tpu.hevc import params
from heif_tpu.hevc import slice as sl
from heif_tpu.hevc.rbsp import remove_emulation_prevention
from heif_tpu.ops import pallas_cabac as PC
from heif_tpu.ops import pallas_cabac_gen as PG
from heif_tpu_torch.ops import cabac as C
from heif_tpu_torch.tables import CABAC_SHAPES, CabacTables
from heif_tpu_torch.utils import cabac_fuzz as F


@pytest.fixture(scope="module")
def traced(halfmoonbay_bytes):
    """rbsp and the 16 full trace segments of flagship tile 0."""
    r = HeifReader(halfmoonbay_bytes)
    heif = r.read()
    rec = heif.hevc_configuration_record()
    sps = params.parse_sps(
        remove_emulation_prevention(rec.nal_units_of_type(33)[0][2:]))
    pps = params.parse_pps(
        remove_emulation_prevention(rec.nal_units_of_type(34)[0][2:]))
    tid = heif.item_ids_referencing(heif.primary_item_id(), "dimg")[0]
    parsed = sl.parse_slice_header(
        sl.split_length_prefixed_nals(r.get_item_data(tid), 4)[0], sps, pps)
    return bytes(parsed.rbsp), trace_tile(sps, pps, parsed)


def _truncate(s: TraceSegment, k: int) -> TraceSegment:
    t = TraceSegment(byte_start=s.byte_start, byte_end=s.byte_end)
    t.p0, t.mps0 = s.p0, s.mps0
    t.kinds, t.slots, t.bins = s.kinds[:k], s.slots[:k], s.bins[:k]
    t.positions = s.positions[:k]
    return t


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


# --------------------------------------------------------------------------
# tables and the numpy copies
# --------------------------------------------------------------------------


def _jax_tables():
    return {
        "tbl": PC._TBL,
        "tbl_win": np.asarray(PC._tbl_device_packed())[:, 0],
        "sb_fwd": PG._SB_FWD, "sb_inv": PG._SB_INV,
        "co_fwd": PG._CO_FWD, "co_inv": PG._CO_INV,
        "sig4": np.asarray([PG._SIG4_LO, PG._SIG4_HI], np.int32),
    }


def test_cabac_tables_match_heif_tpu():
    np.testing.assert_array_equal(PC._TBL, PG._TBL)
    built = CabacTables.build()
    ref = CabacTables.from_numpy(_jax_tables())
    for name, shape in CABAC_SHAPES.items():
        a, b = getattr(built, name), getattr(ref, name)
        assert a.dtype == torch.int32 and tuple(a.shape) == shape
        assert torch.equal(a, b), name


def test_cabac_tables_refuse_bad_input():
    d = _jax_tables()
    with pytest.raises(ValueError, match="shape"):
        CabacTables.from_numpy({**d, "tbl": d["tbl"][:255]})
    del d["sig4"]
    with pytest.raises(ValueError, match="missing"):
        CabacTables.from_numpy(d)


def test_pack_ctx4_copy_matches():
    rng = np.random.default_rng(4)
    c0 = (rng.integers(0, 63, (C.N_CTX, C.LANES))
          | (rng.integers(0, 2, (C.N_CTX, C.LANES)) << 6)).astype(np.int32)
    packed = C._pack_ctx4(c0)
    np.testing.assert_array_equal(packed, PC._pack_ctx4(c0))
    np.testing.assert_array_equal(C._unpack_ctx4(packed), PC._unpack_ctx4(packed))
    np.testing.assert_array_equal(C._unpack_ctx4(packed), c0)


@pytest.mark.parametrize("k", [128, None])
def test_pack_segments_copy_matches(traced, k):
    rbsp, segs = traced
    segs = segs if k is None else [_truncate(s, k) for s in segs]
    for a, b in zip(C.pack_segments(rbsp, segs), PC.pack_segments(rbsp, segs)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_pack_sorted_batches_copy_matches(traced):
    rbsp, segs = traced
    entries = [(rbsp, _truncate(s, 40 + 7 * i)) for i, s in enumerate(segs)]
    got = C.pack_sorted_batches(entries, blk=32)
    want = PC.pack_sorted_batches(entries, blk=32)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _assert_same(a, b)


def test_pack_windowed_batch_copy_matches(traced):
    rbsp, segs = traced
    batch = [(rbsp, _truncate(s, 256)) for s in segs]
    _assert_same(C.pack_windowed_batch(batch, blk=64),
                 PC.pack_windowed_batch(batch, blk=64))


# --------------------------------------------------------------------------
# the plain engines vs the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------


def test_replay_plain_matches_pallas(traced):
    """128-bin prefixes of tile 0's 16 streams: whole bin and state planes
    (pad lanes included) and the per-segment results."""
    rbsp, segs = traced
    trunc = [_truncate(s, 128) for s in segs]
    words, c0, kinds, slots = C.pack_segments(rbsp, trunc)
    bins, state = C.cabac_replay_batch(words, c0, kinds, slots, blk=128,
                                        device="cpu")
    jbins, jstate = PC.cabac_replay_batch(words, c0, kinds, slots, blk=128,
                                          interpret=True)
    np.testing.assert_array_equal(bins, jbins)
    np.testing.assert_array_equal(state, jstate)
    got = C.replay_segments(rbsp, trunc, blk=128, device="cpu")
    want = PC.replay_segments(rbsp, trunc, interpret=True, blk=128)
    for i, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f"segment {i}")
        np.testing.assert_array_equal(g[0], trunc[i].bins)


def test_replay_batches_two_batches_match_pallas(traced):
    """B=2 lane batches in one launch: each re-initialises its own engine
    and contexts; planes equal the Pallas kernel's."""
    rbsp, segs = traced
    segs = [_truncate(s, 128) for s in segs]
    words, c0, kinds, slots = C.pack_segments(rbsp, segs)
    kinds2 = kinds.copy()
    kinds2[64:, :] = KIND_PAD  # the second batch stops early
    args = (np.stack([words, words]), np.stack([c0, c0]),
            np.stack([kinds, kinds2]), np.stack([slots, slots]))
    bins, state = C.cabac_replay_batches(*args, blk=128, device="cpu")
    jbins, jstate = PC.cabac_replay_batches(*args, blk=128, interpret=True)
    np.testing.assert_array_equal(bins, jbins)
    np.testing.assert_array_equal(state, jstate)
    np.testing.assert_array_equal(bins[0, :64], bins[1, :64])
    assert not np.array_equal(state[0], state[1])


def test_replay_image_input_order(traced):
    """Length-sorted lane batches: per-entry results come back in input
    order, equal to the Pallas path's and the golden bins."""
    rbsp, segs = traced
    entries = [(rbsp, _truncate(s, 40 + 3 * i)) for i, s in enumerate(segs)]
    entries = entries[::-1]  # sorting must permute
    got = C.replay_image(entries, blk=32, device="cpu")
    want = PC.replay_image(entries, blk=32, interpret=True)
    for (_, t), g, w in zip(entries, got, want):
        np.testing.assert_array_equal(g[0], t.bins)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_replay_windowed_plain_matches_pallas(traced):
    """256-bin prefixes, 64-bin blocks (3 re-anchors per lane)."""
    rbsp, segs = traced
    batch = [(rbsp, _truncate(s, 256)) for s in segs]
    bins, state = C.replay_windowed_batch(batch, blk=64, device="cpu")
    jbins, jstate = PC.replay_windowed_batch(batch, blk=64, interpret=True)
    np.testing.assert_array_equal(bins, jbins)
    np.testing.assert_array_equal(state, jstate)
    for i, (_, t) in enumerate(batch):
        np.testing.assert_array_equal(bins[: t.n_bins, i].astype(np.uint8),
                                      t.bins)


def test_replay_windowed_image_batches_match_pallas(traced):
    """Two stacked lane batches of different lengths and window sizes, in
    input order: each lane equals the Pallas windowed kernel's run of its
    own batch."""
    rbsp, segs = traced
    short = [(rbsp, _truncate(s, 64)) for s in segs]
    long = [(rbsp, _truncate(s, 192)) for s in segs]
    entries = (long * 4 + short * 5)[::-1]  # 144 streams: two batches
    got = C.replay_windowed_image(entries, blk=64, device="cpu")
    for batch in (short, long):
        bins, state = PC.replay_windowed_batch(batch, blk=64, interpret=True)
        for lane, e in enumerate(batch):
            for i in (i for i, x in enumerate(entries) if x is e):
                np.testing.assert_array_equal(
                    got[i][0], bins[: e[1].n_bins, lane].astype(np.uint8))
                np.testing.assert_array_equal(got[i][0], e[1].bins)
                np.testing.assert_array_equal(got[i][1], state[:, lane] & 63)
                np.testing.assert_array_equal(got[i][2], state[:, lane] >> 6)


@pytest.mark.parametrize("case", F.CASES + (F.LONG_REPLAY,))
def test_replay_plain_matches_pallas_on_fuzz(case):
    """The seeded contract inputs the card tests hold the kernel to
    (utils.cabac_fuzz): ragged lanes, KIND_PAD and other kinds mid-tape,
    slots outside [0, 136), reads past the words (the long case: after
    reading through 100 words). The plain replay (the card tests' oracle)
    equals the Pallas kernel on them."""
    words, c0, kinds, slots = F.replay_inputs(*case)
    S = case[2]
    mid = kinds[:, : S // 2]
    assert (mid == KIND_PAD).any() and ((mid < 0) | (mid > KIND_PAD)).any()
    assert ((slots < 0) | (slots >= C.N_CTX)).any()
    bins, state = C.cabac_replay_batches(words, c0, kinds, slots, blk=S,
                                         device="cpu")
    jbins, jstate = PC.cabac_replay_batches(words, c0, kinds, slots, blk=S,
                                            interpret=True)
    np.testing.assert_array_equal(bins, jbins)
    np.testing.assert_array_equal(state, jstate)


def _final_word_index(case) -> np.ndarray:
    """Each fuzz lane's word index after its tape: replay_plain's loop,
    reading the engine at the end."""
    words, c0, kinds, slots = (torch.from_numpy(a)
                               for a in F.replay_inputs(*case))
    tbl = C.cabac_tables_on("cpu").tbl
    w, ctx = C.to_lanes(words), C.to_lanes(c0).clone()
    ks, ss = C.to_lanes(kinds), C.to_lanes(slots)
    lane = torch.arange(w.shape[1])
    eng = C.Engine(w, torch.zeros_like(lane, dtype=torch.int32))
    for t in range(ks.shape[0]):
        c, row, ok = C.ctx_read(ctx, ss[t], lane)
        _, c_new, is_ctx = eng.decode(w, ks[t], c, *C.table_row(tbl, c, eng.rng))
        ctx[row, lane] = torch.where(is_ctx & ok, c_new, ctx[row, lane])
    return eng.wi.numpy()


def test_replay_fuzz_reads_past_the_words():
    """Many fuzz lanes consume more bits than their words hold."""
    assert int((_final_word_index(F.CASES[0]) >= 2).sum()) >= 16


def test_replay_long_fuzz_slides_past_the_words():
    """The long fuzz case reaches every side of the end of its 100 words
    through the kernel's word ring, which slides at words 53, 85, 117:
    lanes that end before the first slide, lanes whose first slide loads
    rows across the end, and lanes that slide past it twice and three
    times."""
    wi = _final_word_index(F.LONG_REPLAY)
    assert F.LONG_REPLAY[3] == 100
    for lo, hi in ((0, 53), (53, 85), (85, 117), (117, 1 << 20)):
        assert int(((wi >= lo) & (wi < hi)).sum()) >= 16, (lo, hi)


def _windowed_pallas(args):
    """heif_tpu's Pallas windowed kernel in interpret mode on [B, ...]
    numpy inputs of utils.cabac_fuzz.windowed_inputs, one batch a call."""
    windows, biw0, c0p, kinds, slots = args
    B, nb, w_blk = windows.shape[:3]
    call = PC._windowed_call(nb, w_blk, kinds.shape[1] // nb, True)
    outs = [call(PC._tbl_device_packed(), windows[b][None],
                 biw0[b][None, :, None], c0p[b][None], kinds[b][None],
                 slots[b][None]) for b in range(B)]
    return tuple(np.concatenate([np.asarray(o[i]) for o in outs])
                 for i in range(2))


@pytest.mark.parametrize("case", F.WINDOWED_CASES)
def test_replay_windowed_plain_matches_pallas_on_fuzz(case):
    """The windowed replay's seeded contract inputs (utils.cabac_fuzz):
    packed context bytes with bit 7 set, ragged lanes, KIND_PAD and other
    kinds mid-tape, slots outside [0, 136) (136-139 included), windows
    read past their end, blk not a multiple of 32 or long enough to slide
    the kernel's word ring inside a window. The plain version (the card
    tests' oracle) equals the Pallas kernel on them, bins and packed state
    at tolerance 0."""
    args = F.windowed_inputs(*case)
    _, _, c0p, kinds, slots = args
    mid = kinds[:, : kinds.shape[1] // 2]
    assert (mid == KIND_PAD).any() and ((mid < 0) | (mid > KIND_PAD)).any()
    assert (slots < 0).any() and ((slots >= C.N_CTX) & (slots < C.N_CTX + 4)).any()
    assert int(np.count_nonzero(c0p & np.int32(-0x7F7F7F80))) > c0p.size // 2
    bins, state = C.replay_windowed(*(torch.from_numpy(a) for a in args))
    jbins, jstate = _windowed_pallas(args)
    np.testing.assert_array_equal(bins.numpy(), jbins)
    np.testing.assert_array_equal(state.numpy(), jstate)


def test_replay_windowed_plain_keeps_bit7():
    """Bit 7 of every packed context byte passes through, as in the Pallas
    kernel: a context write changes only the byte's low 7 bits."""
    args = F.windowed_inputs(*F.WINDOWED_CASES[0])
    c0p = args[2]
    _, state = C.replay_windowed(*(torch.from_numpy(a) for a in args))
    state = state.numpy()
    hi = np.int32(-0x7F7F7F80)  # 0x80808080
    np.testing.assert_array_equal(state & hi, c0p & hi)
    assert int(np.count_nonzero(c0p & hi)) > c0p.size // 2
    # and the low bits were written: contexts moved in many words
    assert int(np.count_nonzero((state ^ c0p) & ~hi)) > c0p.size // 4


def _windowed_word_index(case) -> np.ndarray:
    """[nb*blk, lanes] word index of each fuzz lane after each step:
    replay_windowed_plain's loop, reading the engine at every step."""
    windows, biw0, c0p, kinds, slots = (torch.from_numpy(a)
                                        for a in F.windowed_inputs(*case))
    nb, blk = windows.shape[1], kinds.shape[1] // windows.shape[1]
    tw = C.cabac_tables_on("cpu").tbl_win
    ctx = C.to_lanes(c0p).clone()
    ks, ss = C.to_lanes(kinds), C.to_lanes(slots)
    lane = torch.arange(ctx.shape[1])
    out = []
    for k in range(nb):
        win = C.to_lanes(windows[:, k])
        biw = C.to_lanes(biw0[:, k : k + 1])[0]
        if k == 0:
            eng = C.Engine(win, biw)
        else:
            eng.rebase(win, biw)
        for t in range(k * blk, (k + 1) * blk):
            cword, row, ok = C.ctx_read(ctx, C.srl(ss[t], 2), lane)
            csh = (ss[t] & 3) << 3
            c = C.srl(cword, csh) & 127
            q = C.srl(eng.rng, 6) & 3
            ta, tb = tw[(c & 63).long()], tw[(64 + (c & 63)).long()]
            _, c_new, is_ctx = eng.decode(win, ks[t], c, C.srl(ta, q << 3) & 255,
                                          tb & 255, C.srl(tb, 8) & 255)
            word = (cword & ~(127 << csh)) | (c_new << csh)
            ctx[row, lane] = torch.where(is_ctx & ok, word, ctx[row, lane])
            out.append(eng.wi.numpy().copy())
    return np.stack(out)


def test_windowed_fuzz_reads_past_windows_and_slides_the_ring():
    """Lanes of every windowed fuzz case read past their window's w_blk
    words (the masked fetch reads 0 there). In the long case the kernel's
    64-row word ring slides inside a window (a 32-step block that may read
    word 64 starts at word 53 or later) for many lanes over random words
    and for every fast lane, more than once."""
    for case in F.WINDOWED_CASES:
        wi = _windowed_word_index(case)
        assert int((wi.max(0) + 1 >= case[4]).sum()) >= 16, case
    case = F.WINDOWED_CASES[2]
    blk = case[3]
    wi = _windowed_word_index(case)
    # the word index before each 32-step block inside a window, blocks
    # that start a window left out
    inner = [t for t in range(32, wi.shape[0], 32) if t % blk]
    before = wi[np.asarray(inner) - 1]
    slid = (before >= 53).any(0)
    slow = np.ones(wi.shape[1], bool)
    slow[F.FAST] = False
    assert int((slid & slow).sum()) >= 16
    assert (before[:, F.FAST] >= 85).any(0).all()


def test_longest_lane_counts(traced):
    rbsp, segs = traced
    entries = [(rbsp, _truncate(s, 40 + 3 * i)) for i, s in enumerate(segs)]
    assert C.longest_lane(entries) == 40 + 3 * 15
    packed = C.pack_sorted_batches(entries, blk=32)
    assert C.longest_lane(entries) == max(
        int((b["kinds"] != KIND_PAD).sum(0).max()) for b in packed)
    # the bytes a replay of them must move: each lane's steps (kind,
    # slot, bin), its state in and out, and the stream bytes it consumes
    want = sum(12 * s.n_bins + 2 * 4 * C.N_CTX + C.stream_bytes(s, s.n_bins)
               for _, s in entries)
    assert C.replay_bytes(entries, C.N_CTX) == want
    assert C.replay_bytes(entries, C.N_CTXP, blk=64) == want - sum(
        2 * 4 * (C.N_CTX - C.N_CTXP) - 4 * -(-s.n_bins // 64)
        for _, s in entries)


# --------------------------------------------------------------------------
# full streams vs the trace golden (no JAX)
# --------------------------------------------------------------------------


def test_replay_plain_full_tile_matches_golden(traced):
    rbsp, segs = traced
    for i, (bins, p_f, mps_f) in enumerate(C.replay_segments(rbsp, segs, device="cpu")):
        np.testing.assert_array_equal(bins, segs[i].bins, err_msg=f"seg {i}")
        np.testing.assert_array_equal(p_f, segs[i].p_final)
        np.testing.assert_array_equal(mps_f, segs[i].mps_final)


def test_replay_windowed_plain_full_tile_matches_golden(traced):
    rbsp, segs = traced
    bins, state = C.replay_windowed_batch([(rbsp, s) for s in segs], blk=256,
                                          device="cpu")
    for i, s in enumerate(segs):
        np.testing.assert_array_equal(bins[: s.n_bins, i].astype(np.uint8),
                                      s.bins, err_msg=f"seg {i}")
        np.testing.assert_array_equal(state[:, i] & 63, s.p_final)
        np.testing.assert_array_equal(state[:, i] >> 6, s.mps_final)


def test_wrappers_check_their_inputs():
    w = torch.zeros((1, 8, C.LANES), dtype=torch.int32)
    c0 = torch.zeros((1, C.N_CTX, C.LANES), dtype=torch.int32)
    k = torch.full((1, 4, C.LANES), KIND_PAD, dtype=torch.int32)
    bins, state = C.replay(w, c0, k, torch.zeros_like(k))
    assert bins.shape == k.shape and torch.equal(state, c0)
    with pytest.raises(TypeError):
        C.replay(w.long(), c0, k, k)
    with pytest.raises(ValueError, match="shape"):
        C.replay(w, c0[:, :100], k, k)
    with pytest.raises(ValueError, match="contiguous"):
        C.replay(w, c0, k, torch.zeros((1, C.LANES, 4), dtype=torch.int32).mT)
    with pytest.raises(ValueError, match="blocks"):
        C.replay_windowed(torch.zeros((1, 2, 8, C.LANES), dtype=torch.int32),
                          torch.zeros((1, 2, C.LANES), dtype=torch.int32),
                          c0[:, : C.N_CTXP], k[:, :3], k[:, :3] * 0)


def test_srl_is_logical_and_xla_bounded():
    x = torch.tensor([-1, -(1 << 31), 5, 1 << 30], dtype=torch.int32)
    np.testing.assert_array_equal(C.srl(x, 28).numpy(), [15, 8, 0, 4])
    n = torch.tensor([32, 0, -1, 30], dtype=torch.int32)
    np.testing.assert_array_equal(C.srl(x, n).numpy(), [0, -(1 << 31), 0, 1])
    np.testing.assert_array_equal(C.shl(x, n).numpy(), [0, -(1 << 31), 0, 0])


def test_device_timing_refuses_the_cpu(traced):
    """The bench entry points time with CUDA events: no CPU numbers."""
    rbsp, segs = traced
    seg = _truncate(segs[0], 8)
    with pytest.raises(ValueError, match="CUDA"):
        C.bench_device_entropy([(rbsp, seg)], device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        C.bench_replay_device(*C.pack_segments(rbsp, [seg]), device="cpu")


# --------------------------------------------------------------------------
# on a card: the kernels vs the plain versions
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replay_kernels_match_plain_on_card(traced, cuda):
    rbsp, segs = traced
    words, c0, kinds, slots = C.pack_segments(rbsp, segs)
    args = [torch.from_numpy(a[None].copy()).to(cuda)
            for a in (words, c0, kinds, slots)]
    for a, b in zip(C.replay(*args), C.replay_plain(*args)):
        assert torch.equal(a, b)
    p = C.pack_windowed_batch([(rbsp, s) for s in segs], blk=256)
    wargs = C.windowed_inputs(p, cuda)
    for a, b in zip(C.replay_windowed(*wargs), C.replay_windowed_plain(*wargs)):
        assert torch.equal(a, b)
