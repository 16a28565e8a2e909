"""heif_tpu_torch residual request generator vs heif_tpu (bit-exact,
tolerance 0).

- the numpy copies (pack_gen_batch, pack_gen_batches, scatter_events) vs
  heif_tpu.ops.pallas_cabac_gen's;
- the plain generator (the CPU path of the kernel wrapper) vs the Pallas
  kernel in interpret mode on flagship tile 0, steps capped at 256: the
  whole event, debug and state planes;
- the plain generator vs the Pallas kernel on the seeded contract
  inputs of utils.cabac_fuzz (every phase, lanes that finish early);
  the longest-lane and byte counts that chip_smoke.py prints;
- the plain generator over tile 0 in full vs the host decoder's
  coefficient planes and final contexts (no JAX);
- the slot bases written into csrc/cabac_gen.cu vs cabac.engine;
- on a CUDA card only: the kernel vs the plain version.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from heif_tpu.cabac import engine as E
from heif_tpu.cabac.trace import KIND_PAD
from heif_tpu.cabac.envelope import KIND_TU, build_envelope_tape, envelope_trace
from heif_tpu.container.reader import HeifReader
from heif_tpu.hevc import params
from heif_tpu.hevc import slice as sl
from heif_tpu.hevc.rbsp import remove_emulation_prevention
from heif_tpu.ops import pallas_cabac_gen as PG
from heif_tpu_torch.ops import cabac as C
from heif_tpu_torch.ops import cabac_gen as G
from heif_tpu_torch.utils import cabac_fuzz as F

ROOT = Path(__file__).resolve().parents[1]
CAP = 256  # steps of the interpret-mode comparison


@pytest.fixture(scope="module")
def tile0(halfmoonbay_bytes):
    """Envelope trace and generator entries (rbsp, seg, tape, n_steps,
    spans) of flagship tile 0."""
    r = HeifReader(halfmoonbay_bytes)
    heif = r.read()
    rec = heif.hevc_configuration_record()
    sps = params.parse_sps(
        remove_emulation_prevention(rec.nal_units_of_type(33)[0][2:]))
    pps = params.parse_pps(
        remove_emulation_prevention(rec.nal_units_of_type(34)[0][2:]))
    tid = heif.item_ids_referencing(heif.primary_item_id(), "dimg")[0]
    ps = sl.parse_slice_header(
        sl.split_length_prefixed_nals(r.get_item_data(tid), 4)[0], sps, pps)
    tr = envelope_trace(sps, pps, ps)
    rbsp = bytes(ps.rbsp)
    entries = []
    for si, seg in enumerate(tr.segments):
        tape, n_steps = build_envelope_tape(tr, si)
        spans = sorted((sp for sp in tr.spans if sp.seg == si),
                       key=lambda sp: sp.b0)
        entries.append((rbsp, seg, tape, n_steps, spans))
    return tr, entries


@pytest.fixture(scope="module")
def full_run(tile0):
    """gen_image over tile 0's 16 full streams on the CPU."""
    return G.gen_image(tile0[1], device="cpu")


def test_pack_gen_batch_copy_matches(tile0):
    lanes = [e[:4] for e in tile0[1]]
    a, b = G.pack_gen_batch(lanes), PG.pack_gen_batch(lanes)
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_pack_gen_batches_copy_matches(tile0):
    entries = tile0[1] * 9  # 144 streams: two batches
    got, want = G.pack_gen_batches(entries), PG.pack_gen_batches(entries)
    assert [idx for _, idx in got] == [idx for _, idx in want]


def test_gen_plain_matches_pallas(tile0):
    """Steps capped at 256: events, debug and state planes equal the
    Pallas kernel's (interpret mode, blk 64)."""
    lanes = [(rb, s, t, min(ns, CAP)) for rb, s, t, ns, _ in tile0[1]]
    ev, state, dbg = G.run_gen_batch(lanes, blk=64, device="cpu", debug=True)
    jev, jstate = PG.run_gen_batch(lanes, blk=64, interpret=True, debug=True)
    jdbg = PG.run_gen_batch.last_dbg
    assert ev.shape == jev.shape == (CAP, G.LANES)
    np.testing.assert_array_equal(ev, jev)
    np.testing.assert_array_equal(dbg, jdbg)
    np.testing.assert_array_equal(state, jstate)
    assert (ev != 0).any() and ((ev >> 31) & 1).any()  # coefficients seen


@pytest.mark.parametrize("case", F.CASES)
def test_gen_plain_matches_pallas_on_fuzz(case):
    """The seeded contract inputs the card tests hold the kernel to
    (utils.cabac_fuzz): random TU descriptors of every legal kind, lanes
    of very different lengths. The plain generator (the card tests'
    oracle) equals the Pallas kernel (interpret mode) on the whole event,
    debug and state planes; every phase is reached, and lanes finish (a
    KIND_PAD entry in P_TAPE) at different steps before the end."""
    seed, B, S = case
    words, tape, c0 = F.gen_inputs(*case)
    ev, dbg, state = G.gen(*(torch.from_numpy(a) for a in (words, tape, c0)),
                           S, debug=True)
    blk = 64 if S % 64 == 0 else 40
    call = jax.jit(PG._gen_call(B, words.shape[1], tape.shape[1], S, blk, True))
    jev, jdbg, jstate = call(PG._tbl_device(), PG._sbtab_device(),
                             PG._cotab_device(), words, tape, c0)
    np.testing.assert_array_equal(ev.numpy(), np.asarray(jev))
    np.testing.assert_array_equal(dbg.numpy(), np.asarray(jdbg))
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
    dbg = dbg.numpy()
    # the phase of the steps whose slot leaves the debug word's other
    # fields alone (every generated request's does)
    clean = (dbg >= 0) & (dbg >> 20 == 0) & ((dbg >> 3) & 511 < C.N_CTX)
    assert set(np.unique(dbg[clean] >> 16)) == set(range(G.P_FLUSH + 1))
    # a finished lane's steps: P_TAPE, a KIND_PAD entry, slot 0
    done = (dbg & ~(1 << 12)) == KIND_PAD
    first = np.where(done.any(1), done.argmax(1), S)  # [B, 128]
    assert len(np.unique(first[first < S])) > 20 and (first == S).any()
    assert ((ev.numpy() >> 31) & 1).any()  # coefficients emitted
    descs = (tape >> 3)[(tape & 7) == KIND_TU]
    assert set(descs.tolist()) == set(F.tu_descriptors())


def test_longest_lane_and_finished_lanes(tile0, full_run):
    """G.longest_lane is the largest n_steps, and a lane's events are 0
    after its n_steps (it has finished); gen_bytes counts a debug word a
    step more with debug."""
    _, entries = tile0
    assert G.longest_lane(entries) == max(e[3] for e in entries)
    for e, (ev, _, _) in zip(entries, full_run):
        assert not ev[e[3]:].any() and ev[: e[3]].any()
    assert (G.gen_bytes(entries, debug=True) - G.gen_bytes(entries)
            == 4 * sum(e[3] for e in entries))


def test_gen_plain_full_tile_matches_host_decode(tile0, full_run):
    tr, entries = tile0
    planes = [np.zeros_like(p) for p in tr.syntax.coeffs]
    for (_, seg, _, _, spans), (ev, p_fin, mps_fin) in zip(entries, full_run):
        G.scatter_events(ev, spans, planes)
        np.testing.assert_array_equal(p_fin, seg.p_final)
        np.testing.assert_array_equal(mps_fin, seg.mps_final)
    for c in range(3):
        np.testing.assert_array_equal(planes[c], tr.syntax.coeffs[c])


def test_scatter_events_copy_matches(tile0, full_run):
    tr, entries = tile0
    got = [np.zeros_like(p) for p in tr.syntax.coeffs]
    want = [np.zeros_like(p) for p in tr.syntax.coeffs]
    for (_, _, _, _, spans), (ev, _, _) in zip(entries, full_run):
        G.scatter_events(ev, spans, got)
        PG.scatter_events(ev, spans, want)
    for c in range(3):
        np.testing.assert_array_equal(got[c], want[c])
    assert any(np.count_nonzero(p) for p in got)


def test_scatter_events_refuses_desync(tile0, full_run):
    tr, entries = tile0
    lane = max(range(len(entries)), key=lambda i: len(entries[i][4]))
    ev, spans = full_run[lane][0], entries[lane][4]
    planes = [np.zeros_like(p) for p in tr.syntax.coeffs]
    with pytest.raises(ValueError, match="TUs"):
        G.scatter_events(ev, spans[:-1], planes)
    bad = ev.copy()
    tu = np.flatnonzero(((bad >> 30) & 3) == 1)
    bad[tu[1]] ^= 1  # TU 1 tagged as TU 0
    with pytest.raises(ValueError, match="desync"):
        G.scatter_events(bad, spans, planes)


def test_gen_plain_image_batches_keep_input_order(tile0):
    """Two lane batches stacked into one launch, entries reversed and
    capped: per-entry results equal single-batch runs."""
    lanes = [(rb, s, t, min(ns, 64), sp) for rb, s, t, ns, sp in tile0[1]]
    entries = (lanes * 9)[::-1]
    got = G.gen_image(entries, blk=64, device="cpu")
    ev, state = G.run_gen_batch([e[:4] for e in lanes], blk=64, device="cpu")
    for i, e in enumerate(entries):
        lane = lanes.index(e)
        np.testing.assert_array_equal(got[i][0][: ev.shape[0]], ev[:, lane])
        np.testing.assert_array_equal(got[i][1], state[:, lane] & 63)


def test_gen_timing_refuses_the_cpu(tile0):
    lanes = [(rb, s, t, 8, sp) for rb, s, t, _, sp in tile0[1]]
    with pytest.raises(ValueError, match="CUDA"):
        G.bench_gen_image(lanes, device="cpu")


def test_kernel_slot_bases_match_engine():
    src = (ROOT / "heif_tpu_torch" / "csrc" / "cabac_gen.cu").read_text()
    found = dict(re.findall(r"constexpr int B_(\w+) = (\d+);", src))
    want = {"LASTX": "last_x", "LASTY": "last_y", "CSBF": "csbf",
            "SIG": "sig", "G1": "g1", "G2": "g2"}
    assert set(found) == set(want)
    for k, name in want.items():
        assert int(found[k]) == E.CTX_OFFSET[name], k
    assert G.NREG == PG.NREG and G.P_FLUSH == PG.P_FLUSH


@pytest.mark.cuda
def test_gen_kernel_matches_plain_on_card(tile0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    p = G.pack_gen_batch([e[:4] for e in tile0[1]])
    args = [torch.from_numpy(p[k][None].copy()).to(dev)
            for k in ("words", "tape", "c0")]
    S = p["S_steps"]
    for a, b in zip(G.gen(*args, S, debug=True),
                    G.gen_plain(*args, S, debug=True)):
        assert torch.equal(a, b)
