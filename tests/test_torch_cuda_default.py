"""The CABAC entry points run on the card unless told otherwise.

Each of the ten numpy entry points of ops.cabac and ops.cabac_gen takes
device=None, resolved by heif_tpu_torch.device.resolve_device as every
other entry point of the port: "cuda". On a host without a card a call
that names no device raises RuntimeError (nothing falls back to the CPU
silently); with device="cpu" it runs the plain version. Inputs: flagship
tile 0's substreams, cut to PREFIX bins (replays) or steps (generator).
"""

import numpy as np
import pytest
import torch

from heif_tpu_torch.cabac.trace import TraceSegment, trace_tile
from heif_tpu_torch.ops import cabac as C
from heif_tpu_torch.ops import cabac_gen as G
from heif_tpu_torch.tools import image_slices

PREFIX = 64


def _prefix(s: TraceSegment, k: int) -> TraceSegment:
    t = TraceSegment(byte_start=s.byte_start, byte_end=s.byte_end)
    t.p0, t.mps0 = s.p0, s.mps0
    t.kinds, t.slots, t.bins = s.kinds[:k], s.slots[:k], s.bins[:k]
    t.positions = s.positions[:k]
    return t


@pytest.fixture(scope="module")
def streams(halfmoonbay_bytes):
    """(rbsp, cut segments, generator lanes) of flagship tile 0."""
    sps, pps, slices, _ = image_slices(halfmoonbay_bytes)
    ps = slices[0]
    segs = [_prefix(s, PREFIX) for s in trace_tile(sps, pps, ps)]
    entries, _ = G.envelope_entries(sps, pps, ps)
    lanes = [(rb, s, t, min(ns, PREFIX), sp) for rb, s, t, ns, sp in entries]
    return bytes(ps.rbsp), segs, lanes


ENTRY_POINTS = {
    "cabac_replay_batches": lambda rb, segs, lanes, **kw: C.cabac_replay_batches(
        *(a[None] for a in C.pack_segments(rb, segs)), blk=PREFIX, **kw),
    "cabac_replay_batch": lambda rb, segs, lanes, **kw: C.cabac_replay_batch(
        *C.pack_segments(rb, segs), blk=PREFIX, **kw),
    "replay_segments": lambda rb, segs, lanes, **kw: C.replay_segments(
        rb, segs, blk=PREFIX, **kw),
    "replay_image": lambda rb, segs, lanes, **kw: C.replay_image(
        [(rb, s) for s in segs], blk=PREFIX, **kw),
    "replay_windowed_batch": lambda rb, segs, lanes, **kw: C.replay_windowed_batch(
        [(rb, s) for s in segs], blk=PREFIX, **kw),
    "windowed_image_inputs": lambda rb, segs, lanes, **kw: C.windowed_image_inputs(
        [(rb, s) for s in segs], blk=PREFIX, **kw),
    "replay_windowed_image": lambda rb, segs, lanes, **kw: C.replay_windowed_image(
        [(rb, s) for s in segs], blk=PREFIX, **kw),
    "run_gen_batch": lambda rb, segs, lanes, **kw: G.run_gen_batch(
        [e[:4] for e in lanes], blk=PREFIX, **kw),
    "image_inputs": lambda rb, segs, lanes, **kw: G.image_inputs(
        lanes, blk=PREFIX, **kw),
    "gen_image": lambda rb, segs, lanes, **kw: G.gen_image(
        lanes, blk=PREFIX, **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_cabac_entry_point_defaults_to_the_card(name, streams):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    fn = ENTRY_POINTS[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn(*streams)
    out = fn(*streams, device="cpu")
    rbsp, segs, _ = streams
    if name in ("replay_segments", "replay_image", "replay_windowed_image"):
        for (bins, _, _), s in zip(out, segs):
            np.testing.assert_array_equal(bins, s.bins)
    elif name in ("windowed_image_inputs", "image_inputs"):
        assert all(t.device.type == "cpu" for t in out[0])
    elif name == "gen_image":
        assert len(out) == len(segs)
    elif name == "run_gen_batch":
        events, state = out
        assert events.shape[1] == state.shape[1] == C.LANES
    else:
        bins = out[0][0] if name == "cabac_replay_batches" else out[0]
        for i, s in enumerate(segs):
            np.testing.assert_array_equal(bins[: s.n_bins, i], s.bins)
