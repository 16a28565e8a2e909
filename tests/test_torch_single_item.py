"""Single-item pictures and the native entropy pool's counters, on the CPU.

- tests/assets/single/crop384x256.heic is a single-item HEIC as libheif's
  heif-enc writes it (its x265 plugin at quality 50, made by
  `python3 -m portbench.make_single12mp`): one hvc1 primary item, no
  grid, no irot, one 384x256 picture of 6x4 CTBs of 64 with WPP.
  HeicDecoder.decode(device="cpu") equals the benchmark's frozen
  pure-Python reference (portbench.reference) sample for sample.
- DecodeStats.counters, on decode() and on decode_burst: entropy_tasks
  is the pool's tasks, one a tile (1 for a single item, the tile count
  for a grid); entropy_busy_s is positive and no more than the tasks
  times the entropy span; entropy_bins is the sum of the tiles' native
  bin counts.
- The native decoder's bin count (SyntaxTensors.n_bins: decision, bypass
  and terminate bins) equals the bins the Python twin decodes on the same
  stream (cabac.trace.trace_tile), on WPP, plain, tiled, PCM, Main 10 and
  4:0:0 streams.

This file imports no JAX.
"""

from pathlib import Path

import numpy as np
import pytest

from heif_tpu_torch import HeicDecoder, native
from heif_tpu_torch.cabac.trace import trace_tile
from heif_tpu_torch.ops import batch as B
from heif_tpu_torch.tools import image_slices
from heif_tpu_torch.utils import hevc_synth
from heif_tpu_torch.utils.heif_mux import mux_heic
from heif_tpu_torch.utils.profiling import DecodeStats

ROOT = Path(__file__).resolve().parents[1]
SINGLE = ROOT / "tests" / "assets" / "single" / "crop384x256.heic"
FIXTURES = ROOT / "tests" / "assets" / "torch"


def grid_irot() -> bytes:
    streams = [(FIXTURES / f"grid_{i}.hevc").read_bytes() for i in range(4)]
    return mux_heic(streams, grid=(2, 2, 2 * 96 - 8, 2 * 64 - 6), irot=1)


def pcm_stream() -> bytes:
    rng = np.random.default_rng(3)
    y = rng.integers(0, 256, (64, 96)).astype(np.uint8)
    cb = rng.integers(0, 256, (32, 48)).astype(np.uint8)
    cr = rng.integers(0, 256, (32, 48)).astype(np.uint8)
    return hevc_synth.synthesize_pcm_stream(y, cb, cr)


PICTURES = {
    "single": SINGLE.read_bytes,
    "grid": grid_irot,
}
STREAMS = {
    "single_wpp": SINGLE.read_bytes,
    **{k: (lambda k=k: mux_heic([(FIXTURES / f"{k}.hevc").read_bytes()]))
       for k in ("8bit", "main10", "mono", "edge40x200_wpp", "edge72",
                 "grid_0")},
    "tiles": lambda: mux_heic([hevc_synth.synthesize_tiled_intra_stream(
        96, 64, (2, 2), seed=3)]),
    "pcm": lambda: mux_heic([pcm_stream()]),
}


def test_single_item_decodes_as_the_reference():
    from portbench.judge import Reference

    data = SINGLE.read_bytes()
    sps, pps, slices, _ = image_slices(data)
    assert len(slices) == 1
    assert (sps.pic_width_in_luma_samples, sps.pic_height_in_luma_samples,
            sps.ctb_log2_size_y) == (384, 256, 6)
    assert (sps.pic_width_in_ctbs_y, sps.pic_height_in_ctbs_y) == (6, 4)
    assert pps.entropy_coding_sync_enabled_flag and not pps.tiles_enabled_flag
    assert len(slices[0].substream_ranges()) == 4
    got = HeicDecoder.decode(data, device="cpu")
    want = Reference([data], processes=1).image(0)
    for c in ("Y", "Cb", "Cr"):
        assert got[c].shape == want[c].shape
        assert got[c].dtype == np.uint8
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)


@pytest.mark.parametrize("route", ["decode", "burst"])
@pytest.mark.parametrize("picture", sorted(PICTURES))
def test_entropy_counters(route, picture):
    data = PICTURES[picture]()
    sps, pps, slices, _ = image_slices(data)
    stats = DecodeStats()
    if route == "decode":
        HeicDecoder.decode(data, device="cpu", stats=stats)
    else:
        B.decode_burst(sps, pps, [slices], stats=stats, device="cpu")
    c = stats.counters
    assert c["entropy_tasks"] == len(slices) == (1 if picture == "single"
                                                 else 4)
    assert 0 < c["entropy_busy_s"] <= c["entropy_tasks"] * \
        stats.stages["entropy"]
    bins = [native.decode_tile_native(sps, pps, ps).n_bins for ps in slices]
    assert c["entropy_bins"] == sum(bins) and min(bins) > 0


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_native_bins_equal_the_python_twin(stream):
    sps, pps, slices, _ = image_slices(STREAMS[stream]())
    ps, = slices
    want = sum(seg.n_bins for seg in trace_tile(sps, pps, ps))
    assert want > 0
    assert native.decode_tile_native(sps, pps, ps).n_bins == want
