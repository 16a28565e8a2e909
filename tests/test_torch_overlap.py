"""heif_tpu_torch bulk decode paths vs heif_tpu, tolerance 0.

- pack_batch on natively pre-packed syntaxes (pack_pad=PAD): equal to
  heif_tpu.ops.batch.pack_batch on the same syntaxes and to the port's
  own TU-table plan, field by field;
- decode_reconstruct_overlapped(device="cpu") vs heif_tpu's on three
  flagship tiles with chunk=2, readback on (stacks) and off (per-chunk
  device planes: 2 and 1 real tiles, where heif_tpu pads to 2 and 2);
- decode_burst: each image's chunks hold exactly its own tiles, equal to
  the one-batch decode;
- reconstruct_pipelined vs reconstruct_tiles (8-bit flagship, 10-bit +
  PCM synthetic);
- a small synthetic grid through more chunks than entropy workers.
"""

import dataclasses

import numpy as np
import pytest
import torch

from heif_tpu import native
from heif_tpu.container.reader import HeifReader
from heif_tpu.hevc import params
from heif_tpu.hevc import slice as sl
from heif_tpu.hevc.rbsp import remove_emulation_prevention
from heif_tpu.ops import batch as JB
from heif_tpu.utils.profiling import DecodeStats as RefDecodeStats
from heif_tpu_torch.ops import batch as TB
from heif_tpu_torch.utils.profiling import DecodeStats
from heif_tpu_torch.utils.synthetic import synthetic_batch

N_TILES = 3
STAGES = {"entropy", "entropy_wait", "pack", "dispatch", "readback"}
# the port's spans inside dispatch
PORT_STAGES = STAGES | {"h2d", "launch"}


def _parse(data: bytes, n: int | None = None):
    r = HeifReader(data)
    heif = r.read()
    rec = heif.hevc_configuration_record()
    sps = params.parse_sps(
        remove_emulation_prevention(rec.nal_units_of_type(33)[0][2:]))
    pps = params.parse_pps(
        remove_emulation_prevention(rec.nal_units_of_type(34)[0][2:]))
    tids = heif.item_ids_referencing(heif.primary_item_id(), "dimg")[:n]
    slices = [
        sl.parse_slice_header(
            sl.split_length_prefixed_nals(r.get_item_data(t), 4)[0], sps, pps)
        for t in tids
    ]
    return sps, pps, slices


@pytest.fixture(scope="module")
def flagship(halfmoonbay_bytes):
    return _parse(halfmoonbay_bytes, N_TILES)


@pytest.fixture(scope="module")
def syntaxes(flagship):
    """Entropy-decoded flagship tiles without a native pre-pack."""
    from heif_tpu.cabac.syntax import TileSyntaxDecoder

    sps, pps, slices = flagship
    if native.available():
        return native.decode_tiles_parallel(sps, pps, slices)
    return [TileSyntaxDecoder(sps, pps, ps).decode() for ps in slices]


@pytest.fixture(scope="module")
def one_batch(flagship, syntaxes):
    """The one-batch decode of the same tiles: [Y, Cb, Cr] stacks."""
    sps, pps, slices = flagship
    tiles = TB.reconstruct_tiles(syntaxes, sps, pps, slices, device="cpu")
    return [np.stack([t[c] for t in tiles]) for c in range(3)]


def _same_plan(got, want):
    for f in dataclasses.fields(JB.BatchPlan):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, dict):
            assert a.keys() == b.keys(), f.name
            pairs = [(a[k], b[k]) for k in a]
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), f.name
            pairs = list(zip(a, b))
        else:
            pairs = [(a, b)]
        for x, y in pairs:
            if isinstance(x, tuple):
                for u, v in zip(x, y):
                    assert u.dtype == v.dtype, f.name
                    np.testing.assert_array_equal(u, v, err_msg=f.name)
            elif isinstance(x, np.ndarray) or x is None:
                assert (x is None) == (y is None), f.name
                if x is not None:
                    assert x.dtype == y.dtype and x.shape == y.shape, f.name
                    np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name


@pytest.mark.parametrize("overrides", [False, True])
def test_prepacked_plan_matches_heif_tpu(flagship, overrides):
    if not native.available():
        pytest.skip("native entropy library unavailable")
    sps, pps, slices = flagship
    packed = native.decode_tiles_parallel(sps, pps, slices, pack_pad=TB.PAD)
    assert all(st.packed is not None for st in packed)
    kw = {}
    if overrides:
        n_steps, caps = JB._chunk_shapes(packed, len(packed))
        kw = {"n_steps": n_steps, "class_caps": caps}
    got = TB.pack_batch(packed, sps, pps, slices, **kw)
    _same_plan(got, JB.pack_batch(packed, sps, pps, slices, **kw))
    # the TU-table plan of the same tiles, pre-pack dropped
    for st in packed:
        st.packed = None
    _same_plan(got, TB.pack_batch(packed, sps, pps, slices, **kw))
    with pytest.raises(ValueError):
        TB.pack_batch(native.decode_tiles_parallel(
            sps, pps, slices, pack_pad=TB.PAD), sps, pps, slices,
            n_steps=[64, 64, 64])


def test_overlapped_readback_matches_heif_tpu(flagship, one_batch):
    sps, pps, slices = flagship
    stats, ref_stats = DecodeStats(), RefDecodeStats()
    got = TB.decode_reconstruct_overlapped(
        sps, pps, slices, chunk=2, stats=stats, device="cpu")
    want = JB.decode_reconstruct_overlapped(
        sps, pps, slices, chunk=2, stats=ref_stats)
    for c in range(3):
        assert got[c].dtype == np.uint8 and got[c].shape[0] == N_TILES
        np.testing.assert_array_equal(got[c], np.asarray(want[c]))
        np.testing.assert_array_equal(got[c], one_batch[c])
    assert set(stats.stages) == PORT_STAGES
    assert set(ref_stats.stages) == STAGES
    assert stats.scheduler == ref_stats.scheduler


def test_overlapped_to_device_holds_only_real_tiles(flagship, one_batch):
    sps, pps, slices = flagship
    got = TB.decode_reconstruct_overlapped(
        sps, pps, slices, chunk=2, readback=False, device="cpu")
    want = JB.decode_reconstruct_overlapped(
        sps, pps, slices, chunk=2, readback=False)
    assert [ch[0].shape[0] for ch in got] == [2, 1]
    assert [np.asarray(ch[0]).shape[0] for ch in want] == [2, 2]
    lo = 0
    for g, w in zip(got, want):
        k = g[0].shape[0]
        for c in range(3):
            assert g[c].dtype == torch.uint8 and g[c].is_contiguous()
            np.testing.assert_array_equal(g[c].numpy(), np.asarray(w[c])[:k])
            np.testing.assert_array_equal(g[c].numpy(),
                                          one_batch[c][lo : lo + k])
        lo += k


def test_burst_chunks_hold_each_images_own_tiles(flagship, one_batch):
    sps, pps, slices = flagship
    stats = DecodeStats()
    outs = TB.decode_burst(sps, pps, [slices, slices[:2]], chunk=2,
                           stats=stats, device="cpu")
    assert [[ch[0].shape[0] for ch in img] for img in outs] == [[2, 1], [2]]
    for img, n in zip(outs, (3, 2)):
        for c in range(3):
            planes = torch.cat([ch[c] for ch in img]).numpy()
            np.testing.assert_array_equal(planes, one_batch[c][:n])
    assert set(stats.stages) == PORT_STAGES - {"readback"}
    assert TB.decode_burst(sps, pps, [], device="cpu") == []


@pytest.mark.parametrize("chunk", [2, 12])
def test_reconstruct_pipelined_matches_reconstruct_tiles(
        flagship, syntaxes, one_batch, chunk):
    sps, pps, slices = flagship
    got = TB.reconstruct_pipelined(syntaxes, sps, pps, slices, chunk=chunk,
                                   device="cpu")
    for c in range(3):
        np.testing.assert_array_equal(got[c], one_batch[c])


def test_reconstruct_pipelined_10bit_pcm():
    sts, sps, pps, slices = synthetic_batch(n=3, size=64, bd=10, pcm=True,
                                            seed=5)
    got = TB.reconstruct_pipelined(sts, sps, pps, slices, chunk=2,
                                   device="cpu")
    want = TB.reconstruct_tiles(sts, sps, pps, slices, device="cpu")
    for c in range(3):
        assert got[c].dtype == np.uint16
        np.testing.assert_array_equal(got[c], np.stack([t[c] for t in want]))
    planes = TB.device_planes(TB.pack_batch(sts, sps, pps, slices), "cpu")
    assert planes[0].dtype == torch.int16


def test_small_grid_more_chunks_than_entropy_workers():
    """A 2x2 grid of tiles-enabled mixed PCM/intra pictures, one tile a
    chunk and two entropy workers: four chunks queue behind one entropy
    thread."""
    from heif_tpu.ops.ref_recon import reconstruct_tile
    from heif_tpu.cabac.syntax import TileSyntaxDecoder
    from heif_tpu.utils import hevc_synth
    from heif_tpu.utils.heif_mux import mux_heic

    streams = [hevc_synth.synthesize_tiled_intra_stream(64, 64, (2, 2),
                                                        seed=s)
               for s in range(4)]
    heic = mux_heic(streams, grid=(2, 2, 128, 128))
    sps, pps, slices = _parse(heic)
    hints = dict(TB.schedule_hints(None, sps, pps, 4), chunk=1,
                 entropy_workers=2)
    stats = DecodeStats()
    got = TB.decode_reconstruct_overlapped(sps, pps, slices, hints=hints,
                                           stats=stats, device="cpu")
    assert stats.scheduler["entropy_workers"] == 2
    for i, ps in enumerate(slices):
        gold = reconstruct_tile(TileSyntaxDecoder(sps, pps, ps).decode(),
                                sps, pps, ps.header)
        for c in range(3):
            np.testing.assert_array_equal(got[c][i], gold[c])


def test_bulk_paths_refuse_bad_input(flagship):
    sps, pps, slices = flagship
    with pytest.raises(ValueError):
        TB.decode_reconstruct_overlapped(sps, pps, slices, chunk=0,
                                         device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TB.decode_burst(sps, pps, [slices])
