"""heif_tpu_torch on a CUDA card, without JAX.

The host with the card has no JAX, so this file imports only torch,
numpy and heif_tpu_torch: never jax, and nothing of heif_tpu. Its
references are the port's plain PyTorch versions and its copy of the
host numpy reconstruction (ops.ref_recon). Tolerance 0 throughout.

On a card (`cuda`-marked; each skips without one):
- both intra kernels vs their plain walks on a synthetic 10-bit batch
  with PCM blocks and strong smoothing;
- the replay, windowed replay and generator kernels vs their plain
  versions on flagship tile 1's 16 WPP substreams, cut to PREFIX bins
  (replays) or steps (generator);
- the replay, windowed replay and generator kernels vs their plain
  versions on the seeded contract inputs of utils.cabac_fuzz
  (tests/test_torch_cabac.py and tests/test_torch_cabac_gen.py hold the
  plain versions against heif_tpu's Pallas kernels on the same inputs);
- decode_hevc(device="cuda") of flagship tile 1 as an Annex-B stream,
  with both entropy front ends, vs backend="ref";
- every fixture kind that the CPU tests decode, built without libx265:
  `tiles` (utils.hevc_synth.synthesize_tiled_intra_stream(96, 64, (2, 2),
  seed=3): PCM and intra CTBs in 2x2 HEVC tiles, no WPP), `pcm_window`
  (an all-PCM picture with pcm_loop_filter and a conformance window of
  (2, 1, 3, 0)), and the committed x265 streams of tests/assets/torch/
  (tests/test_torch_fixtures.py encodes them): `8bit`, `main10` (10-bit
  planes in the int16 device dtype), `mono` (4:0:0: the chroma kernel
  runs on worklists with no real step) and `grid_irot` (a 2x2 grid of
  CTB-64 tiles with irot 1), each muxed here by utils.heif_mux. Each
  decodes bit for bit equal to backend="ref" through
  HeicDecoder.decode(device="cuda") (both intra kernels launched), and
  its first stream through decode_hevc with entropy "auto" and
  "device-gen" (the generator on 10-bit residuals, 4:0:0, PCM, CTB 64
  and a stream without WPP; on `tiles` it raises NotImplementedError);
  grid_irot and main10 through decode_reconstruct_overlapped (readback
  on and off, chunk 2) and decode_burst of 2 images, equal to ref_recon
  tile by tile; `tiles` through decode(mesh_devices=1);
- the replay and windowed replay kernels vs their plain versions on the
  per-tile substreams of `tiles` (tools.bench_device_entropy
  .trace_entries), and the generator vs its plain version on
  `pcm_window`.
Anywhere: this file and every module of heif_tpu_torch import with jax
and heif_tpu made unimportable.

On the card: python -m pytest -q tests/test_torch_card.py (the card
needs no libx265: the x265 streams are committed)
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from heif_tpu_torch.cabac.trace import TraceSegment, trace_tile
from heif_tpu_torch import HeicDecoder, native
from heif_tpu_torch.ops import batch as B
from heif_tpu_torch.ops import cabac as C
from heif_tpu_torch.ops import cabac_gen as G
from heif_tpu_torch.ops import intra as I
from heif_tpu_torch.ops.ref_recon import reconstruct_tile
from heif_tpu_torch.tools import bench_device_entropy as BDE
from heif_tpu_torch.tools import image_slices
from heif_tpu_torch.utils import cabac_fuzz as F
from heif_tpu_torch.utils import hevc_synth
from heif_tpu_torch.utils.annexb import tile_annexb
from heif_tpu_torch.utils.heif_mux import mux_heic
from heif_tpu_torch.utils.synthetic import synthetic_batch

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "assets" / "torch"
KINDS = ["tiles", "pcm_window", "8bit", "main10", "mono", "grid_irot"]
TILE = 1  # flagship tile (grid order) of the CABAC and decode tests
PREFIX = 512  # bins (replays) / steps (generator) of the plain comparison


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tile_traces(cuda, halfmoonbay_bytes):
    """Flagship tile TILE: rbsp, its trace segments and its generator
    entries (rbsp, seg, envelope_tape, n_steps, spans)."""
    sps, pps, slices, _ = image_slices(halfmoonbay_bytes)
    ps = slices[TILE]
    entries, _ = G.envelope_entries(sps, pps, ps)
    return bytes(ps.rbsp), trace_tile(sps, pps, ps), entries


def _prefix(seg, k: int) -> TraceSegment:
    t = TraceSegment(byte_start=seg.byte_start, byte_end=seg.byte_end)
    t.p0, t.mps0 = seg.p0, seg.mps0
    t.kinds, t.slots, t.bins = seg.kinds[:k], seg.slots[:k], seg.bins[:k]
    t.positions = seg.positions[:k]
    return t


def _same(got, want):
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.cuda
def test_intra_kernels_match_plain_walks(cuda):
    bp = B.pack_batch(*synthetic_batch(n=4, size=128, bd=10, pcm=True,
                                       strong_smoothing=True, seed=7))
    d = B.plan_to_device(bp, cuda)
    res = B.residual_planes(d, bp, cuda)
    srcs = B.source_tables(d, bp)
    steps, counts, pcm, sch = d["steps"], d["counts"], d["pcm"], d["schedules"]
    luma = dict(h=bp.height, w=bp.width, strong_smoothing=bp.strong_smoothing,
                bd=bp.bit_depth_y)
    chroma = dict(h=bp.height // 2, w=bp.width // 2, bd=bp.bit_depth_c)
    luma_args = (res[0], steps[0], srcs[0], counts[0], pcm[0])
    chroma_args = (res[1], res[2], steps[1], srcs[1], counts[1], pcm[1], pcm[2])
    I.reset_launches()
    got = (I.intra_scan_luma(*luma_args, schedule=sch[0], **luma),
           *I.intra_scan_chroma2(*chroma_args, schedule=sch[1], **chroma))
    assert I.LAUNCHES == {"luma": 1, "chroma": 1}
    want = (I.luma_plain(*luma_args, **luma),
            *I.chroma2_plain(*chroma_args, **chroma))
    torch.cuda.synchronize()
    _same(got, want)


@pytest.mark.cuda
def test_replay_kernels_match_plain(cuda, tile_traces):
    rbsp, segs, _ = tile_traces
    cut = [_prefix(s, PREFIX) for s in segs]
    args = [C.as_tensor(a[None], cuda) for a in C.pack_segments(rbsp, cut)]
    C.reset_launches()
    got = C.replay(*args)
    assert C.LAUNCHES["replay"] == 1
    _same(got, C.replay_plain(*args))
    wargs = C.windowed_inputs(
        C.pack_windowed_batch([(rbsp, s) for s in cut], blk=256), cuda)
    got = C.replay_windowed(*wargs)
    assert C.LAUNCHES["windowed"] == 1
    _same(got, C.replay_windowed_plain(*wargs))


@pytest.mark.cuda
def test_gen_kernel_matches_plain(cuda, tile_traces):
    lanes = [(rb, s, t, min(ns, PREFIX)) for rb, s, t, ns, _ in tile_traces[2]]
    p = G.pack_gen_batch(lanes)
    args = [C.as_tensor(p[k][None], cuda) for k in ("words", "tape", "c0")]
    G.reset_launches()
    got = G.gen(*args, p["S_steps"], debug=True)
    assert G.LAUNCHES["gen"] == 1
    _same(got, G.gen_plain(*args, p["S_steps"], debug=True))


@pytest.mark.cuda
@pytest.mark.parametrize("case", F.CASES)
def test_cabac_kernels_match_plain_on_fuzz(cuda, case):
    """The seeded contract inputs of utils.cabac_fuzz: ragged lanes,
    KIND_PAD and unknown kinds mid-tape, slots outside [0, 136), reads
    past the words (replay); TU descriptors of every kind and lanes that
    finish at very different steps (generator)."""
    S = case[2]
    rargs = [C.as_tensor(a, cuda) for a in F.replay_inputs(*case)]
    gargs = [C.as_tensor(a, cuda) for a in F.gen_inputs(*case)]
    C.reset_launches()
    G.reset_launches()
    _same(C.replay(*rargs), C.replay_plain(*rargs))
    _same(G.gen(*gargs, S, debug=True), G.gen_plain(*gargs, S, debug=True))
    assert C.LAUNCHES["replay"] == 1 and G.LAUNCHES["gen"] == 1


@pytest.mark.cuda
def test_replay_kernel_matches_plain_on_long_fuzz(cuda):
    """utils.cabac_fuzz.LONG_REPLAY: lanes read through their 100 words
    and past them, so the kernel's word ring slides across the end of the
    words and beyond it."""
    args = [C.as_tensor(a, cuda) for a in F.replay_inputs(*F.LONG_REPLAY)]
    C.reset_launches()
    _same(C.replay(*args), C.replay_plain(*args))
    assert C.LAUNCHES["replay"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", F.WINDOWED_CASES)
def test_windowed_kernel_matches_plain_on_fuzz(cuda, case):
    """utils.cabac_fuzz.WINDOWED_CASES: packed context bytes with bit 7
    set, ragged lanes, KIND_PAD and unknown kinds mid-tape, slots outside
    [0, 136) (136-139 included), windows read past their end, window ends
    inside the kernel's 32-step blocks, its word ring slid inside a
    window."""
    args = [C.as_tensor(a, cuda) for a in F.windowed_inputs(*case)]
    C.reset_launches()
    bins, state = C.replay_windowed(*args)
    assert C.LAUNCHES["windowed"] == 1
    pbins, pstate = C.replay_windowed_plain(*args)
    assert torch.equal(bins, pbins)
    diff = state ^ pstate
    bad = int(torch.count_nonzero(diff))
    low = int(torch.count_nonzero(diff & 0x7F7F7F7F))
    assert not bad, (f"{bad} of {diff.numel()} packed state words differ, "
                     f"{low} of them outside bit 7 of their bytes")


@pytest.mark.cuda
@pytest.mark.parametrize("entropy", ["auto", "device-gen"])
def test_decode_hevc_on_card_equals_ref(cuda, halfmoonbay_bytes, entropy):
    stream = tile_annexb(halfmoonbay_bytes, TILE)
    I.reset_launches()
    got = HeicDecoder.decode_hevc(stream, entropy=entropy, device=cuda)
    assert I.LAUNCHES == {"luma": 1, "chroma": 1}
    want = HeicDecoder.decode_hevc(stream, backend="ref", device=cuda)
    for k in ("Y", "Cb", "Cr"):
        assert got[k].dtype == want[k].dtype == np.uint8, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _streams(kind: str) -> list:
    """The Annex-B streams of a fixture kind: one, or four for grid_irot.
    The planes and seeds are test_torch_decode.py's _container's."""
    if kind == "tiles":
        return [hevc_synth.synthesize_tiled_intra_stream(96, 64, (2, 2),
                                                          seed=3)]
    if kind == "pcm_window":
        rng = np.random.default_rng(len(kind))
        y = rng.integers(0, 256, (64, 96)).astype(np.uint8)
        cb = rng.integers(0, 256, (32, 48)).astype(np.uint8)
        cr = rng.integers(0, 256, (32, 48)).astype(np.uint8)
        return [hevc_synth.synthesize_pcm_stream(y, cb, cr,
                                                 conf_win=(2, 1, 3, 0))]
    if kind == "grid_irot":
        return [(FIXTURES / f"grid_{i}.hevc").read_bytes() for i in range(4)]
    return [(FIXTURES / f"{kind}.hevc").read_bytes()]


def _container(kind: str) -> bytes:
    streams = _streams(kind)
    if kind == "grid_irot":
        return mux_heic(streams, grid=(2, 2, 2 * 96 - 8, 2 * 64 - 6), irot=1)
    return mux_heic(streams)


def _same_planes(got, want, kind):
    for k in ("Y", "Cb", "Cr"):
        if k != "Y" and kind == "mono":
            assert got[k] is None and want[k] is None, k
            continue
        dt = np.uint16 if kind == "main10" else np.uint8
        assert got[k].dtype == want[k].dtype == dt, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_decode_fixture_on_card_equals_ref(cuda, kind):
    heic = _container(kind)
    I.reset_launches()
    got = HeicDecoder.decode(heic, device=cuda)
    assert I.LAUNCHES == {"luma": 1, "chroma": 1}
    want = HeicDecoder.decode(heic, backend="ref", device=cuda)
    assert got["info"] == want["info"]
    _same_planes(got, want, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("entropy", ["auto", "device-gen"])
@pytest.mark.parametrize("kind", KINDS)
def test_decode_hevc_fixture_on_card_equals_ref(cuda, kind, entropy):
    stream = _streams(kind)[0]
    if kind == "tiles" and entropy == "device-gen":
        with pytest.raises(NotImplementedError, match="tile"):
            HeicDecoder.decode_hevc(stream, entropy=entropy, device=cuda)
        return
    I.reset_launches()
    G.reset_launches()
    got = HeicDecoder.decode_hevc(stream, entropy=entropy, device=cuda)
    assert I.LAUNCHES == {"luma": 1, "chroma": 1}
    assert G.LAUNCHES["gen"] == (entropy == "device-gen")
    want = HeicDecoder.decode_hevc(stream, backend="ref", device=cuda)
    _same_planes(got, want, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["grid_irot", "main10"])
def test_bulk_paths_on_fixture_equal_ref_recon(cuda, kind):
    """The overlapped decode with readback and to device at chunk 2, and
    a burst of 2 images, equal ref_recon tile by tile; the device planes
    (int16 above 8 bits) equal their host view."""
    sps, pps, slices, _ = image_slices(_container(kind))
    gold = [reconstruct_tile(st, sps, pps, ps.header) for st, ps in
            zip(native.decode_tiles_parallel(sps, pps, slices), slices)]
    ref = [np.stack([t[c] for t in gold]) for c in range(3)]
    dt = torch.int16 if kind == "main10" else torch.uint8

    def same(stacks):
        for c in range(3):
            assert stacks[c].dtype == ref[c].dtype and stacks[c].shape == ref[c].shape
            np.testing.assert_array_equal(stacks[c], ref[c], err_msg=str(c))

    def from_device(chunks):
        assert all(p.device.type == cuda.type and p.dtype == dt
                   for ch in chunks for p in ch)
        return [np.concatenate([B.host_view(ch[c].cpu()) for ch in chunks])
                for c in range(3)]

    I.reset_launches()
    same(B.decode_reconstruct_overlapped(sps, pps, slices, chunk=2,
                                         device=cuda))
    n_chunks = -(-len(slices) // 2)
    assert I.LAUNCHES == {"luma": n_chunks, "chroma": n_chunks}
    I.reset_launches()
    chunks = B.decode_reconstruct_overlapped(sps, pps, slices, chunk=2,
                                             readback=False, device=cuda)
    assert len(chunks) == n_chunks
    same(from_device(chunks))
    assert I.LAUNCHES == {"luma": n_chunks, "chroma": n_chunks}
    I.reset_launches()
    outs = B.decode_burst(sps, pps, [slices, list(slices)], chunk=2,
                          device=cuda)
    assert len(outs) == 2 and I.LAUNCHES["luma"] == I.LAUNCHES["chroma"] > 0
    for img in outs:
        same(from_device(img))


@pytest.mark.cuda
def test_decode_mesh1_on_tiles_equals_ref(cuda):
    heic = _container("tiles")
    I.reset_launches()
    got = HeicDecoder.decode(heic, device=cuda, mesh_devices=1)
    assert I.LAUNCHES["luma"] > 0 and I.LAUNCHES["chroma"] > 0
    _same_planes(got, HeicDecoder.decode(heic, backend="ref", device=cuda),
                 "tiles")


@pytest.mark.cuda
def test_replay_kernels_on_tile_substreams(cuda):
    """The per-tile substreams of `tiles` (PCM blocks end a substream's
    arithmetic segment, so there are more segments than tiles)."""
    entries, _, _ = BDE.trace_entries(_container("tiles"))
    assert len(entries) > 4
    for name, fn in (("replay", C.replay_image),
                     ("windowed", C.replay_windowed_image)):
        C.reset_launches()
        got = fn(entries, device=cuda)
        assert C.LAUNCHES[name] == 1, name
        want = fn(entries, device="cpu")
        for (_, seg), g, w in zip(entries, got, want):
            np.testing.assert_array_equal(g[0], seg.bins, err_msg=name)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.cuda
def test_gen_kernel_on_pcm_window(cuda):
    entries, goldens, tile_of = BDE.trace_entries(_container("pcm_window"),
                                                  gen=True)
    G.reset_launches()
    got = G.gen_image(entries, device=cuda)
    assert G.LAUNCHES["gen"] == 1
    for g, w in zip(got, G.gen_image(entries, device="cpu")):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    out = BDE.run_gen(entries, goldens, tile_of, cuda, timed=False)
    assert out["streams"] == len(entries)


def test_card_file_and_port_import_without_jax():
    """This file and every module of heif_tpu_torch import with jax and
    heif_tpu made unimportable, and pull in neither."""
    code = textwrap.dedent("""
        import importlib, importlib.util, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["heif_tpu"] = None
        spec = importlib.util.spec_from_file_location("card", sys.argv[1])
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        import heif_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            heif_tpu_torch.__path__, "heif_tpu_torch.")
            if not m.name.endswith("__main__")]
        for name in names:
            importlib.import_module(name)
        assert not [m for m in sys.modules if m.startswith(("jax.", "heif_tpu."))]
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code, __file__], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module, tools included
