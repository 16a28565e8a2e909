"""The port's last entry points vs heif_tpu (bit-exact, tolerance 0).

- HeicDecoder.decode(backend="ref") vs heif_tpu's decode(backend="ref")
  and the port's own decode(device="cpu"), on small containers; what it
  refuses (a mesh with "ref", an unknown backend, tile-clamped SAO);
- the CLI's --backend ref on decode / verify / bench, raw tile and
  container, decode held against `python -m heif_tpu decode --backend
  ref`; decode --trace;
- utils.profiling.device_trace on a CPU decode;
- the tools: tools.image_slices, bench_burst and bench_device_entropy
  (replay and --gen, checks passing on flagship tile 1 and raising on a
  flipped bin or coefficient).
"""

import copy
import dataclasses
import glob
import json

import numpy as np
import pytest

from heif_tpu.models.decoder import HeicDecoder as RefDecoder
from heif_tpu.utils.heif_mux import mux_heic
from heif_tpu_torch.utils.profiling import DecodeStats
from heif_tpu_torch import HeicDecoder
from heif_tpu_torch import cli
from heif_tpu_torch.hevc import params
from heif_tpu_torch.tools import bench_burst, image_slices
from heif_tpu_torch.tools import bench_device_entropy as BDE
from heif_tpu_torch.utils import profiling
from heif_tpu_torch.utils.annexb import tile_annexb
from test_torch_decode import _container, _x265_planes

TILE = 1  # flagship tile (grid order) of the device entropy tool tests
BURST_KEYS = {"metric", "value", "unit", "images", "megapixels_total",
              "wall_s", "per_image_s", "best_image_mp_s"}


def _same_planes(got, want):
    for k in ("Y", "Cb", "Cr"):
        if want[k] is None:
            assert got[k] is None, k
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def grid_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("grid") / "grid.heic"
    path.write_bytes(_container("grid"))
    return path


@pytest.fixture(scope="module")
def wpp_file(tmp_path_factory):
    """A 1x2 grid of smooth 32x64 x265 tiles with 16-pixel CTUs: two WPP
    substreams a tile and a few hundred bins each, so that the plain
    generator (milliseconds a step on the CPU) takes seconds."""
    from heif_tpu.utils import x265enc

    rng = np.random.default_rng(11)
    streams = []
    for _ in range(2):
        y = np.add.outer(np.arange(32), np.arange(64)) * 2
        y = (y + rng.integers(0, 8, y.shape)) % 256
        streams.append(x265enc.encode_i_frame(
            y.astype(np.uint8), np.full((16, 32), 100, np.uint8),
            np.full((16, 32), 150, np.uint8), qp=32, options={"ctu": "16"}))
    path = tmp_path_factory.mktemp("wpp") / "wpp.heic"
    path.write_bytes(mux_heic(streams, grid=(1, 2, 128, 32)))
    return path


# --------------------------------------------------------------------------
# decode(backend=)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["grid", "mono", "tiles"])
def test_decode_backend_ref_matches_heif_tpu(kind):
    heic = _container(kind)
    stats = DecodeStats()
    got = HeicDecoder.decode(heic, backend="ref", device="cpu", stats=stats)
    want = RefDecoder.decode(heic, backend="ref")
    assert dataclasses.asdict(got["info"]) == dataclasses.asdict(want["info"])
    _same_planes(got, want)
    _same_planes(HeicDecoder.decode(heic, device="cpu"), got)
    assert stats.scheduler["effective_backend"] == "ref"
    assert {"entropy", "recon", "stitch"} <= set(stats.stages)


def test_decode_records_the_torch_backend():
    stats = DecodeStats()
    HeicDecoder.decode(_container("tiles"), device="cpu", stats=stats)
    assert stats.scheduler["effective_backend"] == "torch"


def test_decode_backend_refusals():
    heic = _container("tiles")
    with pytest.raises(ValueError, match="mesh_devices"):
        HeicDecoder.decode(heic, backend="ref", device="cpu", mesh_devices=2)
    for backend in ("jax", "auto", "cuda"):
        with pytest.raises(ValueError, match="unknown backend"):
            HeicDecoder.decode(heic, backend=backend, device="cpu")


@pytest.mark.parametrize("backend", ["torch", "ref"])
def test_tile_clamped_sao_raises_at_once(halfmoonbay_bytes, backend,
                                         monkeypatch):
    """The flagship (SAO on) with its PPS made tiled without loop
    filtering across tiles: both backends refuse before any entropy."""
    parse_pps = params.parse_pps

    def clamped(rbsp):
        return dataclasses.replace(
            parse_pps(rbsp), tiles_enabled_flag=True,
            loop_filter_across_tiles_enabled_flag=False)

    monkeypatch.setattr(params, "parse_pps", clamped)
    with pytest.raises(NotImplementedError, match="tile-clamped SAO"):
        HeicDecoder.decode(halfmoonbay_bytes, backend=backend, device="cpu")


# --------------------------------------------------------------------------
# the CLI: --backend and --trace
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def raw_tile(grid_file, tmp_path_factory):
    """Tile 0 of the grid fixture as an Annex-B file."""
    path = tmp_path_factory.mktemp("raw") / "tile0.hevc"
    path.write_bytes(tile_annexb(grid_file.read_bytes(), 0))
    return path


def test_cli_decode_backend_ref_matches_heif_tpu_cli(raw_tile, grid_file,
                                                     tmp_path):
    from heif_tpu import cli as ref_cli

    for src in (raw_tile, grid_file):
        ours, theirs, torch_cpu = (tmp_path / f"{src.stem}_{n}.npz"
                                   for n in ("ours", "ref", "torch"))
        assert cli.main(["decode", str(src), "--backend", "ref", "--device",
                         "cpu", "-o", str(ours)]) == 0
        assert ref_cli.main(["decode", str(src), "--backend", "ref", "-o",
                             str(theirs)]) == 0
        assert cli.main(["decode", str(src), "--device", "cpu", "-o",
                         str(torch_cpu)]) == 0
        a, b, c = np.load(ours), np.load(theirs), np.load(torch_cpu)
        assert set(a.files) == set(b.files) == set(c.files) == {"Y", "Cb", "Cr"}
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{src} {k}")
            np.testing.assert_array_equal(c[k], b[k], err_msg=f"{src} {k}")


def test_cli_verify_and_bench_backend_ref(raw_tile, grid_file, capsys):
    for src in (raw_tile, grid_file):
        assert cli.main(["verify", str(src), "--backend", "ref",
                         "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert out.count("OK (bit-exact)") == 3, out
        assert cli.main(["bench", str(src), "--backend", "ref", "--device",
                         "cpu", "-n", "1"]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["backend"] == "ref" and line["device"] == "cpu"
        assert line["value"] > 0 and line["runs"] == 1


def test_cli_decode_raw_tile_backend_ref_with_device_gen(wpp_file, tmp_path):
    """--backend ref on raw input keeps --entropy: the generator's
    coefficients through the host reference equal the native path's."""
    src = tmp_path / "tile1.hevc"
    src.write_bytes(tile_annexb(wpp_file.read_bytes(), 1))
    a, b = tmp_path / "gen.npz", tmp_path / "auto.npz"
    for entropy, dst in (("device-gen", a), ("auto", b)):
        assert cli.main(["decode", str(src), "--backend", "ref",
                         "--entropy", entropy, "--device", "cpu", "-o",
                         str(dst)]) == 0
    ga, gb = np.load(a), np.load(b)
    for k in ("Y", "Cb", "Cr"):
        np.testing.assert_array_equal(ga[k], gb[k], err_msg=k)


def test_cli_refuses_bad_backend(grid_file, capsys):
    with pytest.raises(SystemExit):
        cli.main(["decode", str(grid_file), "--backend", "jax"])
    assert "invalid choice" in capsys.readouterr().err


def test_device_trace_writes_one_trace(grid_file, tmp_path):
    heic = grid_file.read_bytes()
    with profiling.device_trace(True, str(tmp_path), "cpu") as trace:
        assert trace.path is None
        got = HeicDecoder.decode(heic, device="cpu")
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert files == [trace.path]
    with open(trace.path) as f:
        events = json.load(f)["traceEvents"]
    assert len(events) > 0
    assert any(e.get("ph") == "X" for e in events)  # timed CPU events
    _same_planes(got, HeicDecoder.decode(heic, device="cpu"))


def test_device_trace_disabled_writes_nothing(tmp_path):
    logdir = tmp_path / "none"
    with profiling.device_trace(False, str(logdir), "cpu") as trace:
        pass
    assert trace.path is None and not logdir.exists()
    assert profiling.DEFAULT_LOGDIR == "/tmp/heif_tpu_torch_trace"


def test_cli_decode_trace(grid_file, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(profiling, "DEFAULT_LOGDIR", str(tmp_path / "tr"))
    dst = tmp_path / "x.npz"
    assert cli.main(["decode", str(grid_file), "--device", "cpu", "--trace",
                     "--stats", "-o", str(dst)]) == 0
    files = glob.glob(str(tmp_path / "tr" / "*.pt.trace.json"))
    assert len(files) == 1
    err = capsys.readouterr().err
    assert f"trace: {files[0]}" in err and "traced" in err
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"heif.total", "heif.hdr", "heif.launch", "heif.stitch"} <= names
    line = json.loads(next(ln for ln in err.splitlines()
                           if ln.startswith("{")))
    assert {"total", "hdr", "entropy", "launch", "stitch"} <= set(
        line["stages_ms"])
    assert line["total_ms"] == line["stages_ms"]["total"]
    assert line["counters"]["h2d_copies"] > 0
    want = HeicDecoder.decode(grid_file.read_bytes(), device="cpu")
    got = np.load(dst)
    for k in ("Y", "Cb", "Cr"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --------------------------------------------------------------------------
# the tools
# --------------------------------------------------------------------------


def test_image_slices_uses_hvcc_length_and_vcl_nal(halfmoonbay_bytes):
    """A prefix SEI before tile 0's slice: the slice is still found (the
    JAX tools take the first NAL). On the flagship the grid's 48 slices
    and 12.19 MP."""
    from heif_tpu.utils import x265enc

    sei = bytes([39 << 1, 1, 5, 4, 0xDE, 0xAD, 0xBE, 0xEF, 0x80])
    rng = np.random.default_rng(5)
    streams = [x265enc.encode_i_frame(*_x265_planes(rng, 64, 96), qp=30)
               for _ in range(2)]
    heic = mux_heic(streams, grid=(1, 2, 2 * 96, 64), extra_item_nals=[sei])
    sps, pps, slices, mp = image_slices(heic)
    assert len(slices) == 2 and mp == 2 * 96 * 64 / 1e6
    assert all(ps.header.first_slice_segment_in_pic_flag for ps in slices)
    res = bench_burst.run(heic, 1, "cpu")
    assert set(res) == BURST_KEYS
    sps, pps, slices, mp = image_slices(halfmoonbay_bytes)
    assert len(slices) == 48 and mp == 4032 * 3024 / 1e6
    assert sps.pic_width_in_luma_samples == 512


def test_bench_burst_run_and_main(grid_file, capsys):
    res = bench_burst.run(grid_file.read_bytes(), 1, "cpu")
    assert set(res) == BURST_KEYS
    assert res["metric"] == "burst_decode_to_device_throughput"
    assert res["images"] == 1 and len(res["per_image_s"]) == 1
    assert res["value"] > 0 and res["best_image_mp_s"] >= res["value"] * 0.999
    assert res["megapixels_total"] == image_slices(grid_file.read_bytes())[3]
    assert bench_burst.main([str(grid_file), "2", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == BURST_KEYS and line["images"] == 2
    with pytest.raises(ValueError, match="n_images"):
        bench_burst.run(grid_file.read_bytes(), 0, "cpu")


@pytest.mark.parametrize("gen", [False, True])
def test_bench_device_entropy_main_on_a_small_grid(wpp_file, gen, capsys):
    argv = [str(wpp_file), "--device", "cpu"] + (["--gen"] if gen else [])
    assert BDE.main(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = ({"steps_per_s", "envelope_entries"} if gen else
            {"padded_mbins_s"})
    assert set(line) == {"metric", "value", "unit", "streams", "total_bins",
                         "wall_ms"} | keys
    assert line["metric"] == ("device_entropy_generated_throughput" if gen
                              else "device_entropy_throughput")
    assert line["streams"] == 4 and line["total_bins"] > 0
    assert line["value"] is None and line["wall_ms"] is None  # no card


@pytest.fixture(scope="module")
def flagship_tile(halfmoonbay_bytes):
    sps, pps, slices, _ = image_slices(halfmoonbay_bytes)
    return sps, pps, slices[TILE]


@pytest.fixture(scope="module")
def flagship_replay(flagship_tile):
    """trace_entries' replay output for flagship tile TILE alone."""
    from heif_tpu.cabac.trace import trace_tile

    sps, pps, ps = flagship_tile
    entries = [(bytes(ps.rbsp), seg) for seg in trace_tile(sps, pps, ps)]
    return entries, None, [0] * len(entries)


@pytest.fixture(scope="module")
def flagship_gen(flagship_tile):
    """trace_entries' gen output for flagship tile TILE alone."""
    from heif_tpu_torch.ops.cabac_gen import envelope_entries

    entries, syntax = envelope_entries(*flagship_tile)
    return entries, [syntax.coeffs], [0] * len(entries)


def test_run_replay_on_flagship_tile(flagship_replay):
    entries = flagship_replay[0]
    res = BDE.run_replay(entries, "cpu", timed=False)
    assert res["streams"] == 16 and res["value"] is None
    assert res["total_bins"] == sum(s.n_bins for _, s in entries) > 0
    with pytest.raises(ValueError, match="needs a CUDA device"):
        BDE.run_replay(entries, "cpu", timed=True)


def test_run_replay_raises_on_a_flipped_bin(flagship_replay):
    entries = list(flagship_replay[0])
    rbsp, seg = entries[3]
    bad = copy.copy(seg)
    bad.bins = seg.bins.copy()
    bad.bins[100] ^= 1
    entries[3] = (rbsp, bad)
    with pytest.raises(ValueError, match="stream 3: bins"):
        BDE.run_replay(entries, "cpu", timed=False)


def test_run_gen_on_flagship_tile(flagship_gen):
    entries, goldens, tile_of = flagship_gen
    res = BDE.run_gen(entries, goldens, tile_of, "cpu", timed=False)
    assert res["streams"] == 16 and res["value"] is None
    assert res["envelope_entries"] == sum(e[2].size for e in entries) > 0
    # a flipped coefficient in the golden planes is caught
    bad = [[p.copy() for p in g] for g in goldens]
    y = bad[0][0]
    i = np.flatnonzero(y)[0]
    y.flat[i] = -y.flat[i]
    with pytest.raises(ValueError, match="tile 0 plane 0: 1 coefficients"):
        BDE.run_gen(entries, bad, tile_of, "cpu", timed=False)
