"""heif_tpu_torch.tools.bench_e2e (the port of bench.py) on the CPU.

On the 2x2 x265 grid with irot 1 that the card tests call `grid_irot`
(tests/assets/torch/grid_0..3.hevc muxed by the port's heif_mux):
- the keys of run(..., device="cpu", window_s=0, readback_window_s=0)
  equal the keys of the dict that bench.py prints (read from its source
  with ast), with libde265 loadable and not; the ratios are null exactly
  when libde265 cannot be loaded;
- zero-length windows still run one rep of each path;
- main prints the line last on stdout and the '#' lines on stderr;
- decode_once's planes equal bench.stitch of
  heif_tpu.ops.batch.decode_reconstruct_overlapped's planes, tolerance 0;
- the guard raises, before anything is timed, when one sample of the
  e2e or the decode-to-device planes is flipped;
- device="cuda" raises without CUDA; a libde265 that loads and then
  fails raises.
"""

import ast
import contextlib
import importlib.util
import io
import json
import os
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from heif_tpu.container.reader import HeifReader, parse_grid_config
from heif_tpu.hevc import params
from heif_tpu.hevc import slice as sl
from heif_tpu.hevc.rbsp import remove_emulation_prevention
from heif_tpu.models.decoder import _select_vcl_nal
from heif_tpu.ops import batch as JB
from heif_tpu_torch.ops import batch as TB
from heif_tpu_torch.tools import bench_e2e as E
from heif_tpu_torch.utils import oracle
from heif_tpu_torch.utils.heif_mux import mux_heic

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "assets" / "torch"
CPU = torch.device("cpu")


def _bench_py_keys() -> list:
    """The keys of the dict literal that bench.py passes to json.dumps."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    dicts = [node.args[0] for node in ast.walk(tree)
             if isinstance(node, ast.Call)
             and getattr(node.func, "attr", None) == "dumps"
             and node.args and isinstance(node.args[0], ast.Dict)]
    assert len(dicts) == 1
    return [k.value for k in dicts[0].keys]


def _bench_py():
    """bench.py as a module (it imports no JAX at the top); the variables
    it sets in os.environ are put back."""
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ):
        spec.loader.exec_module(mod)
    return mod


def _de265_loads() -> bool:
    try:
        oracle._De265.lib()
    except OSError:
        return False
    return True


@pytest.fixture(scope="module")
def grid_irot() -> bytes:
    streams = [(FIXTURES / f"grid_{i}.hevc").read_bytes() for i in range(4)]
    return mux_heic(streams, grid=(2, 2, 2 * 96 - 8, 2 * 64 - 6), irot=1)


@pytest.fixture(scope="module", params=["de265", "no_de265"])
def cpu_run(request, grid_irot):
    """run() with windows of 0 s, the calls of each path counted; with
    no_de265, libde265 made unloadable. (result, counts, de265 loads)."""
    counts = {}

    def counted(name):
        fn = getattr(E, name)

        def wrapper(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrapper

    with pytest.MonkeyPatch.context() as mp:
        for name in ("decode_once", "decode_to_device_once", "burst_once"):
            mp.setattr(E, name, counted(name))
        if request.param == "no_de265":
            mp.setattr(oracle, "_DE265_PATH", "libde265-absent.so.0")
            mp.setattr(oracle._De265, "_lib", None)
        loads = _de265_loads()
        res = E.run(grid_irot, window_s=0, readback_window_s=0, device="cpu")
    return res, counts, loads


def test_keys_equal_bench_py(cpu_run):
    res, _, loads = cpu_run
    keys = _bench_py_keys()
    assert list(res) == keys == list(E.KEYS)
    assert res["metric"] == "e2e_heif_decode_throughput"
    assert res["unit"] == "megapixels/s"
    for k in ("value", "device_mp_s", "burst_mp_s"):
        assert np.isfinite(res[k]) and res[k] > 0, k
    assert {"hdr", "recon", "stitch"} <= set(res["stages_ms"])
    ratios = [k for k in keys if "vs_baseline" in k]
    assert len(ratios) == 5
    for k in ratios:
        assert (res[k] is None) == (not loads), k


def test_zero_windows_run_one_rep_each(cpu_run):
    """The guard's decode, a warm-up and one timed rep of e2e and of
    decode to device; a burst warm-up and one burst (cycle 0 has none,
    so one runs after the window)."""
    _, counts, _ = cpu_run
    assert counts == {"decode_once": 3, "decode_to_device_once": 3,
                      "burst_once": 2}


def test_main_prints_the_line_last(grid_irot, tmp_path):
    path = tmp_path / "grid_irot.heic"
    path.write_bytes(grid_irot)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert E.main([str(path), "--window", "0", "--readback-window", "0",
                       "--device", "cpu"]) == 0
    assert list(json.loads(out.getvalue().strip().splitlines()[-1])) == list(E.KEYS)
    lines = err.getvalue().strip().splitlines()
    assert lines and all(line.startswith("# ") for line in lines)
    assert lines[0] == "# device: cpu (the plain PyTorch path; no device metric)"
    assert lines[-1] == '# intra kernel launches: {"luma": 0, "chroma": 0}'


def test_decode_once_equals_heif_tpu_overlapped_and_bench_stitch(grid_irot):
    r = HeifReader(grid_irot)
    heif = r.read()
    primary = heif.primary_item_id()
    grid = parse_grid_config(r.get_item_data(primary))
    tids = heif.item_ids_referencing(primary, "dimg")
    rec = heif.hevc_configuration_record(tids[0])
    sps = params.parse_sps(
        remove_emulation_prevention(rec.nal_units_of_type(33)[0][2:]))
    pps = params.parse_pps(
        remove_emulation_prevention(rec.nal_units_of_type(34)[0][2:]))
    n = rec.length_size_minus_one + 1
    slices = [sl.parse_slice_header(_select_vcl_nal(
        sl.split_length_prefixed_nals(r.get_item_data(t), n)), sps, pps)
        for t in tids]
    planes = JB.decode_reconstruct_overlapped(sps, pps, slices)
    bench = _bench_py()
    th, tw = sps.pic_height_in_luma_samples, sps.pic_width_in_luma_samples
    want = [bench.stitch(np.asarray(planes[0]), grid.rows, grid.columns, th,
                         tw, grid.output_height, grid.output_width)]
    want += [bench.stitch(np.asarray(p), grid.rows, grid.columns, th // 2,
                          tw // 2, grid.output_height // 2,
                          grid.output_width // 2) for p in planes[1:]]
    got, stats = E.decode_once(grid_irot, CPU)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (122, 184)
    assert stats.tiles == 4 and stats.megapixels == 122 * 184 / 1e6
    assert {"hdr", "recon", "stitch"} <= set(stats.stages)


@pytest.mark.parametrize("readback", [True, False])
def test_guard_raises_on_a_flipped_sample(grid_irot, monkeypatch, capsys,
                                          readback):
    real = TB.decode_reconstruct_overlapped

    def flipped(*args, **kwargs):
        out = real(*args, **kwargs)
        if kwargs["readback"] == readback:
            (out[0] if readback else out[0][0])[0, 5, 7] ^= 1
        return out

    monkeypatch.setattr(TB, "decode_reconstruct_overlapped", flipped)
    what = "e2e decode's Y" if readback else "decode to device's plane 0"
    with pytest.raises(RuntimeError, match=f"guard: the {what} differs"):
        E.run(grid_irot, window_s=0, readback_window_s=0, device="cpu")
    assert "warmup" not in capsys.readouterr().err


def test_cuda_raises_without_cuda(grid_irot, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.run(grid_irot, window_s=0, readback_window_s=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.main(["--window", "0", "--readback-window", "0"])


def test_a_failing_libde265_raises(grid_irot, monkeypatch):
    """Only a libde265 that cannot be loaded gives null ratios: one that
    loads (here a stand-in) and then fails raises."""
    monkeypatch.setattr(oracle._De265, "lib", classmethod(lambda cls: object()))

    def fail(data):
        raise RuntimeError("libde265 produced no picture")

    monkeypatch.setattr(oracle, "decode_heic_via_de265", fail)
    with pytest.raises(RuntimeError, match="no picture"):
        E.de265_seconds(grid_irot)
