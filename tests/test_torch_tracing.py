"""The program's spans (utils.profiling.span) and what outlives a run.

On the CPU, on the 2x2 x265 grid with irot 1 (`grid_irot`, muxed from
tests/assets/torch/grid_0..3.hevc by the port's heif_mux):
- a decode(device="cpu", stats=...) under torch.profiler holds the
  spans heif.hdr, .entropy, .pack, .h2d, .launch, .d2h and .stitch on
  the main thread, core's torch ops inside heif.launch on the same
  clock, and the stages in stats, core's four as inner stages;
- a decode_burst under a profiler of every thread holds heif.entropy on
  the worker thread and heif.entropy_wait, .pack, .h2d and .launch on
  the calling thread;
- with the profiler off, record_function is never entered;
- stats.counters["h2d_copies"] counts the copies plan_to_device makes,
  one a plan, and ["h2d_bytes"] the bytes of that one buffer;
- a traced decode and a traced burst in a process of their own session
  leave no process of that session behind;
- ops._build.build, given a fake nvcc whose one compile fails while
  another has forked a child, raises and leaves no child behind.
On a card (`cuda`-marked; skips without one): a traced decode() with
stats makes the same synchronizing calls as a plain one, and fills
stats.device from CUDA events.

This file imports no JAX: on the card, python -m pytest -q
tests/test_torch_tracing.py.
"""

import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

from heif_tpu_torch import HeicDecoder
from heif_tpu_torch.ops import _build
from heif_tpu_torch.ops import batch as B
from heif_tpu_torch.tools import image_slices
from heif_tpu_torch.utils import profiling
from heif_tpu_torch.utils.heif_mux import mux_heic
from heif_tpu_torch.utils.profiling import DecodeStats, span
from heif_tpu_torch.utils.synthetic import synthetic_batch

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "assets" / "torch"
CORE = ("residual", "intra", "deblock", "sao")
DECODE_SPANS = {"hdr", "entropy", "pack", "h2d", "launch", "d2h", "stitch"}


@pytest.fixture(scope="module")
def grid_irot() -> bytes:
    streams = [(FIXTURES / f"grid_{i}.hevc").read_bytes() for i in range(4)]
    return mux_heic(streams, grid=(2, 2, 2 * 96 - 8, 2 * 64 - 6), irot=1)


def _host_events(prof) -> list:
    """(name, start ns, end ns, thread) of the trace's host events."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CPU"):
            out.append((e.name(), e.start_ns(),
                        e.start_ns() + e.duration_ns(), e.start_thread_id()))
    return out


def _spans(events) -> dict:
    """{span name without 'heif.': [(start, end, thread)]}"""
    out = {}
    for name, s, t, th in events:
        if name.startswith("heif."):
            out.setdefault(name[5:], []).append((s, t, th))
    return out


@pytest.fixture(scope="module")
def traced_decode(grid_irot):
    HeicDecoder.decode(grid_irot, device="cpu")  # warm
    stats = DecodeStats()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = HeicDecoder.decode(grid_irot, device="cpu", stats=stats)
    return got, stats, _host_events(prof)


def test_decode_spans_on_the_main_thread(grid_irot, traced_decode):
    got, stats, events = traced_decode
    spans = _spans(events)
    assert DECODE_SPANS | set(CORE) <= set(spans)
    threads = {th for name in DECODE_SPANS for _, _, th in spans[name]}
    assert len(threads) == 1
    assert set(stats.stages) == DECODE_SPANS | set(CORE)
    assert stats.inner == set(CORE)
    assert stats.total_s == pytest.approx(
        sum(stats.stages[k] for k in DECODE_SPANS))
    assert stats.device == {}  # CUDA events only
    want = HeicDecoder.decode(grid_irot, device="cpu")
    for k in ("Y", "Cb", "Cr"):
        np.testing.assert_array_equal(got[k], want[k])


def test_core_ops_lie_inside_launch(traced_decode):
    _, _, events = traced_decode
    spans = _spans(events)
    (l0, l1, main), = spans["launch"]
    stages = [iv for name in CORE for iv in spans[name]]
    assert len(stages) == len(CORE)
    ops = [(s, t) for name, s, t, th in events
           if th == main and name.startswith("aten::")
           and any(a <= s and t <= b for a, b, _ in stages)]
    assert len(ops) > 100
    assert all(l0 <= s and t <= l1 for s, t in ops)
    for s, t, _ in stages:
        assert l0 <= s and t <= l1
    # h2d and d2h lie outside launch
    for name in ("h2d", "d2h"):
        (a, b, _), = spans[name]
        assert b <= l0 or a >= l1


def test_burst_entropy_on_the_worker_thread(grid_irot):
    sps, pps, slices, _ = image_slices(grid_irot)
    B.decode_burst(sps, pps, [slices], chunk=2, device="cpu")  # warm
    stats = DecodeStats()
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        outs = B.decode_burst(sps, pps, [slices, slices], chunk=2,
                              stats=stats, device="cpu")
    assert [len(img) for img in outs] == [2, 2]
    spans = _spans(_host_events(prof))
    main = {th for name in ("entropy_wait", "pack", "h2d", "launch")
            for _, _, th in spans[name]}
    assert len(main) == 1
    assert len(spans["entropy"]) == 4
    assert {th for _, _, th in spans["entropy"]}.isdisjoint(main)
    assert len(spans["dispatch"]) == 4
    assert stats.inner == {"h2d", "launch"}
    assert stats.counters["h2d_copies"] > 0


def test_no_record_function_with_the_profiler_off(grid_irot, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert span("hdr") is span("launch")  # one shared no-op
    HeicDecoder.decode(grid_irot, device="cpu")
    sps, pps, slices, _ = image_slices(grid_irot)
    B.decode_burst(sps, pps, [slices], chunk=2, device="cpu")
    stats = DecodeStats()  # stats alone time on the host clock
    HeicDecoder.decode(grid_irot, device="cpu", stats=stats)
    assert DECODE_SPANS <= set(stats.stages)


def test_h2d_copies_count_the_arrays_shipped():
    sts, sps, pps, slices = synthetic_batch(n=3, size=64, bd=10, pcm=True,
                                            seed=5)
    bp = B.pack_batch(sts, sps, pps, slices)
    stats = DecodeStats()
    d = B.plan_to_device(bp, torch.device("cpu"), stats)
    shipped = [t for k, v in d.items() if k != "schedules"
               for t in (v.values() if isinstance(v, dict) else
                         v if isinstance(v, list) else [v])
               for t in (t[2:] if isinstance(t, tuple) else [t])
               if t is not None]
    assert all(isinstance(t, torch.Tensor) for t in shipped)
    n_pcm = sum(p is not None for p in bp.pcm)
    assert n_pcm == 3
    used = {(size, comp) for comp, size in bp.tc_coeffs}
    assert len(shipped) == 6 * len(bp.tc_coeffs) + len(used) + 6 + n_pcm + 5
    nbytes = sum(t.numel() * t.element_size() for t in shipped)
    # one copy a plan; its bytes hold every array, each padded to < 256
    assert stats.counters["h2d_copies"] == 1
    assert nbytes <= stats.counters["h2d_bytes"] < nbytes + 256 * len(shipped)
    assert set(stats.counters) == {"h2d_copies", "h2d_bytes"}
    assert set(stats.stages) == {"h2d"}
    counted = dict(stats.counters)
    B.plan_to_device(bp, torch.device("cpu"))  # no stats: nothing counted
    assert stats.counters == counted
    B.plan_to_device(bp, torch.device("cpu"), stats)
    assert stats.counters == {k: 2 * v for k, v in counted.items()}


RUN = textwrap.dedent("""
    import sys
    from heif_tpu_torch import HeicDecoder
    from heif_tpu_torch.ops.batch import decode_burst
    from heif_tpu_torch.tools import image_slices
    from heif_tpu_torch.utils.profiling import DecodeStats, device_trace

    data = open(sys.argv[1], "rb").read()
    with device_trace(True, sys.argv[2], "cpu") as trace:
        HeicDecoder.decode(data, device="cpu", stats=DecodeStats())
        sps, pps, slices, _ = image_slices(data)
        decode_burst(sps, pps, [slices, slices], chunk=2,
                     stats=DecodeStats(), device="cpu")
    assert trace.path
    print("done")
""")


def _gone(pid: int) -> bool:
    """No process has this pid, or it is a zombie (dead, not yet reaped
    by its new parent)."""
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1]
    except FileNotFoundError:
        return True
    return state.split()[0] in ("Z", "X")


def test_traced_runs_leave_no_process_behind(grid_irot, tmp_path):
    image = tmp_path / "grid_irot.heic"
    image.write_bytes(grid_irot)
    proc = subprocess.Popen(
        [sys.executable, "-c", RUN, str(image), str(tmp_path / "trace")],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    assert out.split() == ["done"]
    with pytest.raises(ProcessLookupError):
        os.killpg(proc.pid, 0)


FAKE_NVCC = textwrap.dedent("""\
    #!/bin/sh
    # nvcc stand-in: $@ ends in the source; a.cu fails once b.cu has
    # forked its child, b.cu waits on a child that would run for minutes
    for src; do :; done
    dir=$(dirname "$src")
    case "$src" in
    *a.cu)
        while [ ! -s "$dir/child.pid" ]; do sleep 0.05; done
        echo "a.cu: error" >&2
        exit 1 ;;
    *b.cu)
        sleep 600 &
        echo $! > "$dir/child.pid"
        wait ;;
    esac
""")


def test_failed_build_leaves_no_child_behind(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text("// stand-in\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="a.cu: error"):
        _build.build()
    assert time.perf_counter() - t0 < 60
    child = int((csrc / "child.pid").read_text())
    deadline = time.monotonic() + 10
    while not _gone(child) and time.monotonic() < deadline:
        time.sleep(0.05)
    alive = not _gone(child)
    if alive:
        os.kill(child, signal.SIGKILL)
    assert not alive, "the forked child of a killed nvcc survived build()"
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sync_calls(prof) -> dict:
    names = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
             "cudaEventSynchronize")
    out = dict.fromkeys(names, 0)
    for name, *_ in _host_events(prof):
        if name in out:
            out[name] += 1
    return out


@pytest.mark.cuda
def test_traced_decode_on_card_adds_no_synchronize(cuda, grid_irot,
                                                   monkeypatch):
    HeicDecoder.decode(grid_irot, device="cuda")  # warm
    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as plain:
        want = HeicDecoder.decode(grid_irot, device="cuda")
    n_plain = len(calls)
    stats = DecodeStats()
    with profile(activities=acts) as traced:
        got = HeicDecoder.decode(grid_irot, device="cuda", stats=stats)
    assert len(calls) - n_plain == n_plain
    a, b = _sync_calls(plain), _sync_calls(traced)
    assert b["cudaDeviceSynchronize"] == a["cudaDeviceSynchronize"]
    assert b["cudaStreamSynchronize"] == a["cudaStreamSynchronize"]
    # one wait on the last event pair, after the D2H's own synchronize
    assert b["cudaEventSynchronize"] == a["cudaEventSynchronize"] + 1
    assert set(stats.device) == {"h2d", "d2h", *CORE}
    assert all(v > 0 for v in stats.device.values())
    for k in ("Y", "Cb", "Cr"):
        np.testing.assert_array_equal(got[k], want[k])
