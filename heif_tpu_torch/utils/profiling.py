"""Decode observability (port of heif_tpu/utils/profiling.py):
DecodeStats, the per-stage timings; span, the one timer of the program's
layers; device_trace, behind the CLI's `decode --trace`; and the card's
nvidia-smi readings that measurements print beside their times.

span(name, stats) is the program's only stopwatch. With the torch
profiler running it opens a `heif.<name>` range
(torch.profiler.record_function) on the calling thread, so the span lands
in the profiler's trace on the clock of the CUDA activity beside it; with
`stats` it adds the block's host wall seconds to stats.stages[name]; with
neither it costs one check of a flag. The spans, outermost first:

  hdr           container and slice-header parse (HeicDecoder.decode,
                tools.parse_image, tools.item_slices)
  entropy       host CABAC (decode(); the bulk paths' worker thread)
  entropy_wait  the bulk paths' main thread blocked on a chunk's entropy
  pack          ops.batch.pack_batch
  dispatch      a bulk chunk's h2d + launch + hand-off
  h2d           ops.batch.plan_to_device: fill a plan's one pinned buffer
                and enqueue its copy, no synchronize
  launch        ops.batch.core plus the casts to the output dtype
  residual, intra, deblock, sao   core's four stages, inside launch
  d2h           the one-batch path's copy of the planes to the host
  readback      the overlapped path's wait for its side-stream copies
  stitch        decode()'s gray fill and HeicDecoder._stitch

heif_tpu wraps the decode in jax.profiler.trace(logdir); here it is
torch.profiler, writing a TensorBoard-readable Chrome trace
(<worker>.<timestamp>.pt.trace.json) into logdir through
torch.profiler.tensorboard_trace_handler. On a CUDA device the trace
holds the card's kernels under their CUDA names (the intra kernels as
intra_walk<...>, the CABAC kernels as replay_kernel, windowed_kernel and
gen_kernel) inside the spans above. The profiler records the spans of
the thread that started it; a span on another thread (the bulk paths'
entropy worker) is recorded only by a profiler that records every thread
(torch.profiler._ExperimentalConfig(profile_all_threads=True)).
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

DEFAULT_LOGDIR = "/tmp/heif_tpu_torch_trace"


@dataclass
class DecodeStats:
    """Structured per-decode statistics, filled by the spans given it.

    stages: span name -> host wall seconds, summed over the call. Stages
      nest: launch holds residual, intra, deblock and sao; a bulk chunk's
      dispatch holds h2d and launch; the CLI's total holds the whole
      call. The bulk paths' entropy runs on a worker thread beside the
      main thread's stages.
    inner: the stages that ran inside another stage of these stats on
      the same thread; total_s leaves them out.
    device: stage -> device seconds from CUDA event pairs on the current
      stream (h2d, residual, intra, deblock, sao, d2h), recorded only by
      the one-batch path (ops.batch.reconstruct_batch) on CUDA.
    counters: h2d_copies, the host-to-device copies of the plans shipped
      (ops.batch.plan_to_device: one a plan), and h2d_bytes, the bytes
      those copies ship, padding included; entropy_tasks, the native
      entropy pool's tasks (native.decode_tiles_parallel: one a tile),
      entropy_busy_s, the wall seconds its workers spent inside them,
      and entropy_bins, the CABAC bins they decoded.
    """

    stages: dict = field(default_factory=dict)
    inner: set = field(default_factory=set)
    device: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    megapixels: float = 0.0
    tiles: int = 0
    tile_errors: int = 0
    errors: dict = field(default_factory=dict)  # tile index -> message
    n_devices: int = 1
    # scheduler inputs derived from the stream's declared parallelism
    # hints (ops.batch.schedule_hints): chunk, entropy_workers,
    # parallelism_type, min_spatial_segmentation_idc
    scheduler: dict = field(default_factory=dict)

    @property
    def total_s(self) -> float:
        return sum(v for k, v in self.stages.items() if k not in self.inner)

    def rates(self) -> dict:
        out = {}
        t = self.total_s
        if t > 0 and self.megapixels:
            out["mp_per_s"] = self.megapixels / t
            out["mp_per_s_per_chip"] = self.megapixels / t / max(self.n_devices, 1)
        return out

    def as_dict(self) -> dict:
        d = {
            "stages_ms": {k: round(v * 1e3, 2) for k, v in self.stages.items()},
            "total_ms": round(self.total_s * 1e3, 2),
            "megapixels": round(self.megapixels, 3),
            "tiles": self.tiles,
            "tile_errors": self.tile_errors,
            "n_devices": self.n_devices,
        }
        if self.device:
            d["device_ms"] = {k: round(v * 1e3, 3) for k, v in self.device.items()}
        if self.counters:
            d["counters"] = dict(self.counters)
        if self.errors:
            d["errors"] = self.errors
        if self.scheduler:
            d["scheduler"] = self.scheduler
        d.update({k: round(v, 1) for k, v in self.rates().items()})
        return d

    def json(self) -> str:
        return json.dumps(self.as_dict())

    def summary(self) -> str:
        parts = [f"{k} {v * 1e3:.0f}ms" for k, v in self.stages.items()]
        r = self.rates()
        if "mp_per_s" in r:
            parts.append(f"{r['mp_per_s']:.1f} MP/s")
        if self.tile_errors:
            parts.append(f"{self.tile_errors}/{self.tiles} tiles FAILED")
        return "  ".join(parts)


_OFF = contextlib.nullcontext()
_open = threading.local()  # .stats: the stats of this thread's open spans


class _Span:
    __slots__ = ("name", "stats", "events", "_range", "_t0", "_start")

    def __init__(self, name, stats, events):
        self.name, self.stats, self.events = name, stats, events

    def __enter__(self):
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = record_function("heif." + self.name)
            self._range.__enter__()
        if self.stats is not None:
            stack = _open.__dict__.setdefault("stats", [])
            if any(s is self.stats for s in stack):
                self.stats.inner.add(self.name)
            stack.append(self.stats)
            if self.events is not None:
                self._start = _record_event()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self.stats is not None:
            if self.events is not None:
                self.events.append((self.name, self._start, _record_event()))
            _open.stats.pop()
            stages = self.stats.stages
            stages[self.name] = stages.get(self.name, 0.0) + dt
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def _record_event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def span(name: str, stats: Optional[DecodeStats] = None, events=None):
    """Time the block as the layer `name` (see the module docstring).

    events: where the caller wants device time as well, a list; with
    stats given, a CUDA event pair (name, start, end) is recorded on the
    current stream around the block and appended to it, for
    device_seconds to read once the stream has passed the end event.
    """
    # torch.autograd.profiler's flag, set by every profiler's start and
    # stop: unlike torch._C._autograd._profiler_enabled it also holds on
    # threads other than the one that started the profiler
    if stats is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, stats, events)


def device_seconds(stats: DecodeStats, events: list) -> None:
    """Add the device seconds of the event pairs in `events` (span's) to
    stats.device by name. Waits on the last end event: call it after a
    synchronous copy has passed the pairs, when that wait is a few
    microseconds."""
    if not events:
        return
    events[-1][2].synchronize()
    for name, start, end in events:
        stats.device[name] = (stats.device.get(name, 0.0)
                              + start.elapsed_time(end) / 1e3)
    events.clear()


def nvidia_smi(query: str) -> str:
    """The first card's `nvidia-smi --query-gpu=<query>
    --format=csv,noheader` line, e.g. query "name,power.limit"."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sm_clock_mhz(fn) -> float:
    """The SM clock (nvidia-smi clocks.sm, MHz) sampled while fn() runs
    on the card back to back: the clock its kernels ran at."""
    with ThreadPoolExecutor(1) as pool:
        line = pool.submit(nvidia_smi, "clocks.sm")
        while not line.done():
            fn()
            torch.cuda.synchronize()
        return float(line.result().split()[0])  # "1980 MHz"


@dataclass
class Trace:
    """What device_trace yields: the directory, and the trace file's
    path once the block has ended (None before, and when disabled)."""

    logdir: str
    path: Optional[str] = None


@contextlib.contextmanager
def device_trace(enabled: bool, logdir: str = DEFAULT_LOGDIR, device="cuda"):
    """Profile the block with torch.profiler (CPU activity, plus CUDA
    when `device` resolves to a CUDA device) and write its trace into
    logdir. Yields a Trace whose `path` names the file written, once the
    block ends. enabled=False yields a Trace without starting a profiler
    or writing anything."""
    trace = Trace(logdir)
    if not enabled:
        yield trace
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    from heif_tpu_torch.device import resolve_device

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    worker = f"heif_tpu_torch_{os.getpid()}_{time.time_ns()}"
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir, worker)):
        yield trace
    written = glob.glob(os.path.join(glob.escape(logdir),
                                     f"{worker}.*.pt.trace.json"))
    if not written:
        raise RuntimeError(f"torch.profiler wrote no trace into {logdir}")
    trace.path = max(written, key=os.path.getmtime)
