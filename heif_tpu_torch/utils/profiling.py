"""Decode observability (port of heif_tpu/utils/profiling.py):
DecodeStats, the per-stage timings (a copy of heif_tpu's),
device_trace, behind the CLI's `decode --trace`, and the card's
nvidia-smi readings that measurements print beside their times.

heif_tpu wraps the decode in jax.profiler.trace(logdir); here it is
torch.profiler, writing a TensorBoard-readable Chrome trace
(<worker>.<timestamp>.pt.trace.json) into logdir through
torch.profiler.tensorboard_trace_handler. On a CUDA device the trace
holds the card's kernels under their CUDA names (the intra kernels as
intra_walk<...>, the CABAC kernels as replay_kernel, windowed_kernel and
gen_kernel); no spans of its own are added.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional

DEFAULT_LOGDIR = "/tmp/heif_tpu_torch_trace"


@dataclass
class DecodeStats:
    """Structured per-decode statistics.

    stages: stage name -> wall seconds (hdr, entropy, pack, recon, stitch).
    Counters are filled by the stages that know them; derived rates are
    computed on demand.
    """

    stages: dict = field(default_factory=dict)
    megapixels: float = 0.0
    tiles: int = 0
    tile_errors: int = 0
    errors: dict = field(default_factory=dict)  # tile index -> message
    bins: int = 0  # CABAC bins decoded (entropy stage)
    ctus: int = 0
    n_devices: int = 1
    # scheduler inputs derived from the stream's declared parallelism
    # hints (ops.batch.schedule_hints): chunk, entropy_workers,
    # parallelism_type, min_spatial_segmentation_idc
    scheduler: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    @property
    def total_s(self) -> float:
        return sum(self.stages.values())

    def rates(self) -> dict:
        out = {}
        t = self.total_s
        if t > 0 and self.megapixels:
            out["mp_per_s"] = self.megapixels / t
            out["mp_per_s_per_chip"] = self.megapixels / t / max(self.n_devices, 1)
        ent = self.stages.get("entropy", 0.0)
        if ent > 0 and self.bins:
            out["bins_per_s"] = self.bins / ent
        if t > 0 and self.ctus:
            out["ctus_per_s"] = self.ctus / t
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
    import torch

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
