"""Device trace of a decode (port of heif_tpu/utils/profiling.py:
device_trace, behind the CLI's `decode --trace`).

heif_tpu wraps the decode in jax.profiler.trace(logdir); here it is
torch.profiler, writing a TensorBoard-readable Chrome trace
(<worker>.<timestamp>.pt.trace.json) into logdir through
torch.profiler.tensorboard_trace_handler. On a CUDA device the trace
holds the card's kernels under their CUDA names (the intra kernels as
intra_walk<...>, the CABAC kernels as replay_kernel, windowed_kernel and
gen_kernel); no spans of its own are added. The per-stage timings stay
heif_tpu.utils.profiling.DecodeStats (shared, JAX-free).
"""

from __future__ import annotations

import contextlib
import glob
import os
import time
from dataclasses import dataclass
from typing import Optional

DEFAULT_LOGDIR = "/tmp/heif_tpu_torch_trace"


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
