"""The benchmark's metrics, one reader a metric: portbench/metrics/<name>.py
holds `read(run) -> float | None` for the metric `name` of BENCHMARK.json
('.' and '-' in a name become '_' in its file name). A reader that finds
nothing to read returns None, and the metric is left out of the result."""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field


@dataclass
class Run:
    """What one run measured, as the readers see it.

    images, calls: completed in the window; window_s: from the first
    call's start to the last completed call's end (host clock);
    latencies_s: one a call; megapixels: output megapixels completed;
    setup_s: process start to the window's start; stats: the program's
    DecodeStats, one a call (traced runs only); front_s: the benchmark's
    span around the container and slice-header parse, one an image
    (burst traffic); trace: trace.summarize's dict (traced runs);
    launches: the program's launch counters over the window; done:
    {image index: completions in the window};
    kernel_bytes: {kernel: bytes} the stream defines for the window's
    images (traced runs); peak_window_bytes: device memory peak over the
    window."""

    images: int = 0
    calls: int = 0
    window_s: float = 0.0
    latencies_s: list = field(default_factory=list)
    megapixels: float = 0.0
    setup_s: float = 0.0
    stats: list = field(default_factory=list)
    front_s: list = field(default_factory=list)
    trace: dict | None = None
    launches: dict = field(default_factory=dict)
    done: dict = field(default_factory=dict)
    kernel_bytes: dict | None = None
    peak_window_bytes: int | None = None


def module_name(metric: str) -> str:
    return "portbench.metrics." + metric.replace(".", "_").replace("-", "_")


def read(metric: str, run: Run):
    """The metric's value from its reader, or None."""
    value = importlib.import_module(module_name(metric)).read(run)
    return None if value is None else float(value)


def stage_ms(run: Run, stage: str):
    """A DecodeStats stage's milliseconds an image, summed over the
    window's calls; None where no call recorded the stage."""
    if not run.images or not any(stage in s.stages for s in run.stats):
        return None
    return 1e3 * sum(s.stages.get(stage, 0.0) for s in run.stats) / run.images
