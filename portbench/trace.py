"""The traced run's reading of torch.profiler: the core kernels' device
time, the device's busy time, the device operations that took most time
and the longest idle gaps, each gap named by what the host's main thread
was doing (its innermost open event: a span of the benchmark or a torch
operation)."""

from __future__ import annotations

import contextlib

from portbench.metrics.kernel_bytes import KERNELS

WINDOW = "portbench.window"


def span(name: str, traced: bool):
    """A host span in the trace (torch.profiler.record_function)."""
    if not traced:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _times(e):
    return e.start_ns(), e.start_ns() + e.duration_ns()


def _merge(intervals):
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _top(totals: dict, n: int = 10) -> list:
    return [[k, v] for k, v in
            sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def summarize(prof) -> dict:
    """{"window_s", "busy_s", "kernels": {kernel: (events, seconds)},
    "device_ops": [[name, seconds]] (10 at most), "idle_gaps": [[host
    event, seconds]] (10 at most)} over the WINDOW span."""
    events = prof.profiler.kineto_results.events()
    cpu, dev, window = [], [], None
    for e in events:
        kind = str(e.device_type())
        if kind.endswith("CPU"):
            if e.name() == WINDOW:
                window = _times(e) + (e.start_thread_id(),)
            cpu.append(e)
        elif kind.endswith("CUDA") and not e.is_user_annotation():
            dev.append(e)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w0, w1, main = window

    kernels = {k: [0, 0.0] for k in KERNELS}
    ops, spans = {}, []
    for e in dev:
        s, t = _times(e)
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        spans.append((s, t))
        name = e.name()
        ops[name] = ops.get(name, 0.0) + (t - s) / 1e9
        for k in KERNELS:
            if k in name:
                kernels[k][0] += 1
                kernels[k][1] += e.duration_ns() / 1e9
    busy = _merge(spans)
    busy_ns = sum(t - s for s, t in busy)

    gaps, prev = [], w0
    for s, t in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    host = sorted((_times(e) + (e.name(),) for e in cpu
                   if e.start_thread_id() == main),
                  key=lambda x: (x[0], -x[1]))
    idle, stack, j = {}, [], 0
    for g0, g1 in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (g0 + g1) / 2
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] <= host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "no host event"
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e9
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "kernels": {k: tuple(v) for k, v in kernels.items()},
        "device_ops": _top(ops),
        "idle_gaps": _top(idle),
    }
