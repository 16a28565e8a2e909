"""Device time of the five core kernels, milliseconds an image: per
kernel the mean of the launches torch.profiler recorded, times the
launches the program counted over the window."""

from portbench.metrics import kernel_bytes


def kernel_seconds(run):
    """{kernel: device seconds over the window}, or None without a trace
    that holds every kernel the program launched."""
    if run.trace is None or not run.images:
        return None
    out = {}
    for name in kernel_bytes.KERNELS:
        launches = run.launches.get(name, 0)
        if not launches:
            continue
        count, seconds = run.trace["kernels"].get(name, (0, 0.0))
        if not count:
            return None
        out[name] = seconds / count * launches
    return out or None


def read(run):
    secs = kernel_seconds(run)
    return None if secs is None else 1e3 * sum(secs.values()) / run.images
