"""Share of the byte roofline over the five core kernels: the bytes the
stream defines (kernel_bytes) at 3.35 TB/s, over their device time."""

from portbench.metrics import kernel_bytes
from portbench.metrics.kernel_ms import kernel_seconds


def read(run):
    secs = kernel_seconds(run)
    if secs is None or not run.kernel_bytes:
        return None
    need = sum(run.kernel_bytes[k] for k in secs) / kernel_bytes.HBM_BYTES_PER_S
    return 100.0 * need / sum(secs.values())
