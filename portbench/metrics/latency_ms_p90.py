"""The 90th percentile of the window's call latencies (bytes in, planes
out), over all calls."""

import statistics


def read(run):
    if len(run.latencies_s) < 2:
        return None
    return 1e3 * statistics.quantiles(run.latencies_s, n=10,
                                      method="inclusive")[8]
