"""DecodeStats.counters["entropy_bins"] over ["entropy_busy_s"], each
summed over the window's calls, in millions a second: the CABAC bins
(decision, bypass and terminate) one thread of the native entropy pool
decodes in a second of its tasks (absent from a program without the
counters)."""


def read(run):
    got = [(s.counters["entropy_bins"], s.counters["entropy_busy_s"])
           for s in run.stats
           if "entropy_bins" in getattr(s, "counters", {})
           and "entropy_busy_s" in s.counters]
    busy = sum(b for _, b in got)
    if not got or busy <= 0:
        return None
    return sum(n for n, _ in got) / busy / 1e6
