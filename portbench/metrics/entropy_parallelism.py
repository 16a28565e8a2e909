"""DecodeStats.counters["entropy_busy_s"] over DecodeStats.stages
["entropy"], each summed over the window's calls: how many of the native
entropy pool's threads were busy, on average, while the program's
heif.entropy span was open (absent from a program without the
counter)."""


def read(run):
    busy = [s.counters["entropy_busy_s"] for s in run.stats
            if "entropy_busy_s" in getattr(s, "counters", {})]
    span_s = sum(s.stages.get("entropy", 0.0) for s in run.stats)
    if not busy or span_s <= 0:
        return None
    return sum(busy) / span_s
