"""DecodeStats.counters["h2d_copies"] an image: the host-to-device copies
of the plans the program shipped (absent from a program without the
counter)."""


def read(run):
    got = [s.counters["h2d_copies"] for s in run.stats
           if "h2d_copies" in getattr(s, "counters", {})]
    if not got or not run.images:
        return None
    return sum(got) / run.images
