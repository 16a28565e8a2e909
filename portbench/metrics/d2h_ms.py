"""DecodeStats.device["d2h"], milliseconds an image: the device time of
the one-batch path's copy of the planes to the host, from the program's
CUDA event pair around its span heif.d2h (absent from a program without
it)."""


def read(run):
    got = [s.device["d2h"] for s in run.stats
           if "d2h" in getattr(s, "device", {})]
    if not got or not run.images:
        return None
    return 1e3 * sum(got) / run.images
