"""DecodeStats.stages["h2d"], milliseconds an image (the program's span
heif.h2d; absent from a program without it)."""

from portbench.metrics import stage_ms


def read(run):
    return stage_ms(run, "h2d")
