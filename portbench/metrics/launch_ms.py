"""DecodeStats.stages["launch"], milliseconds an image (the program's span
heif.launch; absent from a program without it)."""

from portbench.metrics import stage_ms


def read(run):
    return stage_ms(run, "launch")
