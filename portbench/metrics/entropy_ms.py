"""DecodeStats.stages["entropy"], milliseconds an image."""

from portbench.metrics import stage_ms


def read(run):
    return stage_ms(run, "entropy")
