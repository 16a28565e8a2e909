"""Process start to the window's start: imports, kernel and entropy
library load (or build), the inputs made from the seed, the warm-up."""


def read(run):
    return run.setup_s
