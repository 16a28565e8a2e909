"""Output megapixels (ispe width x height) of every image completed in
the window, over the window's wall time."""


def read(run):
    return run.megapixels / run.window_s if run.window_s > 0 else None
