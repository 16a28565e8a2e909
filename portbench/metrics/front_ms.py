"""The benchmark's span around tools.parse_image + tools.item_slices,
milliseconds an image."""


def read(run):
    if not run.front_s or not run.images:
        return None
    return 1e3 * sum(run.front_s) / run.images
