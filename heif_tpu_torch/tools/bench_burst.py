"""Multi-image burst throughput on one device: decode a burst of HEIC
images back to back, each through the overlapped pipeline to the device
(ops.batch.decode_reconstruct_overlapped, readback=False), and report
aggregate MP/s plus per-image times as one JSON line (port of
tools/bench_burst.py, with its keys).

    python -m heif_tpu_torch.tools.bench_burst [image.heic] [n_images]
                                               [--device cuda|cpu]

One image is decoded first as a warm-up, then n_images (default 8) are
timed. Each image starts from the file's bytes (container, parameter
sets and slice headers parsed anew) and ends when the device has
finished its planes (torch.cuda.synchronize): the overlapped call
returns before the card does, so a clock stopped earlier would read
queue time. Nothing in the port is compiled per shape and there is no
shape cache to warm: the warm-up pays only first-use costs (kernel
library load, allocator and pinned-memory pools).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def run(data: bytes, n_images: int = 8, device="cuda") -> dict:
    """Decode `data` once to warm up, then n_images times in a row to the
    device; returns the JSON line's dict (wall times in seconds)."""
    import torch

    from heif_tpu_torch.device import resolve_device
    from heif_tpu_torch.ops.batch import decode_reconstruct_overlapped
    from heif_tpu_torch.tools import image_slices

    if n_images < 1:
        raise ValueError(f"n_images must be >= 1, got {n_images}")
    dev = resolve_device(device)

    def one_image() -> float:
        sps, pps, slices, mp = image_slices(data)
        decode_reconstruct_overlapped(sps, pps, slices, readback=False,
                                      device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return mp

    one_image()
    per_image = []
    t0 = time.perf_counter()
    for _ in range(n_images):
        ti = time.perf_counter()
        mp = one_image()
        per_image.append(time.perf_counter() - ti)
    wall = time.perf_counter() - t0
    return {
        "metric": "burst_decode_to_device_throughput",
        "value": n_images * mp / wall,
        "unit": "megapixels/s",
        "images": n_images,
        "megapixels_total": n_images * mp,
        "wall_s": wall,
        "per_image_s": per_image,
        "best_image_mp_s": mp / min(per_image),
    }


def main(argv=None) -> int:
    from heif_tpu_torch.tools import DEFAULT_IMAGE

    p = argparse.ArgumentParser(prog="heif_tpu_torch.tools.bench_burst",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("image", nargs="?", default=DEFAULT_IMAGE)
    p.add_argument("n_images", nargs="?", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    with open(args.image, "rb") as f:
        data = f.read()
    print(json.dumps(run(data, args.n_images, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
