"""The general traffic generator: one caller in a closed loop (each call
waits for its reply, as a library's caller does), driving the entry that
the traffic file names on the images made from the seed, in turn.

A traffic file (portbench/traffic/<name>.json) holds:
  entry            "decode": HeicDecoder.decode(data, device=...) per
                   image, planes back on the host; "burst": every image
                   of the call through tools.parse_image +
                   tools.item_slices, then one ops.batch.decode_burst to
                   device tensors, then a synchronize
  images_per_call  images a call takes from the cycle
  distinct_images  images made from the seed at set-up and cycled through
  warmup_calls     calls made before the window (set-up)
  retain_calls     calls whose answers are kept for the check, drawn from
                   the seed over the window's calls (a reservoir sample)
"""

from __future__ import annotations

import random
import sys
import time
import traceback

from portbench.trace import span


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def decode_entry(device):
    """HeicDecoder.decode of each image: answers are {"Y", "Cb", "Cr"}
    host planes, cropped and rotated."""
    from heif_tpu_torch import HeicDecoder

    def call(batch, stats, traced, front_s):
        out = []
        for data in batch:
            with span("portbench.decode", traced):
                planes = HeicDecoder.decode(data, device=device, stats=stats)
            out.append({c: planes[c] for c in ("Y", "Cb", "Cr")})
        return out

    return call, "image"


def burst_entry(device):
    """One decode_burst of all images: answers are, per image, its list of
    chunks of [Y, Cb, Cr] device tensors."""
    from heif_tpu_torch.ops.batch import decode_burst
    from heif_tpu_torch.tools import item_slices, parse_image

    def call(batch, stats, traced, front_s):
        lists, sps, pps = [], None, None
        for data in batch:
            t0 = time.perf_counter()
            with span("portbench.front", traced):
                img = parse_image(data)
                lists.append(item_slices(img))
            front_s.append(time.perf_counter() - t0)
            if sps is None:
                sps, pps = img.sps, img.pps
        with span("portbench.decode_burst", traced):
            outs = decode_burst(sps, pps, lists, device=device, stats=stats)
        with span("portbench.synchronize", traced):
            _sync(device)
        return outs

    return call, "chunks"


ENTRIES = {"decode": decode_entry, "burst": burst_entry}


class Reservoir:
    """A uniform sample of k items from a stream of unknown length,
    drawn from the seed (Algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, random.Random(seed), [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


class Loop:
    """The closed loop over `images` (a list of HEIF files, with the
    output megapixels of each) for one traffic file."""

    def __init__(self, traffic: dict, images: list, megapixels: list,
                 device, seed: int):
        self.traffic = traffic
        self.images = images
        self.megapixels = megapixels
        self.call, self.kind = ENTRIES[traffic["entry"]](device)
        self.per = traffic["images_per_call"]
        self.next = 0
        self.reservoir = Reservoir(traffic["retain_calls"], seed)

    def _batch(self) -> list:
        n = len(self.images)
        idx = [(self.next + j) % n for j in range(self.per)]
        self.next = (self.next + self.per) % n
        return idx

    def warm_up(self) -> None:
        for _ in range(self.traffic["warmup_calls"]):
            self.call([self.images[i] for i in self._batch()], None, False, [])

    def window(self, seconds: float, run, stats_factory=None,
               traced: bool = False) -> int:
        """Calls back to back until `seconds` have passed since the first
        began; fills run's images, calls, window_s, latencies_s, stats
        front_s and done and returns the images that failed. The window ends
        at the end of the last call."""
        failed = 0
        t0 = time.perf_counter()
        end = t0
        with span("portbench.window", traced):
            while end - t0 < seconds:
                idx = self._batch()
                stats = stats_factory() if stats_factory else None
                ts = time.perf_counter()
                try:
                    with span("portbench.call", traced):
                        answers = self.call([self.images[i] for i in idx],
                                            stats, traced, run.front_s)
                except Exception:  # a failed call is counted, not fatal
                    traceback.print_exc(file=sys.stderr)
                    failed += len(idx)
                    answers = None
                end = time.perf_counter()
                run.latencies_s.append(end - ts)
                run.calls += 1
                if answers is not None:
                    run.images += len(idx)
                    for i in idx:
                        run.megapixels += self.megapixels[i]
                        run.done[i] = run.done.get(i, 0) + 1
                    if stats is not None:
                        run.stats.append(stats)
                    self.reservoir.offer(list(zip(idx, answers)))
                    del answers
        run.window_s = end - t0
        return failed
