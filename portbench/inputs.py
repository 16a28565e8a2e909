"""Inputs made from the seed. A configuration names its source files,
each with its sha256 ("assets": [{"file", "sha256"}, ...]): one grid
image, or K >= 1 single-item images.

- A grid: each image holds the source's tiles in a seeded permutation
  (mux.permute_grid), so every image decodes the same work and no two
  images of a run hold their tiles in the same order.
- Single items: each image is one of the K files, in a seeded order that
  takes every file equally often (n // K or one more times), re-muxed
  with a seeded primary item id (mux.renumber_item), so no two images of
  a run are byte-identical while each keeps its picture's payload, hvcC
  and properties.
"""

from __future__ import annotations

import hashlib
import random
from pathlib import Path

from portbench import mux
from portbench.reference import image as ref_image

ROOT = Path(__file__).resolve().parents[1]


def load_assets(config: dict) -> list:
    """The configuration's source files, each checked against its
    sha256."""
    out = []
    for entry in config["assets"]:
        data = (ROOT / entry["file"]).read_bytes()
        digest = hashlib.sha256(data).hexdigest()
        if digest != entry["sha256"]:
            raise ValueError(f"{entry['file']}: sha256 {digest}, expected "
                             f"{entry['sha256']}")
        out.append(data)
    return out


def make_images(sources: list, seed: int, n: int) -> list:
    """n images from `sources` (the configuration's files), drawn from
    `seed` (random.Random: the same on every platform)."""
    tiles = [len(ref_image.parse(d).tiles) for d in sources]
    if all(t == 1 for t in tiles):
        return single_items(sources, seed, n)
    if len(sources) != 1:
        raise ValueError("a grid configuration names one source image")
    return permuted_grids(sources[0], tiles[0], seed, n)


def permuted_grids(data: bytes, tiles: int, seed: int, n: int) -> list:
    rng = random.Random(seed)
    out, seen = [], set()
    while len(out) < n:
        perm = list(range(tiles))
        rng.shuffle(perm)
        if tuple(perm) in seen:
            continue
        seen.add(tuple(perm))
        out.append(mux.permute_grid(data, perm))
    return out


def single_items(files: list, seed: int, n: int) -> list:
    rng = random.Random(seed)
    order = [i % len(files) for i in range(n)]
    rng.shuffle(order)
    ids = rng.sample(range(1, 1 << 16), n)
    return [mux.renumber_item(files[k], i) for k, i in zip(order, ids)]
