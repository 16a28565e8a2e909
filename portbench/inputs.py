"""Inputs made from the seed: grid images whose tiles are a seeded
permutation of a source image's tiles (mux.permute_grid). Every image of
every seed holds the same tile payloads, so each decodes the same work,
and no two images of a run hold their tiles in the same order."""

from __future__ import annotations

import hashlib
import random
from pathlib import Path

from portbench import mux
from portbench.reference import image as ref_image

ROOT = Path(__file__).resolve().parents[1]


def load_asset(config: dict) -> bytes:
    """The configuration's source image, checked against its sha256."""
    data = (ROOT / config["asset"]).read_bytes()
    digest = hashlib.sha256(data).hexdigest()
    if digest != config["sha256"]:
        raise ValueError(f"{config['asset']}: sha256 {digest}, expected "
                         f"{config['sha256']}")
    return data


def make_images(data: bytes, seed: int, n: int) -> list:
    """n grid images from `data`, each with its tiles in a permutation
    drawn from `seed` (random.Random: the same on every platform)."""
    tiles = len(ref_image.parse(data).tiles)
    if tiles < 2:
        raise ValueError("a single coded item has no tiles to permute")
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
