"""The inputs made from the seed (portbench.inputs, portbench.mux)."""

from __future__ import annotations

import numpy as np

from portbench import inputs, mux
from portbench.reference import image as ref_image
from portbench.reference.container.reader import HeifReader
from portbench.tests.conftest import FLAGSHIP, MAIN10, grid_irot
from portbench.tests.test_reference import decode_image

SEED = 2**31 + 977  # past 32 signed bits: seeds may be that large


def boxes(data: bytes, path) -> bytes:
    """The bytes of the box at `path` (fourccs from the top level)."""
    lo, hi = 0, len(data)
    for i, kind in enumerate(path):
        for k, pos, hdr, size in mux._children(data, lo, hi):
            if k == kind:
                lo, hi = pos + hdr + (4 if k == b"meta" else 0), pos + size
                if i == len(path) - 1:
                    return data[pos:pos + size]
                break
        else:
            raise KeyError(kind)


def test_one_seed_gives_the_same_bytes_twice():
    src = FLAGSHIP.read_bytes()
    assert inputs.make_images(src, SEED, 3) == inputs.make_images(src, SEED, 3)


def test_two_seeds_give_other_bytes_and_other_pictures():
    src = grid_irot()
    a = inputs.make_images(src, SEED, 2)
    b = inputs.make_images(src, SEED + 1, 2)
    assert a[0] != b[0] and a[0] != a[1]
    pa, pb = decode_image(a[0]), decode_image(b[0])
    assert not np.array_equal(pa["Y"], pb["Y"])


def test_images_keep_the_source_payloads_and_properties():
    for asset in (FLAGSHIP, MAIN10):
        src = asset.read_bytes()
        r0 = HeifReader(src)
        h0 = r0.read()
        tiles0 = h0.item_ids_referencing(h0.primary_item_id(), "dimg")
        for data in inputs.make_images(src, SEED, 4):
            r1 = HeifReader(data)
            h1 = r1.read()
            tiles1 = h1.item_ids_referencing(h1.primary_item_id(), "dimg")
            assert sorted(tiles1) == sorted(tiles0) and tiles1 != tiles0
            for t in tiles1:  # each item keeps its own payload
                assert r1.get_item_data(t) == r0.get_item_data(t)
            others = {e.item_id for e in h0.meta.item_info.entries} - set(tiles0)
            for t in others:  # thumbnails, Exif, the grid's idat
                assert r1.get_item_data(t) == r0.get_item_data(t)
            # ipco holds hvcC, ispe, irot and colr; ipma ties them to items
            for path in ([b"meta", b"iprp"], [b"meta", b"idat"],
                         [b"ftyp"], [b"meta", b"iinf"]):
                assert boxes(data, path) == boxes(src, path)
            assert ref_image.parse(data).angle == ref_image.parse(src).angle
