"""The inputs made from the seed (portbench.inputs, portbench.mux)."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest

from portbench import inputs, mux
from portbench.reference import image as ref_image
from portbench.reference.container.reader import HeifReader
from portbench.tests.conftest import (FLAGSHIP, MAIN10, ROOT, grid_irot,
                                      single_items)
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
    src = [FLAGSHIP.read_bytes()]
    assert inputs.make_images(src, SEED, 3) == inputs.make_images(src, SEED, 3)


def test_two_seeds_give_other_bytes_and_other_pictures():
    src = [grid_irot()]
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
        for data in inputs.make_images([src], SEED, 4):
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


# sha256 of make_images(asset, SEED, 3) as the grid maker gave them before
# it took single items: a grid configuration's images may not change
GRID_DIGESTS = {
    "flagship": ["5ae9c2d2f4d4a73fb66395a67a93b6c3a20ca123ab5057829b8a25b5ef69d741",
                 "cadb6da7ac865933dd26bd8e3a882305542024601f1e01c5f47c85156e59793e",
                 "26b9eef5ce44f4d06ff5975ba1b3960c1450a93567215366a7c8fddfd16c4962"],
    "main10": ["0ff1e81a8fa7f19731569c0ae120a1722599ae71542b9c904156196acd5cb3d8",
               "da781412abef1fb90f9815e5f9ca05443e7e467e9b4f8fa796ad9b016d734542",
               "d802eadbe043f61be9ee104e6486bfbc528ca8c675729be776382514a4f8dca4"],
}


@pytest.mark.parametrize("name,asset", [("flagship", FLAGSHIP),
                                        ("main10", MAIN10)])
def test_grid_images_keep_their_bytes(name, asset):
    images = inputs.make_images([asset.read_bytes()], SEED, 3)
    assert [hashlib.sha256(d).hexdigest() for d in images] == GRID_DIGESTS[name]


def single1080() -> list:
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / "single1080.json").read_text())
    return inputs.load_assets(cfg)


@pytest.mark.parametrize("k,n", [(1, 5), (4, 10), (16, 64)])
def test_single_items(k, n):
    files = single_items(k) if k < 16 else single1080()
    images = inputs.make_images(files, SEED, n)
    assert images == inputs.make_images(files, SEED, n)
    assert images != inputs.make_images(files, SEED + 1, n)
    assert len(images) == n and len(set(images)) == n
    payloads = [ref_image.parse(d).tiles[0] for d in files]
    uses = [0] * k
    for data in images:
        pic = ref_image.parse(data)
        k_of = payloads.index(pic.tiles[0])  # one asset's payload, unchanged
        uses[k_of] += 1
        src = files[k_of]
        assert (pic.sps_nal, pic.pps_nal) == (ref_image.parse(src).sps_nal,
                                              ref_image.parse(src).pps_nal)
        for path in ([b"meta", b"iprp", b"ipco"], [b"ftyp"]):
            assert boxes(data, path) == boxes(src, path)
        assert len(data) == len(src)
    assert max(uses) - min(uses) <= 1  # every file equally often


def test_renumber_item_swaps_with_an_item_that_had_the_id():
    src = grid_irot()  # grid item 5 over tile items 1..4
    data = mux.renumber_item(src, 3)
    r0, r1 = HeifReader(src), HeifReader(data)
    h0, h1 = r0.read(), r1.read()
    assert h1.primary_item_id() == 3
    assert h1.item_ids_referencing(3, "dimg") == [1, 2, 5, 4]
    for a, b in ((1, 1), (2, 2), (3, 5), (4, 4)):
        assert r1.get_item_data(b) == r0.get_item_data(a)
    assert r1.get_item_data(3) == r0.get_item_data(5)  # the grid's idat
    assert ref_image.parse(data).tiles == ref_image.parse(src).tiles
    assert len(data) == len(src)
