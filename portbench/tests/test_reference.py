"""The frozen reference (portbench/reference) against libde265, which the
card host lacks: tiles of both configurations' images, the committed
small streams, and the crop, stitch and rotation of a whole grid image."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.reference import image as ref_image
from portbench.reference.cabac.syntax import TileSyntaxDecoder
from portbench.reference.hevc import params
from portbench.reference.hevc import slice as sl
from portbench.reference.hevc.rbsp import remove_emulation_prevention
from portbench.tests import oracle
from portbench.tests.conftest import (FLAGSHIP, MAIN10, TORCH_ASSETS,
                                      grid_irot, tile_annexb)

oracle_missing = False
try:
    oracle._De265.lib()
except OSError:
    oracle_missing = True
needs_de265 = pytest.mark.skipif(oracle_missing, reason="libde265 not found")


def decode_annexb(stream: bytes) -> list:
    """The reference's decode of a one-picture Annex-B stream."""
    sps = pps = vcl = None
    for nal in sl.split_annexb_nals(stream):
        kind = (nal[0] >> 1) & 0x3F
        if kind == 33:
            sps = params.parse_sps(remove_emulation_prevention(nal[2:]))
        elif kind == 34:
            pps = params.parse_pps(remove_emulation_prevention(nal[2:]))
        elif kind <= 31 and vcl is None:
            vcl = nal
    ps = sl.parse_slice_header(vcl, sps, pps)
    st = TileSyntaxDecoder(sps, pps, ps).decode()
    return ref_image.reconstruct(sps, pps, ps, st)


def assert_planes_equal(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64))


@needs_de265
@pytest.mark.parametrize("asset,tile", [
    (FLAGSHIP, 0), (FLAGSHIP, 22), (FLAGSHIP, 47),
    (MAIN10, 1), (MAIN10, 38),
])
def test_tile_matches_libde265(asset, tile):
    stream = tile_annexb(asset.read_bytes(), tile)
    assert_planes_equal(decode_annexb(stream),
                        oracle.decode_hevc_annexb(stream))


@needs_de265
@pytest.mark.parametrize("name", ["8bit.hevc", "main10.hevc", "edge72.hevc"])
def test_small_stream_matches_libde265(name):
    stream = (TORCH_ASSETS / name).read_bytes()
    assert_planes_equal(decode_annexb(stream),
                        oracle.decode_hevc_annexb(stream))


def decode_image(data: bytes, rotate: bool = True) -> dict:
    pic = ref_image.parse(data)
    tiles = []
    for payload in pic.tiles:
        sps, pps, ps, st = ref_image.tile_syntax(
            pic.sps_nal, pic.pps_nal, payload, pic.length_size)
        tiles.append(ref_image.reconstruct(sps, pps, ps, st))
    return ref_image.assemble(tiles, pic, rotate=rotate)


@needs_de265
def test_grid_crop_and_stitch_match_libde265():
    data = grid_irot()
    want = oracle.decode_heic_via_de265(data)
    got = decode_image(data, rotate=False)
    for c in ("Y", "Cb", "Cr"):
        np.testing.assert_array_equal(got[c], want[c])


def turn_anticlockwise(plane: np.ndarray, quarters: int) -> np.ndarray:
    """irot (ISO/IEC 23008-12 §6.5.10) by its definition, index by index:
    one quarter turn anticlockwise takes sample (r, c) of an H x W plane
    to (W - 1 - c, r)."""
    for _ in range(quarters % 4):
        h, w = plane.shape
        out = np.empty((w, h), plane.dtype)
        r, c = np.indices((h, w))
        out[w - 1 - c, r] = plane
        plane = out
    return plane


@needs_de265
def test_grid_rotation_matches_libde265_turned():
    data = grid_irot()
    want = oracle.decode_heic_via_de265(data)
    got = decode_image(data)
    assert got["Y"].shape == (184, 122)  # irot 1: width and height swap
    for c in ("Y", "Cb", "Cr"):
        np.testing.assert_array_equal(got[c], turn_anticlockwise(want[c], 1))
