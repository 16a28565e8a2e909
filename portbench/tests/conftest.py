"""Small images for the benchmark's CPU tests, made from the committed
assets with the benchmark's own muxer."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import pytest

from portbench import mux
from portbench.reference.container.reader import HeifReader
from portbench.reference.hevc import slice as sl

ROOT = Path(__file__).resolve().parents[2]
FLAGSHIP = ROOT / "tests" / "assets" / "halfmoonbay.heic"
MAIN10 = ROOT / "tests" / "assets" / "torch" / "main10_grid_4032x3024.heic"
TORCH_ASSETS = ROOT / "tests" / "assets" / "torch"
START = b"\x00\x00\x00\x01"
# flagship tiles (grid order) whose coefficient levels pass 127: the
# control's int8 levels change them
LARGE_LEVEL_TILES = (4, 5)


def tile_annexb(data: bytes, index: int) -> bytes:
    """Annex-B stream of tile `index` of a grid image: the hvcC VPS, SPS
    and PPS and the tile's NAL units, each behind a start code."""
    reader = HeifReader(data)
    heif = reader.read()
    tid = heif.item_ids_referencing(heif.primary_item_id(), "dimg")[index]
    rec = heif.hevc_configuration_record(tid)
    nals = [n for t in (32, 33, 34) for n in rec.nal_units_of_type(t)]
    nals += sl.split_length_prefixed_nals(reader.get_item_data(tid),
                                          rec.length_size_minus_one + 1)
    return b"".join(START + bytes(n) for n in nals)


def small_grid(path: Path, tiles=LARGE_LEVEL_TILES, out=(1000, 500),
               irot: int = 3) -> dict:
    """A 1x2 grid of flagship tiles, cropped to `out` and turned by irot,
    written to `path`; returns a configuration dict for it."""
    src = FLAGSHIP.read_bytes()
    data = mux.mux_heic([tile_annexb(src, i) for i in tiles],
                        grid=(1, len(tiles), *out), irot=irot)
    path.write_bytes(data)
    return {"name": "small", "assets": [
        {"file": str(path), "sha256": hashlib.sha256(data).hexdigest()}]}


@pytest.fixture(scope="session")
def small_config(tmp_path_factory) -> dict:
    return small_grid(tmp_path_factory.mktemp("small") / "small.heic")


def grid_irot() -> bytes:
    """The 2x2 grid of x265 tiles with irot 1 that the port's card tests
    call grid_irot (tests/assets/torch/grid_0..3.hevc)."""
    streams = [(TORCH_ASSETS / f"grid_{i}.hevc").read_bytes()
               for i in range(4)]
    return mux.mux_heic(streams, grid=(2, 2, 2 * 96 - 8, 2 * 64 - 6), irot=1)


def single_items(k: int = 4) -> list:
    """k single-item images (one coded picture each, no grid) of the
    port's committed x265 streams, all with one SPS and PPS: grid_0..3
    (64x96), or the 8-bit 128x192 stream for k = 1."""
    if k == 1:
        return [mux.mux_heic([(TORCH_ASSETS / "8bit.hevc").read_bytes()])]
    return [mux.mux_heic([(TORCH_ASSETS / f"grid_{i}.hevc").read_bytes()])
            for i in range(k)]


def single_config_of(out: Path, files: list) -> dict:
    """A configuration of single-item files, as single1080's, written
    to `out`."""
    assets = []
    for i, data in enumerate(files):
        path = out / f"item{i}.heic"
        path.write_bytes(data)
        assets.append({"file": str(path),
                       "sha256": hashlib.sha256(data).hexdigest()})
    return {"name": "single_small", "assets": assets}


@pytest.fixture(scope="session")
def single_config(tmp_path_factory) -> dict:
    return single_config_of(tmp_path_factory.mktemp("single"),
                            single_items())


@pytest.fixture(scope="session")
def single_large_config(tmp_path_factory) -> dict:
    """The two flagship tiles whose levels pass 127, each a single item."""
    src = FLAGSHIP.read_bytes()
    files = [mux.mux_heic([tile_annexb(src, i)]) for i in LARGE_LEVEL_TILES]
    return single_config_of(tmp_path_factory.mktemp("single_large"), files)


@pytest.fixture(scope="session")
def irot_config(tmp_path_factory) -> dict:
    path = tmp_path_factory.mktemp("irot") / "grid_irot.heic"
    data = grid_irot()
    path.write_bytes(data)
    return {"name": "grid_irot", "assets": [
        {"file": str(path), "sha256": hashlib.sha256(data).hexdigest()}]}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())
