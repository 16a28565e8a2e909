"""The single12mp configuration: its committed files are what its
configuration and manifest say (libheif's single-item 12 MP HEICs, one
SPS and PPS, CTB 64, WPP, no grid, no irot), its maker reproduces the
manifest's provenance, and its cell runs through the harness on the CPU
(portbench.run.run_cell, on the port's small single-item test picture)
with `correct` true and both entropy metrics read."""

from __future__ import annotations

import ctypes.util
import hashlib
import json

import pytest

from portbench import inputs
from portbench import make_single12mp as maker
from portbench.reference import image as ref_image
from portbench.reference.hevc import params
from portbench.reference.hevc.rbsp import remove_emulation_prevention
from portbench.run import load_cell, run_cell
from portbench.tests.conftest import ROOT, bench

SEED = 2**33 + 21
CONFIG = ROOT / "portbench" / "configs" / "single12mp.json"
ASSETS = ROOT / "portbench" / "assets" / "single12mp"
TEST_PICTURE = ROOT / "tests" / "assets" / "single" / "crop384x256.heic"


def config() -> dict:
    return json.loads(CONFIG.read_text())


def manifest(out=ASSETS) -> dict:
    return json.loads((out / "MANIFEST.json").read_text())


def test_files_match_their_sha256_and_manifest():
    cfg = config()
    files = inputs.load_assets(cfg)  # checks each sha256
    m = manifest()
    assert len(files) == cfg["geometry"]["pictures"] == len(m) == 4
    assert sum(map(len, files)) == cfg["bytes"] < 8 * 2**20
    assert [e["file"].rsplit("/", 1)[1] for e in cfg["assets"]] == \
        [name for name, _, _ in maker.pictures()]
    for entry, data in zip(cfg["assets"], files):
        fields = m[entry["file"].rsplit("/", 1)[1]]
        assert fields["sha256"] == entry["sha256"] \
            == hashlib.sha256(data).hexdigest()
        assert fields["bytes"] == len(data)


def test_one_sps_and_pps_ctb64_wpp_4032x3024_no_grid_no_irot():
    cfg = config()
    pics = [ref_image.parse(d) for d in inputs.load_assets(cfg)]
    assert len({(p.sps_nal, p.pps_nal) for p in pics}) == 1
    assert len({p.tiles[0] for p in pics}) == 4
    for p in pics:
        assert (len(p.tiles), p.out_w, p.out_h, p.angle) == (1, 4032, 3024, 0)
    sps = params.parse_sps(remove_emulation_prevention(pics[0].sps_nal[2:]))
    pps = params.parse_pps(remove_emulation_prevention(pics[0].pps_nal[2:]))
    ctb = 1 << (sps.log2_min_luma_coding_block_size_minus3 + 3
                + sps.log2_diff_max_min_luma_coding_block_size)
    assert ctb == cfg["geometry"]["ctb_size"] == 64
    assert (sps.pic_width_in_luma_samples,
            sps.pic_height_in_luma_samples) == (4032, 3024)
    assert pps.entropy_coding_sync_enabled_flag and not pps.tiles_enabled_flag
    assert sps.sample_adaptive_offset_enabled_flag
    assert (sps.chroma_format_idc, sps.bit_depth_luma_minus8) == (1, 0)
    assert cfg["reduced"] == []


def test_manifests_hold_the_makers_provenance():
    """Each entry holds what make_single12mp.entry writes for it, the
    encoder's name and version aside (read from libheif at run time)."""
    pictures = {name: (lr, tb) for name, lr, tb in maker.pictures()}
    x, y, w, h = maker.TEST_CROP
    expected = {ASSETS: {
        name: {"width": maker.WIDTH, "height": maker.HEIGHT,
               "mirrored_left_right": lr, "mirrored_top_bottom": tb}
        for name, (lr, tb) in pictures.items()},
        maker.TEST_OUT: {TEST_PICTURE.name: {
            "x": x, "y": y, "width": w, "height": h,
            "mirrored_left_right": False, "mirrored_top_bottom": False}}}
    for out, geometry in expected.items():
        m = manifest(out)
        assert set(m) == set(geometry)
        for name, fields in m.items():
            data = (out / name).read_bytes()
            assert fields["sha256"] == hashlib.sha256(data).hexdigest()
            assert fields["picture"] == geometry[name]
            assert fields["quality"] == maker.QUALITY == 50
            assert fields["planes"] == maker.PLANES
            assert fields["command"] == maker.COMMAND
            assert fields["encoder"].startswith("libheif ")
            assert "preset slow, tune ssim" in fields["encoder"]


@pytest.mark.skipif(ctypes.util.find_library("heif") is None,
                    reason="libheif is not on this host")
def test_maker_reencodes_the_committed_bytes():
    """Where libheif exists: the maker's encode of the photo and of the
    test crop gives the committed bytes (x265 is deterministic here)."""
    photo = maker.photo()
    full = [photo[c] for c in ("Y", "Cb", "Cr")]
    lib = maker._libheif()
    data, _ = maker.encode(lib, maker.test_crop(full))
    assert data == TEST_PICTURE.read_bytes()
    data, _ = maker.encode(lib, maker.mirrored(full, True, True))
    assert data == (ASSETS / "mirror_both.heic").read_bytes()


def test_decode_cell_runs_traced_on_the_cpu(tmp_path):
    """single12mp.decode's traffic on the port's small single-item
    picture: correct, and entropy_parallelism near 1 (one task a call)
    with a positive entropy_mbins_s."""
    data = TEST_PICTURE.read_bytes()
    path = tmp_path / "single.heic"
    path.write_bytes(data)
    spec = load_cell("single12mp.decode", bench())
    spec["config"] = {"name": "single_small", "assets": [
        {"file": str(path), "sha256": hashlib.sha256(data).hexdigest()}]}
    spec["traffic"] = dict(spec["traffic"], distinct_images=2,
                           warmup_calls=1, retain_calls=2)
    assert {"entropy_parallelism", "entropy_mbins_s"} <= set(
        spec["per_layer"])
    out = run_cell(spec, SEED, seconds=1.0, trace=True, device="cpu",
                   processes=1)
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert 0.5 < got["entropy_parallelism"] <= 1.0
    assert got["entropy_mbins_s"] > 0
    assert got["entropy_ms"] > 0
