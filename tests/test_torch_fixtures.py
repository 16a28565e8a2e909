"""The port's committed fixture streams (tests/assets/torch/), held to
their manifest and to heif_tpu.

The host with the card has no libx265, so the x265 streams that the card
tests decode are encoded once, where libx265 exists, by the port's copy
of the encoder binding (heif_tpu_torch.utils.x265enc), and committed:
- 8bit.hevc, main10.hevc, mono.hevc and grid_0.hevc .. grid_3.hevc: the
  x265 kinds of test_torch_decode.py's _container, from the same seeded
  planes (its _x265_planes, seeded by default_rng(len(kind)));
- main10_grid_4032x3024.heic: the flagship's 48 coded 512x512 tiles, each
  decoded by the port (backend="ref", device="cpu"), shifted left by 2 to
  10 bits, encoded at GRID_QP (CTB 64, WPP) and muxed as a 6x8 grid of
  4032x3024 with irot 3: the flagship's geometry at 10 bits.
MANIFEST.json records each file's sha256, seed, planes, qp, encoder
version and the command that regenerates it. PCM and tiled streams are
not committed: utils.hevc_synth is pure Python, so the card builds them.

Here, tolerance 0 throughout:
- every committed file matches its MANIFEST.json sha256;
- where libx265 is present, the small streams re-encode to the committed
  bytes with the encode cache off (the 48-tile grid under `slow`: it
  decodes all 48 flagship tiles on the host first), and the port's mux
  of them equals test_torch_decode.py's containers of those kinds;
- each small-fixture container, muxed by the port, decodes on
  device="cpu" equal to heif_tpu's decode(backend="ref");
- the Main-10 grid: probe equals heif_tpu's, and tiles 0 and 47 through
  decode_hevc(device="cpu") equal heif_tpu's decode_hevc.

Regenerate every file and the manifest (only where libx265 exists; it is
never downloaded):

    PYTHONPATH=. python tests/test_torch_fixtures.py
"""

import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
from test_torch_decode import _container as decode_container
from test_torch_decode import _x265_planes as x265_planes

ROOT = Path(__file__).resolve().parents[1]
ASSETS = ROOT / "tests" / "assets" / "torch"
FLAGSHIP = ROOT / "tests" / "assets" / "halfmoonbay.heic"
MANIFEST = ASSETS / "MANIFEST.json"
COMMAND = "PYTHONPATH=. python tests/test_torch_fixtures.py"
GRID_FILE = "main10_grid_4032x3024.heic"
GRID_QP = 12  # 2.53 MB; qp 10 gives 2.89 MB, within 4% of the 3 MB cap
GRID = (6, 8, 4032, 3024)  # rows, columns, output width, height
SMALL_GRID = (2, 2, 2 * 96 - 8, 2 * 64 - 6)


def small_sources() -> dict:
    """{file: (planes, encode_i_frame keywords, manifest fields)} of the
    x265 kinds of test_torch_decode.py's _container, drawn in its order."""
    out = {}
    rng = np.random.default_rng(len("8bit"))
    out["8bit.hevc"] = (x265_planes(rng, 128, 192), dict(qp=28), dict(
        seed=4, planes="x265_planes(default_rng(4), 128, 192)"))
    rng = np.random.default_rng(len("main10"))
    out["main10.hevc"] = (x265_planes(rng, 128, 192, 10),
                          dict(qp=24, bit_depth=10), dict(
        seed=6, planes="x265_planes(default_rng(6), 128, 192, bd=10)"))
    rng = np.random.default_rng(len("mono"))
    y, _, _ = x265_planes(rng, 128, 192)
    out["mono.hevc"] = ((y, None, None), dict(qp=28, csp="i400"), dict(
        seed=4, planes="Y of x265_planes(default_rng(4), 128, 192), 4:0:0"))
    rng = np.random.default_rng(len("grid"))
    for i in range(4):
        out[f"grid_{i}.hevc"] = (x265_planes(rng, 64, 96), dict(qp=30), dict(
            seed=4, planes=f"draw {i} of x265_planes(default_rng(4), 64, 96)"
                           f" in order; tile {i} of a grid {SMALL_GRID}, "
                           "irot 1"))
    return out


def grid_planes() -> list:
    """The flagship's 48 coded tiles (grid order) as 10-bit planes: each
    decoded by the port as its own item, shifted left by 2."""
    from heif_tpu_torch import HeicDecoder

    data = FLAGSHIP.read_bytes()
    out = []
    for tid in HeicDecoder.probe(data).tile_ids:
        dec = HeicDecoder.decode(data, item_id=tid, backend="ref",
                                 device="cpu", apply_rotation=False)
        out.append(tuple(dec[k].astype(np.uint16) << 2
                         for k in ("Y", "Cb", "Cr")))
    return out


def encode_grid(planes) -> bytes:
    from heif_tpu_torch.utils import x265enc
    from heif_tpu_torch.utils.heif_mux import mux_heic

    streams = [x265enc.encode_i_frame(*p, qp=GRID_QP, bit_depth=10)
               for p in planes]
    return mux_heic(streams, grid=GRID, irot=3)


def encoder_version(bit_depth: int) -> str:
    from heif_tpu_torch.utils import x265enc

    return x265enc._get_api(bit_depth).version_str.decode()


def generate(out_dir: Path = ASSETS) -> dict:
    """Encode every fixture into out_dir and write its MANIFEST.json."""
    from heif_tpu_torch.utils import x265enc

    out_dir.mkdir(parents=True, exist_ok=True)
    files = {}
    for name, (planes, kw, fields) in small_sources().items():
        files[name] = (x265enc.encode_i_frame(*planes, **kw),
                       dict(fields, qp=kw["qp"],
                            encoder=encoder_version(kw.get("bit_depth", 8))))
    files[GRID_FILE] = (encode_grid(grid_planes()), dict(
        seed=None, qp=GRID_QP, encoder=encoder_version(10),
        planes="tests/assets/halfmoonbay.heic tiles 1-48: HeicDecoder.decode("
               "item_id=t, backend='ref', device='cpu', apply_rotation=False)"
               " << 2, bit_depth=10; mux_heic(grid=(6, 8, 4032, 3024), "
               "irot=3)"))
    manifest = {}
    for name, (blob, fields) in files.items():
        (out_dir / name).write_bytes(blob)
        manifest[name] = dict(sha256=hashlib.sha256(blob).hexdigest(),
                              bytes=len(blob), **fields, command=COMMAND)
    (out_dir / "MANIFEST.json").write_text(
        json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    return manifest


def small_container(kind: str) -> bytes:
    """The container of an x265 kind ("8bit", "main10", "mono", "grid"),
    muxed by the port from the committed streams."""
    from heif_tpu_torch.utils.heif_mux import mux_heic

    if kind == "grid":
        return mux_heic([(ASSETS / f"grid_{i}.hevc").read_bytes()
                         for i in range(4)], grid=SMALL_GRID, irot=1)
    return mux_heic([(ASSETS / f"{kind}.hevc").read_bytes()])


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------


def _manifest() -> dict:
    return json.loads(MANIFEST.read_text())


def _needs_x265(bit_depth: int):
    from heif_tpu_torch.utils import x265enc

    if not x265enc.available(bit_depth):
        pytest.skip(f"{bit_depth}-bit libx265 unavailable")


def test_manifest_lists_every_file():
    on_disk = {p.name for p in ASSETS.iterdir()} - {"MANIFEST.json"}
    manifest = _manifest()
    assert set(manifest) == on_disk == {*small_sources(), GRID_FILE}
    for fields in manifest.values():
        assert fields["command"] == COMMAND
        assert fields["encoder"] and isinstance(fields["qp"], int)
    assert manifest[GRID_FILE]["bytes"] <= 3_000_000


@pytest.mark.parametrize("name", sorted([*small_sources(), GRID_FILE]))
def test_committed_file_matches_manifest(name):
    blob = (ASSETS / name).read_bytes()
    fields = _manifest()[name]
    assert len(blob) == fields["bytes"]
    assert hashlib.sha256(blob).hexdigest() == fields["sha256"]


@pytest.mark.parametrize("name", sorted(small_sources()))
def test_small_stream_reencodes_to_committed_bytes(name, monkeypatch):
    from heif_tpu_torch.utils import x265enc

    planes, kw, _ = small_sources()[name]
    _needs_x265(kw.get("bit_depth", 8))
    monkeypatch.setenv("HEIF_TPU_NO_X265_CACHE", "1")
    assert _manifest()[name]["encoder"] == encoder_version(
        kw.get("bit_depth", 8))
    assert x265enc.encode_i_frame(*planes, **kw) == (ASSETS / name).read_bytes()


@pytest.mark.slow
def test_grid_reencodes_to_committed_bytes(monkeypatch):
    _needs_x265(10)
    monkeypatch.setenv("HEIF_TPU_NO_X265_CACHE", "1")
    assert encode_grid(grid_planes()) == (ASSETS / GRID_FILE).read_bytes()


@pytest.mark.parametrize("kind", ["8bit", "main10", "mono", "grid"])
def test_committed_streams_make_test_torch_decode_containers(kind):
    """The port's mux of the committed streams is, byte for byte, the
    container that test_torch_decode.py builds with heif_tpu's encoder
    binding and muxer from its seeded planes."""
    _needs_x265(10 if kind == "main10" else 8)
    assert small_container(kind) == decode_container(kind)


@pytest.mark.parametrize("kind", ["8bit", "main10", "mono", "grid"])
def test_small_container_decodes_as_heif_tpu(kind):
    from heif_tpu.models.decoder import HeicDecoder as RefDecoder
    from heif_tpu_torch import HeicDecoder

    heic = small_container(kind)
    got = HeicDecoder.decode(heic, device="cpu")
    want = RefDecoder.decode(heic, backend="ref")
    assert dataclasses.asdict(got["info"]) == dataclasses.asdict(want["info"])
    for k in ("Y", "Cb", "Cr"):
        if want[k] is None:
            assert got[k] is None and kind == "mono"
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_main10_grid_probe_equals_heif_tpu():
    from heif_tpu.models.decoder import HeicDecoder as RefDecoder
    from heif_tpu_torch import HeicDecoder

    data = (ASSETS / GRID_FILE).read_bytes()
    got = HeicDecoder.probe(data)
    assert dataclasses.asdict(got) == dataclasses.asdict(RefDecoder.probe(data))
    assert (got.luma_bit_depth, got.rotation, len(got.tile_ids)) == (10, 3, 48)
    assert (got.display_width, got.display_height) == (3024, 4032)


@pytest.mark.parametrize("tile", [0, 47])
def test_main10_grid_tile_decodes_as_heif_tpu(tile):
    from heif_tpu.models.decoder import HeicDecoder as RefDecoder
    from heif_tpu_torch import HeicDecoder
    from heif_tpu_torch.utils.annexb import tile_annexb

    stream = tile_annexb((ASSETS / GRID_FILE).read_bytes(), tile)
    got = HeicDecoder.decode_hevc(stream, device="cpu")
    want = RefDecoder.decode_hevc(stream)
    assert got["sps"].ctb_log2_size_y == 6
    for k in ("Y", "Cb", "Cr"):
        assert got[k].dtype == want[k].dtype == np.uint16, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


if __name__ == "__main__":
    for name, fields in generate().items():
        print(f"{name}: {fields['bytes']} bytes, sha256 {fields['sha256']}")
