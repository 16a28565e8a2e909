"""Make the single12mp configuration's source files: 4 single-item HEIC
images of 4032x3024, written by libheif's own HEVC encoder (its x265
plugin) as heif-enc writes them at its default quality of 50: one hvc1
primary item, no grid, no irot; x265's CTB 64, WPP, SAO, deblocking and
one slice, as the plugin sets them (preset slow, tune ssim). This is the
iPhone's 12 MP frame re-saved as one picture by a tool built on libheif.

The pictures are the flagship's photo (portbench/configs/flagship.json)
as the benchmark's reference decodes it, before irot: as it is, mirrored
left to right, mirrored top to bottom, and mirrored both ways, handed to
libheif as YCbCr 4:2:0 planes (heif-enc converts its RGB input to those
itself). The maker also writes the port's CPU test picture,
tests/assets/single/crop384x256.heic: the photo's 384x256 at (2304,
1664), the crop of that size with the most detail, through the same
encoder (6x4 CTBs of 64, 4 WPP substreams).

The files, and each MANIFEST.json with each file's provenance, are
committed: the card host has no libheif. Remake them where libheif.so.1
with an HEVC encoder exists, from the repository's root:

    python3 -m portbench.make_single12mp
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import tempfile
from pathlib import Path

import numpy as np

from portbench.inputs import ROOT
from portbench.make_single1080 import QUALITY, _check, _libheif, photo

OUT = ROOT / "portbench" / "assets" / "single12mp"
TEST_OUT = ROOT / "tests" / "assets" / "single"
WIDTH, HEIGHT = 4032, 3024
TEST_CROP = (2304, 1664, 384, 256)  # the CPU test picture: x, y, w, h
COMMAND = "python3 -m portbench.make_single12mp"
PLANES = ("the flagship's halfmoonbay.heic decoded by portbench.reference, "
          "tiles stitched and cropped to 4032x3024, before irot; handed to "
          "libheif as YCbCr 4:2:0")


def pictures() -> list:
    """(name, mirrored left to right, mirrored top to bottom) of each
    picture."""
    return [("photo.heic", False, False), ("mirror_lr.heic", True, False),
            ("mirror_tb.heic", False, True), ("mirror_both.heic", True, True)]


def mirrored(full: list, lr: bool, tb: bool) -> list:
    """[Y, Cb, Cr] of the photo, mirrored as asked, contiguous."""
    return [np.ascontiguousarray(p[::-1 if tb else 1, ::-1 if lr else 1])
            for p in full]


def test_crop(full: list) -> list:
    """[Y, Cb, Cr] of the CPU test picture, TEST_CROP of the photo."""
    x, y, w, h = TEST_CROP
    crop = [full[0][y:y + h, x:x + w]]
    crop += [p[y // 2:(y + h) // 2, x // 2:(x + w) // 2] for p in full[1:]]
    return [np.ascontiguousarray(p) for p in crop]


def encode(lib, planes: list):
    """[Y, Cb, Cr] (4:2:0) as libheif writes them: (file bytes, encoder
    name)."""
    height, width = planes[0].shape
    ctx = ctypes.c_void_p(lib.heif_context_alloc())
    try:
        enc, img, handle = (ctypes.c_void_p() for _ in range(3))
        _check(lib.heif_context_get_encoder_for_format(ctx, 1,  # HEVC
                                                        ctypes.byref(enc)))
        _check(lib.heif_encoder_set_lossy_quality(enc, QUALITY))
        _check(lib.heif_image_create(width, height, 0, 1,  # YCbCr, 4:2:0
                                     ctypes.byref(img)))
        for channel, plane in enumerate(planes):
            h, w = plane.shape
            _check(lib.heif_image_add_plane(img, channel, w, h, 8))
            stride = ctypes.c_int()
            ptr = lib.heif_image_get_plane(img, channel, ctypes.byref(stride))
            rows = np.ctypeslib.as_array(ptr, shape=(h, stride.value))
            rows[:, :w] = plane
        _check(lib.heif_context_encode_image(ctx, img, enc, None,
                                             ctypes.byref(handle)))
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "out.heic"
            _check(lib.heif_context_write_to_file(ctx, str(path).encode()))
            return path.read_bytes(), lib.heif_encoder_get_name(enc).decode()
    finally:
        lib.heif_context_free(ctx)


def entry(lib, data: bytes, encoder: str, geometry: dict) -> dict:
    """A file's MANIFEST.json entry."""
    return {
        "bytes": len(data),
        "sha256": hashlib.sha256(data).hexdigest(),
        "picture": geometry,
        "planes": PLANES,
        "quality": QUALITY,
        "encoder": f"libheif {lib.heif_get_version().decode()}, {encoder} "
                   "(the plugin's defaults: preset slow, tune ssim, "
                   "tu-intra-depth 2, chroma 420)",
        "writer": "heif_context_encode_image and heif_context_write_to_file, "
                  "as heif-enc calls them",
        "command": COMMAND,
    }


def write(out: Path, files: dict) -> None:
    """files: {name: (bytes, manifest entry)} into `out` with its
    MANIFEST.json."""
    out.mkdir(parents=True, exist_ok=True)
    for name, (data, _) in files.items():
        (out / name).write_bytes(data)
    manifest = {name: fields for name, (_, fields) in files.items()}
    (out / "MANIFEST.json").write_text(json.dumps(manifest, indent=1,
                                                  sort_keys=True) + "\n")


def main() -> None:
    photo_planes = photo()
    full = [photo_planes[c] for c in ("Y", "Cb", "Cr")]
    assert full[0].shape == (HEIGHT, WIDTH)
    lib = _libheif()
    files = {}
    for name, lr, tb in pictures():
        data, encoder = encode(lib, mirrored(full, lr, tb))
        files[name] = (data, entry(lib, data, encoder, {
            "width": WIDTH, "height": HEIGHT, "mirrored_left_right": lr,
            "mirrored_top_bottom": tb}))
        print(name, len(data), flush=True)
    write(OUT, files)
    data, encoder = encode(lib, test_crop(full))
    x, y, w, h = TEST_CROP
    write(TEST_OUT, {"crop384x256.heic": (data, entry(lib, data, encoder, {
        "x": x, "y": y, "width": w, "height": h,
        "mirrored_left_right": False, "mirrored_top_bottom": False}))})
    print("crop384x256.heic", len(data), flush=True)


if __name__ == "__main__":
    main()
