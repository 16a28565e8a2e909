"""Make the single1080 configuration's source files: 16 single-item HEIC
images of 1920x1080, written by libheif's own HEVC encoder (its x265
plugin) as heif-enc writes them at its default quality of 50: one hvc1
primary item, no grid, no irot; x265's CTB 64, WPP, SAO, deblocking and
one slice, as the plugin sets them (preset slow, tune ssim).

Each picture is a crop of the flagship's photo (portbench/configs/
flagship.json) as the benchmark's reference decodes it, before irot,
mirrored left to right where the crop's row and column add up to an odd
number, handed to libheif as YCbCr 4:2:0 planes (heif-enc converts its
RGB input to those itself). The files, and MANIFEST.json with each one's
provenance, are committed: the card host has no libheif. Remake them
where libheif.so.1 with an HEVC encoder exists, from the repository's
root:

    python3 -m portbench.make_single1080
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import tempfile
from pathlib import Path

import numpy as np

from portbench import judge
from portbench.inputs import ROOT, load_assets
from portbench.reference import image as ref_image

OUT = ROOT / "portbench" / "assets" / "single1080"
WIDTH, HEIGHT = 1920, 1080
QUALITY = 50  # heif-enc's -q default, and the x265 plugin's own
XS = (0, 704, 1408, 2112)  # 4032 - 1920 = 2112, in even steps
YS = (0, 648, 1296, 1944)  # 3024 - 1080 = 1944


def crops() -> list:
    """(name, x, y, mirrored) of each picture, row by row."""
    return [(f"crop{r}{c}.heic", x, y, (r + c) % 2 == 1)
            for r, y in enumerate(YS) for c, x in enumerate(XS)]


def photo() -> dict:
    """The flagship's Y, Cb and Cr planes, 4032x3024, before irot."""
    flagship = json.loads((ROOT / "portbench" / "configs"
                           / "flagship.json").read_text())
    data = load_assets(flagship)[0]
    ref = judge.Reference([data])
    return ref_image.assemble(ref.tiles(0), ref.pictures[0], rotate=False)


class _Error(ctypes.Structure):
    _fields_ = [("code", ctypes.c_int), ("subcode", ctypes.c_int),
                ("message", ctypes.c_char_p)]


def _libheif():
    lib = ctypes.CDLL("libheif.so.1")
    for f in ("heif_context_get_encoder_for_format", "heif_image_create",
              "heif_image_add_plane", "heif_encoder_set_lossy_quality",
              "heif_context_encode_image", "heif_context_write_to_file"):
        getattr(lib, f).restype = _Error
    lib.heif_context_alloc.restype = ctypes.c_void_p
    lib.heif_context_free.argtypes = [ctypes.c_void_p]
    lib.heif_image_get_plane.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.heif_image_get_plane.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int)]
    lib.heif_get_version.restype = ctypes.c_char_p
    lib.heif_encoder_get_name.restype = ctypes.c_char_p
    lib.heif_encoder_get_name.argtypes = [ctypes.c_void_p]
    return lib


def _check(err: _Error) -> None:
    if err.code:
        raise RuntimeError(err.message.decode())


def encode(lib, planes: dict, x: int, y: int, mirrored: bool):
    """The crop as libheif writes it: (file bytes, encoder name)."""
    cut = [planes["Y"][y:y + HEIGHT, x:x + WIDTH]]
    for c in ("Cb", "Cr"):
        cut.append(planes[c][y // 2:(y + HEIGHT) // 2,
                             x // 2:(x + WIDTH) // 2])
    if mirrored:
        cut = [p[:, ::-1] for p in cut]
    ctx = ctypes.c_void_p(lib.heif_context_alloc())
    try:
        enc, img, handle = (ctypes.c_void_p() for _ in range(3))
        _check(lib.heif_context_get_encoder_for_format(ctx, 1,  # HEVC
                                                        ctypes.byref(enc)))
        _check(lib.heif_encoder_set_lossy_quality(enc, QUALITY))
        _check(lib.heif_image_create(WIDTH, HEIGHT, 0, 1,  # YCbCr, 4:2:0
                                     ctypes.byref(img)))
        for channel, plane in enumerate(cut):
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


def main() -> None:
    planes = photo()
    lib = _libheif()
    OUT.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for name, x, y, mirrored in crops():
        data, encoder = encode(lib, planes, x, y, mirrored)
        (OUT / name).write_bytes(data)
        manifest[name] = {
            "bytes": len(data),
            "sha256": hashlib.sha256(data).hexdigest(),
            "crop": {"x": x, "y": y, "width": WIDTH, "height": HEIGHT,
                     "mirrored": mirrored},
            "planes": "the flagship's halfmoonbay.heic decoded by "
                      "portbench.reference, tiles stitched and cropped to "
                      "4032x3024, before irot; handed to libheif as YCbCr "
                      "4:2:0",
            "quality": QUALITY,
            "encoder": f"libheif {lib.heif_get_version().decode()}, "
                       f"{encoder} (the plugin's defaults: preset slow, "
                       "tune ssim, tu-intra-depth 2, chroma 420)",
            "writer": "heif_context_encode_image and "
                      "heif_context_write_to_file, as heif-enc calls them",
            "command": "python3 -m portbench.make_single1080",
        }
        print(name, len(data), flush=True)
    (OUT / "MANIFEST.json").write_text(json.dumps(manifest, indent=1,
                                                  sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
