"""Golden-reference decoders via ctypes: libde265 (raw HEVC) and libheif.

This is the differential-testing oracle mandated by the reference's own test
strategy (tests/libheif_comparison.rs uses libheif as ground truth; see
SURVEY.md §4). Used by tests and the verify CLI — never by the decode path.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

import numpy as np

_DE265_PATH = "libde265.so.0"
_HEIF_PATH = "libheif.so.1"


# ---------------------------------------------------------------------------
# libde265: decode a raw Annex-B HEVC stream to YUV planes
# ---------------------------------------------------------------------------


class _De265:
    _lib = None

    @classmethod
    def lib(cls):
        if cls._lib is None:
            lib = ctypes.CDLL(_DE265_PATH)
            lib.de265_new_decoder.restype = ctypes.c_void_p
            lib.de265_push_data.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p,
                ctypes.c_int,
                ctypes.c_int64,
                ctypes.c_void_p,
            ]
            lib.de265_decode.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.de265_get_next_picture.restype = ctypes.c_void_p
            lib.de265_get_next_picture.argtypes = [ctypes.c_void_p]
            lib.de265_get_image_width.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.de265_get_image_height.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.de265_get_image_plane.restype = ctypes.POINTER(ctypes.c_uint8)
            lib.de265_get_image_plane.argtypes = [
                ctypes.c_void_p,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.de265_get_bits_per_pixel.argtypes = [
                ctypes.c_void_p,
                ctypes.c_int,
            ]
            lib.de265_flush_data.argtypes = [ctypes.c_void_p]
            lib.de265_free_decoder.argtypes = [ctypes.c_void_p]
            lib.de265_release_next_picture.argtypes = [ctypes.c_void_p]
            cls._lib = lib
        return cls._lib


def decode_hevc_annexb(stream: bytes) -> list[np.ndarray]:
    """Decode an Annex-B HEVC stream; returns [Y, Cb, Cr] planes
    (uint8 for 8-bit streams, uint16 for 10/12-bit)."""
    lib = _De265.lib()
    ctx = lib.de265_new_decoder()
    if not ctx:
        raise RuntimeError("de265_new_decoder failed")
    try:
        err = lib.de265_push_data(ctx, stream, len(stream), 0, None)
        if err != 0:
            raise RuntimeError(f"de265_push_data error {err}")
        lib.de265_flush_data(ctx)
        planes: Optional[list[np.ndarray]] = None
        for _ in range(1000):
            more = ctypes.c_int(1)
            lib.de265_decode(ctx, ctypes.byref(more))
            img = lib.de265_get_next_picture(ctx)
            if img:
                planes = []
                for ch in range(3):
                    w = lib.de265_get_image_width(img, ch)
                    h = lib.de265_get_image_height(img, ch)
                    stride = ctypes.c_int(0)  # in bytes
                    ptr = lib.de265_get_image_plane(img, ch, ctypes.byref(stride))
                    if not ptr or w <= 0 or h <= 0:
                        planes.append(None)  # monochrome: no chroma planes
                        continue
                    bpp = lib.de265_get_bits_per_pixel(img, ch)
                    buf = np.ctypeslib.as_array(ptr, shape=(h, stride.value))
                    if bpp > 8:  # little-endian uint16 samples
                        buf = buf.view(np.uint16)
                    planes.append(buf[:, :w].copy())
                lib.de265_release_next_picture(ctx)
                break
            if not more.value:
                break
        if planes is None:
            raise RuntimeError("libde265 produced no picture")
        return planes
    finally:
        lib.de265_free_decoder(ctx)


def decode_tile_nals(
    parameter_set_nals: list[bytes], slice_nals: list[bytes]
) -> list[np.ndarray]:
    """Golden YUV for one HEIF tile: hvcC parameter sets + slice NALs."""
    out = b""
    for nal in parameter_set_nals + slice_nals:
        out += b"\x00\x00\x00\x01" + nal
    return decode_hevc_annexb(out)


def decode_heic_via_de265(data: bytes) -> dict[str, np.ndarray]:
    """Golden full-image decode: parse the container ourselves, decode every
    grid tile with single-threaded libde265, stitch, and crop.

    This is the pixel-exactness oracle. NOTE: libheif's own full decode
    (decode_heic below) enables libde265 worker threads, whose WPP path
    deviates from the single-threaded decode by ± up-to-10 on ~1% of
    samples (deterministically) on this system's libde265 1.0.4/libheif
    1.15.1. Single-threaded libde265 output is the conformant one — it is
    independently reproduced bit-exactly by this project's own spec
    implementation; use decode_heic only for metadata/approximate checks.
    """
    from heif_tpu_torch.container import grammar as cg
    from heif_tpu_torch.container.reader import HeifReader, parse_grid_config

    r = HeifReader(data)
    heif = r.read()
    primary = heif.primary_item_id()
    rec = heif.hevc_configuration_record()
    ps_nals = [
        arr[0]
        for t in (32, 33, 34)
        if (arr := rec.nal_units_of_type(t))
    ]
    info = heif.item_info_by_item_id(primary)
    if info is not None and info.item_type == cg.ItemType.GRID:
        grid = parse_grid_config(r.get_item_data(primary))
        tile_ids = heif.item_ids_referencing(primary, "dimg")
    else:
        grid = None
        tile_ids = [primary]
    ls = rec.length_size_minus_one + 1
    tiles = []
    for tid in tile_ids:
        payload = r.get_item_data(tid)
        nals = []
        pos = 0
        while pos < len(payload):
            ln = int.from_bytes(payload[pos : pos + ls], "big")
            nals.append(payload[pos + ls : pos + ls + ln])
            pos += ls + ln
        tiles.append(decode_tile_nals(ps_nals, nals))
    mono = len(tiles[0]) < 3 or tiles[0][1] is None
    if grid is None:
        t = tiles[0]
        return {
            "Y": t[0],
            "Cb": None if mono else t[1],
            "Cr": None if mono else t[2],
        }
    th, tw = tiles[0][0].shape
    dt = tiles[0][0].dtype
    canvas = {
        "Y": np.zeros((grid.rows * th, grid.columns * tw), dtype=dt),
        "Cb": np.zeros((grid.rows * th // 2, grid.columns * tw // 2), dtype=dt),
        "Cr": np.zeros((grid.rows * th // 2, grid.columns * tw // 2), dtype=dt),
    }
    for i, t in enumerate(tiles):
        rr, cc = divmod(i, grid.columns)
        canvas["Y"][rr * th : (rr + 1) * th, cc * tw : (cc + 1) * tw] = t[0]
        if not mono:
            canvas["Cb"][
                rr * th // 2 : (rr + 1) * th // 2, cc * tw // 2 : (cc + 1) * tw // 2
            ] = t[1]
            canvas["Cr"][
                rr * th // 2 : (rr + 1) * th // 2, cc * tw // 2 : (cc + 1) * tw // 2
            ] = t[2]
    return {
        "Y": canvas["Y"][: grid.output_height, : grid.output_width],
        "Cb": None
        if mono
        else canvas["Cb"][: grid.output_height >> 1, : grid.output_width >> 1],
        "Cr": None
        if mono
        else canvas["Cr"][: grid.output_height >> 1, : grid.output_width >> 1],
    }


# ---------------------------------------------------------------------------
# libheif: decode a full .heic container to YUV planes
# ---------------------------------------------------------------------------


class _HeifError(ctypes.Structure):
    _fields_ = [
        ("code", ctypes.c_int),
        ("subcode", ctypes.c_int),
        ("message", ctypes.c_char_p),
    ]


class _Heif:
    _lib = None

    @classmethod
    def lib(cls):
        if cls._lib is None:
            lib = ctypes.CDLL(_HEIF_PATH)
            lib.heif_context_alloc.restype = ctypes.c_void_p
            lib.heif_context_read_from_memory_without_copy.restype = _HeifError
            lib.heif_context_read_from_memory_without_copy.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p,
                ctypes.c_size_t,
                ctypes.c_void_p,
            ]
            lib.heif_context_get_primary_image_handle.restype = _HeifError
            lib.heif_context_get_primary_image_handle.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_void_p),
            ]
            lib.heif_decode_image.restype = _HeifError
            lib.heif_decode_image.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_void_p,
            ]
            lib.heif_image_get_plane_readonly.restype = ctypes.POINTER(
                ctypes.c_uint8
            )
            lib.heif_image_get_plane_readonly.argtypes = [
                ctypes.c_void_p,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.heif_image_get_width.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.heif_image_get_height.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.heif_image_handle_get_width.argtypes = [ctypes.c_void_p]
            lib.heif_image_handle_get_height.argtypes = [ctypes.c_void_p]
            lib.heif_decoding_options_alloc.restype = ctypes.c_void_p
            lib.heif_context_free.argtypes = [ctypes.c_void_p]
            lib.heif_image_handle_release.argtypes = [ctypes.c_void_p]
            lib.heif_image_release.argtypes = [ctypes.c_void_p]
            lib.heif_decoding_options_free.argtypes = [ctypes.c_void_p]
            cls._lib = lib
        return cls._lib


_HEIF_COLORSPACE_YCBCR = 0
_HEIF_CHROMA_420 = 1
_HEIF_CHANNEL = {"Y": 0, "Cb": 1, "Cr": 2}


def decode_heic(
    data: bytes, ignore_transformations: bool = False
) -> dict[str, np.ndarray]:
    """Decode the primary image of a .heic with libheif → YCbCr planes.

    With ignore_transformations=True, returns the pre-irot/crop image
    (the natural comparison point for the stitched grid before display
    transforms).
    """
    lib = _Heif.lib()
    ctx = lib.heif_context_alloc()
    handle = ctypes.c_void_p()
    img = ctypes.c_void_p()
    opts = None
    try:
        err = lib.heif_context_read_from_memory_without_copy(
            ctx, data, len(data), None
        )
        if err.code != 0:
            raise RuntimeError(f"libheif read: {err.message!r}")
        err = lib.heif_context_get_primary_image_handle(ctx, ctypes.byref(handle))
        if err.code != 0:
            raise RuntimeError(f"libheif primary handle: {err.message!r}")
        opts = lib.heif_decoding_options_alloc()
        if ignore_transformations:
            # struct heif_decoding_options { uint8_t version; uint8_t
            # ignore_transformations; ... } — v1 layout, stable prefix.
            ctypes.cast(opts, ctypes.POINTER(ctypes.c_uint8))[1] = 1
        err = lib.heif_decode_image(
            handle, ctypes.byref(img), _HEIF_COLORSPACE_YCBCR, _HEIF_CHROMA_420, opts
        )
        if err.code != 0:
            raise RuntimeError(f"libheif decode: {err.message!r}")
        planes = {}
        for name, ch in _HEIF_CHANNEL.items():
            w = lib.heif_image_get_width(img, ch)
            h = lib.heif_image_get_height(img, ch)
            stride = ctypes.c_int(0)
            ptr = lib.heif_image_get_plane_readonly(img, ch, ctypes.byref(stride))
            buf = np.ctypeslib.as_array(ptr, shape=(h, stride.value))
            planes[name] = buf[:, :w].copy()
        return planes
    finally:
        if img:
            lib.heif_image_release(img)
        if opts:
            lib.heif_decoding_options_free(opts)
        if handle:
            lib.heif_image_handle_release(handle)
        lib.heif_context_free(ctx)
