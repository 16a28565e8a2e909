"""libde265 through ctypes: the benchmark's tests hold the frozen
reference against it on the CPU (the libde265 half of
heif_tpu_torch/utils/oracle.py, logic unchanged, the container parse taken
from the reference's own copy). The card host has no libde265: the
benchmark itself never loads it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

import numpy as np

_DE265_PATH = "libde265.so.0"


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
    from portbench.reference.container import grammar as cg
    from portbench.reference.container.reader import HeifReader, parse_grid_config

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
