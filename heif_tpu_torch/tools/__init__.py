"""Measurement tools of the port (ports of bench.py, tools/bench_burst.py
and tools/bench_device_entropy.py), run as

    python -m heif_tpu_torch.tools.bench_e2e [image.heic] [--window S]
                                             [--readback-window S]
    python -m heif_tpu_torch.tools.bench_burst [image.heic] [n_images]
    python -m heif_tpu_torch.tools.bench_device_entropy [image.heic] [--gen]

Each runs on the card by default and takes `--device cpu` for the plain
PyTorch path (a small image and, for bench_e2e, `--window 0
--readback-window 0`: one rep a window). bench.py itself still runs only
the JAX package. Each splits its body into functions that return the
JSON line's dict, so chip_smoke.py and the tests call them without a
subprocess.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

DEFAULT_IMAGE = str(Path(__file__).resolve().parents[2] / "tests" / "assets"
                    / "halfmoonbay.heic")


@dataclass
class ParsedImage:
    """The primary item of a HEIF file, parsed down to its parameter sets:
    the reader, the container, the primary item's id, its GridConfig (None
    for a single coded item), the ids of the items holding its slices (the
    grid's tiles in grid order, or the item itself) and the hvcC record's
    NAL length size."""

    reader: object
    heif: object
    primary: int
    sps: object
    pps: object
    grid: object
    tile_ids: list
    length_size: int


def parse_image(data: bytes) -> ParsedImage:
    """Container, hvcC record and parameter sets of the primary item (in
    the span hdr)."""
    from heif_tpu_torch.container import grammar as g
    from heif_tpu_torch.container.reader import HeifReader, parse_grid_config
    from heif_tpu_torch.hevc import params
    from heif_tpu_torch.hevc.rbsp import remove_emulation_prevention
    from heif_tpu_torch.utils.profiling import span

    with span("hdr"):
        reader = HeifReader(data)
        heif = reader.read()
        primary = heif.primary_item_id()
        info = heif.item_info_by_item_id(primary)
        grid = None
        tile_ids = [primary]
        if info is not None and info.item_type == g.ItemType.GRID:
            grid = parse_grid_config(reader.get_item_data(primary))
            tile_ids = heif.item_ids_referencing(primary, "dimg")
        rec = heif.hevc_configuration_record(tile_ids[0])
        if rec is None:
            raise ValueError(f"item {tile_ids[0]} has no hvcC record")
        sps = params.parse_sps(
            remove_emulation_prevention(rec.nal_units_of_type(33)[0][2:]))
        pps = params.parse_pps(
            remove_emulation_prevention(rec.nal_units_of_type(34)[0][2:]))
    return ParsedImage(reader, heif, primary, sps, pps, grid, tile_ids,
                       rec.length_size_minus_one + 1)


def item_slices(img: ParsedImage) -> list:
    """The parsed slice header of each item of img.tile_ids, in order. NAL
    units are split with the hvcC record's length size and each item's one
    VCL NAL is picked by models.decoder._select_vcl_nal, as
    HeicDecoder.decode does (in the span hdr)."""
    from heif_tpu_torch.hevc import slice as sl
    from heif_tpu_torch.models.decoder import _select_vcl_nal
    from heif_tpu_torch.utils.profiling import span

    with span("hdr"):
        return [
            sl.parse_slice_header(_select_vcl_nal(
                sl.split_length_prefixed_nals(img.reader.get_item_data(t),
                                              img.length_size)),
                img.sps, img.pps)
            for t in img.tile_ids
        ]


def image_slices(data: bytes):
    """(sps, pps, slices, megapixels) of the primary item of a HEIF file:
    the parsed slice header of each grid tile, in grid order, or of the
    item itself (item_slices). megapixels is the grid's output size, or
    the coded picture's for a single item."""
    img = parse_image(data)
    sps = img.sps
    if img.grid is not None:
        mp = img.grid.output_width * img.grid.output_height / 1e6
    else:
        mp = sps.pic_width_in_luma_samples * sps.pic_height_in_luma_samples / 1e6
    return sps, img.pps, item_slices(img), mp
