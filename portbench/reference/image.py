"""The reference's whole-image decode: container, every tile, then the
crop, the grid stitch and the irot rotation (ISO/IEC 23008-12 §6.6.2.3
grid, §6.5.10 irot), written here on their own, apart from the program.

Tiles are independent HEVC pictures, so decode_tile takes one tile's
parameter sets and payload and can run in a worker process.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.reference.cabac.syntax import TileSyntaxDecoder
from portbench.reference.container import grammar as g
from portbench.reference.container.reader import HeifReader, parse_grid_config
from portbench.reference.hevc import params
from portbench.reference.hevc import slice as sl
from portbench.reference.hevc.rbsp import remove_emulation_prevention
from portbench.reference.ops.ref_recon import reconstruct_tile


@dataclass
class Picture:
    """What the reference reads off a HEIF file's primary item: the hvcC
    SPS and PPS NAL units, the NAL length size, each tile's payload in
    grid order (one entry for a single coded item), the grid's rows and
    columns, the output size, the crop origin (the conformance window's
    for a single item) and the irot angle (quarter turns, anticlockwise)."""

    sps_nal: bytes
    pps_nal: bytes
    length_size: int
    tiles: list
    rows: int
    columns: int
    out_w: int
    out_h: int
    crop: tuple
    angle: int


def parse(data: bytes) -> Picture:
    reader = HeifReader(data)
    heif = reader.read()
    primary = heif.primary_item_id()
    info = heif.item_info_by_item_id(primary)
    props = heif.meta.item_properties
    if info is not None and info.item_type == g.ItemType.GRID:
        grid = parse_grid_config(reader.get_item_data(primary))
        ids = heif.item_ids_referencing(primary, "dimg")
        rows, cols = grid.rows, grid.columns
        out_w, out_h = grid.output_width, grid.output_height
    else:
        ids, rows, cols = [primary], 1, 1
        out_w = out_h = None
    rec = heif.hevc_configuration_record(ids[0])
    sps_nal = rec.nal_units_of_type(33)[0]
    pps_nal = rec.nal_units_of_type(34)[0]
    crop = (0, 0)
    if out_w is None:
        sps = params.parse_sps(remove_emulation_prevention(sps_nal[2:]))
        sub = 2 if sps.chroma_format_idc == 1 else 1
        crop = (sub * sps.conf_win_left_offset, sub * sps.conf_win_top_offset)
        ispe = props.property_of_type(primary, g.ImageSpatialExtentsProperty)
        if ispe is not None:
            out_w, out_h = ispe.width, ispe.height
        else:
            out_w = sps.pic_width_in_luma_samples - sub * (
                sps.conf_win_left_offset + sps.conf_win_right_offset)
            out_h = sps.pic_height_in_luma_samples - sub * (
                sps.conf_win_top_offset + sps.conf_win_bottom_offset)
    irot = props.property_of_type(primary, g.ImageRotationProperty)
    return Picture(sps_nal, pps_nal, rec.length_size_minus_one + 1,
                   [reader.get_item_data(t) for t in ids], rows, cols,
                   out_w, out_h, crop, irot.angle if irot else 0)


def tile_syntax(sps_nal: bytes, pps_nal: bytes, payload: bytes,
                length_size: int):
    """(sps, pps, parsed slice, SyntaxTensors) of one tile: its one VCL
    NAL unit entropy-decoded by the Python CABAC decoder."""
    sps = params.parse_sps(remove_emulation_prevention(sps_nal[2:]))
    pps = params.parse_pps(remove_emulation_prevention(pps_nal[2:]))
    vcl = [n for n in sl.split_length_prefixed_nals(payload, length_size)
           if ((n[0] >> 1) & 0x3F) <= 31]
    if len(vcl) != 1:
        raise ValueError(f"tile holds {len(vcl)} VCL NAL units, not 1")
    ps = sl.parse_slice_header(vcl[0], sps, pps)
    return sps, pps, ps, TileSyntaxDecoder(sps, pps, ps).decode()


def reconstruct(sps, pps, ps, st) -> list:
    """[Y, Cb, Cr] planes of a tile (uint8, or uint16 above 8 bits; Cb
    and Cr None for 4:0:0)."""
    planes = reconstruct_tile(st, sps, pps, ps.header)
    if sps.chroma_format_idc == 0:
        return [planes[0], None, None]
    return planes


def assemble(tiles: list, pic: Picture, rotate: bool = True) -> dict:
    """The output image of decoded tiles in grid order: stitched row by
    row, cropped to the output size at the crop origin, then turned by
    the irot angle (numpy's rot90 turns anticlockwise, as irot does)."""
    th, tw = tiles[0][0].shape
    out = {}
    for c, name in enumerate(("Y", "Cb", "Cr")):
        if tiles[0][c] is None:
            out[name] = None
            continue
        sub_y = th // tiles[0][c].shape[0]
        sub_x = tw // tiles[0][c].shape[1]
        rows = [np.concatenate(
            [t[c] for t in tiles[r * pic.columns:(r + 1) * pic.columns]],
            axis=1) for r in range(pic.rows)]
        canvas = np.concatenate(rows, axis=0)
        x0, y0 = pic.crop[0] // sub_x, pic.crop[1] // sub_y
        plane = canvas[y0:y0 + pic.out_h // sub_y, x0:x0 + pic.out_w // sub_x]
        if rotate and pic.angle:
            plane = np.rot90(plane, k=pic.angle)
        out[name] = np.ascontiguousarray(plane)
    return out
