"""Raw Annex-B HEVC streams from HEIF tiles.

    from heif_tpu_torch.utils.annexb import tile_annexb
    open("tile1.hevc", "wb").write(
        tile_annexb(open("tests/assets/halfmoonbay.heic", "rb").read(), 1))

A tile of a grid image is a complete single-picture HEVC stream once the
parameter sets of the hvcC record (VPS, SPS, PPS) and the tile's slice
NAL units are each prefixed with a 00 00 00 01 start code (as
heif_tpu/utils/oracle.py:decode_tile_nals builds it for libde265).
"""

from __future__ import annotations

from heif_tpu_torch.container.reader import HeifReader
from heif_tpu_torch.hevc import slice as sl

START = b"\x00\x00\x00\x01"


def tile_annexb(data: bytes, index: int) -> bytes:
    """Annex-B stream of tile `index` (in grid order) of the primary item;
    for a non-grid primary item, index 0 is the item itself."""
    reader = HeifReader(data)
    heif = reader.read()
    primary = heif.primary_item_id()
    tiles = heif.item_ids_referencing(primary, "dimg") or [primary]
    tid = tiles[index]
    rec = heif.hevc_configuration_record(tid)
    if rec is None:
        raise ValueError(f"item {tid} has no hvcC record")
    nals = [n for t in (32, 33, 34) for n in rec.nal_units_of_type(t)]
    nals += sl.split_length_prefixed_nals(
        reader.get_item_data(tid), rec.length_size_minus_one + 1)
    return b"".join(START + bytes(n) for n in nals)
