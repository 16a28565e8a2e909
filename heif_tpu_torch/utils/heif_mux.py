"""Minimal HEIF/HEIC muxer: wrap HEVC Annex-B intra streams in an ISOBMFF
container (the port's copy of heif_tpu.utils.heif_mux, logic unchanged,
held against it in tests/test_torch_copies.py).

Test-only utility (the decode path never writes containers): lets the
fixture suite build real .heic files around x265/synthesized bitstreams,
so container-level behavior — 10-bit stitch dtypes, monochrome aux-style
items, multi-NAL items, grid+idat geometry — is exercised through the
full HeicDecoder.decode() API instead of only via raw decode_hevc().

Writes the box set the reader requires (container/reader.py; parity with
the reference reader's grammar, src/heif/reader.rs):
ftyp, meta(hdlr 'pict', pitm, iinf/infe v2, [iref dimg], iprp(ipco:
ispe+hvcC, ipma), iloc v0, [idat]), mdat. Grid images use idat
construction (construction_method 1) exactly like Apple HEICs — the
reference's todo! path (src/heif/reader.rs:42).
"""

from __future__ import annotations

import struct

from heif_tpu_torch.hevc import params as hevc_params
from heif_tpu_torch.hevc.rbsp import remove_emulation_prevention
from heif_tpu_torch.hevc.slice import split_annexb_nals


def _box(fourcc: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + fourcc + payload


def _full(fourcc: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(fourcc, struct.pack(">I", (version << 24) | flags) + payload)


def _classify_nals(stream: bytes):
    """Split an Annex-B stream into (vps, sps, pps, others) NAL lists."""
    vps, sps, pps, others = [], [], [], []
    for nal in split_annexb_nals(stream):
        kind = (nal[0] >> 1) & 0x3F
        if kind == 32:
            vps.append(nal)
        elif kind == 33:
            sps.append(nal)
        elif kind == 34:
            pps.append(nal)
        else:
            others.append(nal)
    if not sps or not pps:
        raise ValueError("stream lacks SPS/PPS")
    return vps, sps, pps, others


def _hvcc(vps, sps_nals, pps, sps) -> bytes:
    """HEVCDecoderConfigurationRecord (ISO/IEC 14496-15 §8.3.3.1)."""
    ptl = sps.profile_tier_level
    out = bytearray()
    out.append(1)  # configurationVersion
    out.append(
        (ptl.general_profile_space << 6)
        | (getattr(ptl, "general_tier_flag", 0) << 5)
        | (ptl.general_profile_idc & 0x1F)
    )
    out += struct.pack(">I", ptl.general_profile_compatibility_flags)
    out += b"\x00" * 6  # constraint flags
    out.append(getattr(ptl, "general_level_idc", 93))
    out += struct.pack(">H", 0xF000)  # min_spatial_segmentation_idc = 0
    out.append(0xFC | 0)  # parallelism_type
    out.append(0xFC | (sps.chroma_format_idc & 3))
    out.append(0xF8 | (sps.bit_depth_luma_minus8 & 7))
    out.append(0xF8 | (sps.bit_depth_chroma_minus8 & 7))
    out += struct.pack(">H", 0)  # avgFrameRate
    out.append((0 << 6) | (1 << 3) | (1 << 2) | 3)  # lengthSizeMinusOne=3
    arrays = [(32, vps), (33, sps_nals), (34, pps)]
    arrays = [(t, ns) for t, ns in arrays if ns]
    out.append(len(arrays))
    for nal_type, nals in arrays:
        out.append(0x80 | nal_type)  # array_completeness=1
        out += struct.pack(">H", len(nals))
        for n in nals:
            out += struct.pack(">H", len(n)) + n
    return bytes(out)


def _infe(item_id: int, fourcc: bytes, hidden: bool = False) -> bytes:
    return _full(
        b"infe",
        2,
        1 if hidden else 0,
        struct.pack(">HH", item_id, 0) + fourcc + b"\x00",
    )


def _item_payload(nals: list[bytes]) -> bytes:
    """4-byte length-prefixed NAL concatenation (lengthSizeMinusOne=3)."""
    return b"".join(struct.pack(">I", len(n)) + n for n in nals)


def mux_heic(
    streams: list[bytes],
    grid: tuple[int, int, int, int] | None = None,
    irot: int = 0,
    extra_item_nals: list[bytes] | None = None,
) -> bytes:
    """Build a .heic container around one or more Annex-B intra streams.

    streams: one stream per hvc1 item. With grid=(rows, cols, out_w,
    out_h), the items become tiles of a grid primary item whose config
    ships in idat (construction_method 1, Apple-style). extra_item_nals:
    additional NALs (e.g. SEI) stored BEFORE the slice NAL of item 1, to
    exercise multi-NAL item handling.
    """
    vps, sps_nals, pps, _ = _classify_nals(streams[0])
    sps = hevc_params.parse_sps(remove_emulation_prevention(sps_nals[0][2:]))

    payloads = []
    for i, s in enumerate(streams):
        _, _, _, others = _classify_nals(s)
        nals = list(extra_item_nals or []) if i == 0 else []
        nals += others
        payloads.append(_item_payload(nals))

    n_tiles = len(streams)
    tile_ids = list(range(1, n_tiles + 1))
    grid_id = n_tiles + 1 if grid else None
    primary = grid_id if grid else tile_ids[0]

    # --- iprp ---
    # ispe carries the DISPLAY size: coded dims minus the SPS
    # conformance window (offsets are in chroma units for 4:2:0)
    sub = 2 if sps.chroma_format_idc == 1 else 1
    w = sps.pic_width_in_luma_samples - sub * (
        sps.conf_win_left_offset + sps.conf_win_right_offset
    )
    h = sps.pic_height_in_luma_samples - sub * (
        sps.conf_win_top_offset + sps.conf_win_bottom_offset
    )
    props = []  # 1-based order in ipco
    props.append(_full(b"ispe", 0, 0, struct.pack(">II", w, h)))  # 1: tile
    props.append(_box(b"hvcC", _hvcc(vps, sps_nals, pps, sps)))  # 2
    assoc = {tid: [(1, False), (2, True)] for tid in tile_ids}
    if grid:
        rows, cols, ow, oh = grid
        props.append(
            _full(b"ispe", 0, 0, struct.pack(">II", ow, oh))
        )  # 3: grid
        assoc[grid_id] = [(3, False), (2, True)]
    if irot:
        props.append(_box(b"irot", bytes([irot & 3])))
        assoc[primary] = assoc.get(primary, []) + [(len(props), False)]
    ipco = _box(b"ipco", b"".join(props))
    ipma_entries = b""
    for item_id in sorted(assoc):
        lst = assoc[item_id]
        ipma_entries += struct.pack(">HB", item_id, len(lst))
        for idx, essential in lst:
            ipma_entries += bytes([(0x80 if essential else 0) | idx])
    ipma = _full(
        b"ipma", 0, 0, struct.pack(">I", len(assoc)) + ipma_entries
    )
    iprp = _box(b"iprp", ipco + ipma)

    # --- iinf ---
    infes = [_infe(tid, b"hvc1", hidden=bool(grid)) for tid in tile_ids]
    if grid:
        infes.append(_infe(grid_id, b"grid"))
    iinf = _full(
        b"iinf", 0, 0, struct.pack(">H", len(infes)) + b"".join(infes)
    )

    # --- iref (grid only) ---
    iref = b""
    if grid:
        single = _box(
            b"dimg",
            struct.pack(">HH", grid_id, n_tiles)
            + b"".join(struct.pack(">H", t) for t in tile_ids),
        )
        iref = _full(b"iref", 0, 0, single)

    # --- idat (grid config) ---
    idat = b""
    if grid:
        rows, cols, ow, oh = grid
        idat = _box(
            b"idat",
            bytes([0, 0, rows - 1, cols - 1]) + struct.pack(">HH", ow, oh),
        )

    hdlr = _full(
        b"hdlr", 0, 0, struct.pack(">I", 0) + b"pict" + b"\x00" * 13
    )
    pitm = _full(b"pitm", 0, 0, struct.pack(">H", primary))

    # --- iloc: needs absolute mdat offsets; assemble with placeholder.
    # Grid containers use v1 (the grid config ships in idat via
    # construction_method 1); single-item containers use v0. ---
    version = 1 if grid else 0

    def build_iloc(mdat_payload_off: int) -> bytes:
        body = bytearray()
        body.append((4 << 4) | 4)  # offset_size=4, length_size=4
        body.append(0)  # base_offset_size=0 (index_size=0 for v1)
        n_items = n_tiles + (1 if grid else 0)
        body += struct.pack(">H", n_items)
        off = mdat_payload_off
        for tid in tile_ids:
            pl = payloads[tid - 1]
            if version == 1:
                # id, construction_method, dref, extent_count
                body += struct.pack(">HHHH", tid, 0, 0, 1)
            else:
                body += struct.pack(">HHH", tid, 0, 1)  # id, dref, extents
            body += struct.pack(">II", off, len(pl))
            off += len(pl)
        if grid:
            # grid config lives in idat: construction_method 1
            body += struct.pack(">HHHH", grid_id, 1, 0, 1)
            body += struct.pack(">II", 0, 8)
        return _full(b"iloc", version, 0, bytes(body))

    ftyp = _box(b"ftyp", b"heic" + struct.pack(">I", 0) + b"mif1heic")

    def assemble(iloc: bytes) -> tuple[bytes, int]:
        meta = _full(
            b"meta",
            0,
            0,
            hdlr + pitm + iinf + iref + iprp + iloc + idat,
        )
        head = ftyp + meta
        return head, len(head) + 8  # +8: mdat header

    # two passes: iloc size is offset-independent (fixed 4-byte fields)
    _, payload_off = assemble(build_iloc(0))
    iloc = build_iloc(payload_off)
    head, payload_off2 = assemble(iloc)
    assert payload_off == payload_off2
    mdat = _box(b"mdat", b"".join(payloads))
    return head + mdat
