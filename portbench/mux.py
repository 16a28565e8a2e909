"""HEIF/HEIC muxing for the benchmark's inputs.

mux_heic is a frozen copy of heif_tpu_torch/utils/heif_mux.py (logic
unchanged; the benchmark's tests use it to build small grid images).
permute_grid re-muxes a grid image so that its tiles sit in another
order: every box of the source is kept byte for byte except the grid's
`dimg` reference list, the `iloc` extents and the `mdat` payload order,
so the same tile payloads, with the same hvcC, ispe, irot and colr
properties, make a different picture. renumber_item gives a file's
primary item another id and changes nothing else that a decoder reads:
the same coded picture in a file of other bytes.
"""

from __future__ import annotations

import struct

from portbench.reference.hevc import params as hevc_params
from portbench.reference.hevc.rbsp import remove_emulation_prevention
from portbench.reference.hevc.slice import split_annexb_nals


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


def _children(buf: bytes, lo: int, hi: int) -> list[tuple[bytes, int, int, int]]:
    """(fourcc, start, header size, total size) of each box in buf[lo:hi]."""
    out = []
    pos = lo
    while pos < hi:
        size, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        hdr = 8
        if size == 1:
            (size,) = struct.unpack(">Q", buf[pos + 8:pos + 16])
            hdr = 16
        elif size == 0:
            size = hi - pos
        if size < hdr or pos + size > hi:
            raise ValueError(f"box {kind!r} at {pos} overruns its parent")
        out.append((kind, pos, hdr, size))
        pos += size
    return out


def _uint(buf: bytes, pos: int, n: int) -> int:
    return int.from_bytes(buf[pos:pos + n], "big") if n else 0


def _parse_iloc(body: bytes):
    """ISO/IEC 14496-12 §8.11.3 ItemLocationBox (versions 0-2): (version,
    sizes, [(item_id, method, dref, base, [(index, offset, length)])])."""
    version = body[0]
    off_sz, len_sz = body[4] >> 4, body[4] & 15
    base_sz, idx_sz = body[5] >> 4, (body[5] & 15) if version else 0
    pos = 6
    id_sz = 2 if version < 2 else 4
    count = _uint(body, pos, id_sz)
    pos += id_sz
    items = []
    for _ in range(count):
        item_id = _uint(body, pos, id_sz)
        pos += id_sz
        method = 0
        if version:
            method = _uint(body, pos, 2) & 15
            pos += 2
        dref = _uint(body, pos, 2)
        pos += 2
        base = _uint(body, pos, base_sz)
        pos += base_sz
        n_ext = _uint(body, pos, 2)
        pos += 2
        exts = []
        for _ in range(n_ext):
            idx = _uint(body, pos, idx_sz)
            pos += idx_sz
            off = _uint(body, pos, off_sz)
            pos += off_sz
            ln = _uint(body, pos, len_sz)
            pos += len_sz
            exts.append((idx, off, ln))
        items.append((item_id, method, dref, base, exts))
    if pos != len(body):
        raise ValueError("iloc: trailing bytes")
    return version, (off_sz, len_sz, base_sz, idx_sz, id_sz), items


def _write_iloc(head: bytes, version: int, sizes, items) -> bytes:
    off_sz, len_sz, base_sz, idx_sz, id_sz = sizes
    out = bytearray(head)  # version, flags and the two size bytes
    out += len(items).to_bytes(id_sz, "big")
    for item_id, method, dref, base, exts in items:
        out += item_id.to_bytes(id_sz, "big")
        if version:
            out += method.to_bytes(2, "big")
        out += dref.to_bytes(2, "big") + base.to_bytes(base_sz, "big")
        out += len(exts).to_bytes(2, "big")
        for idx, off, ln in exts:
            out += (idx.to_bytes(idx_sz, "big") + off.to_bytes(off_sz, "big")
                    + ln.to_bytes(len_sz, "big"))
    return bytes(out)


def _permute_iref(body: bytes, grid_id: int, perm) -> bytes:
    """The iref body with the grid item's dimg list reordered so that
    position i holds the item that was at position perm[i]."""
    version = body[0]
    id_sz = 2 if version == 0 else 4
    out = bytearray(body[:4])
    for kind, pos, hdr, size in _children(body, 4, len(body)):
        box = bytearray(body[pos:pos + size])
        p = hdr
        src = _uint(box, p, id_sz)
        if kind == b"dimg" and src == grid_id:
            n = _uint(box, p + id_sz, 2)
            ids_at = p + id_sz + 2
            ids = [_uint(box, ids_at + i * id_sz, id_sz) for i in range(n)]
            if sorted(perm) != list(range(n)):
                raise ValueError(f"perm is not a permutation of {n} tiles")
            box[ids_at:ids_at + n * id_sz] = b"".join(
                ids[j].to_bytes(id_sz, "big") for j in perm)
        out += box
    return bytes(out)


def permute_grid(data: bytes, perm) -> bytes:
    """The grid image `data` with tile i taken from the source's tile
    perm[i]. Each item keeps its id, properties and payload bytes; the
    mdat holds the tiles' payloads in their new grid order, then every
    other item's data (thumbnails, Exif) in the source's order."""
    top = _children(data, 0, len(data))
    meta = [b for b in top if b[0] == b"meta"]
    mdats = [b for b in top if b[0] == b"mdat"]
    if len(meta) != 1 or not mdats:
        raise ValueError("need one meta box and an mdat")
    _, mpos, mhdr, msize = meta[0]
    kids = _children(data, mpos + mhdr + 4, mpos + msize)
    pitm = [b for b in kids if b[0] == b"pitm"][0]
    pv = data[pitm[1] + pitm[2]]
    grid_id = _uint(data, pitm[1] + pitm[2] + 4, 2 if pv == 0 else 4)

    parts = {}
    for kind, pos, hdr, size in kids:
        parts[kind] = (pos, hdr, size)
    ipos, ihdr, isize = parts[b"iref"]
    iref_body = _permute_iref(data[ipos + ihdr:ipos + isize], grid_id, perm)
    lpos, lhdr, lsize = parts[b"iloc"]
    version, sizes, items = _parse_iloc(data[lpos + lhdr:lpos + lsize])

    # the new grid order of the tile items, from the permuted iref
    id_sz = 2 if iref_body[0] == 0 else 4
    order = []
    for kind, pos, hdr, size in _children(iref_body, 4, len(iref_body)):
        if kind == b"dimg" and _uint(iref_body, pos + hdr, id_sz) == grid_id:
            n = _uint(iref_body, pos + hdr + id_sz, 2)
            at = pos + hdr + id_sz + 2
            order = [_uint(iref_body, at + i * id_sz, id_sz) for i in range(n)]
    rank = {item_id: i for i, item_id in enumerate(order)}

    # mdat payload starts where the source's first mdat body starts: the
    # meta box keeps its size (iref and iloc keep theirs)
    first = mdats[0]
    payload_at = first[1] + first[2]
    in_file = [it for it in items if it[1] == 0 and it[4]]
    in_file.sort(key=lambda it: (rank.get(it[0], len(rank)),
                                 min(e[1] + it[3] for e in it[4])))
    blob = bytearray()
    placed = {}
    for item_id, method, dref, base, exts in in_file:
        new_exts = []
        for idx, off, ln in exts:
            new_exts.append((idx, payload_at + len(blob), ln))
            blob += data[base + off:base + off + ln]
        placed[item_id] = (item_id, method, dref, 0, new_exts)
    items = [placed.get(it[0], it) for it in items]
    iloc_body = _write_iloc(data[lpos + lhdr:lpos + lhdr + 6], version,
                            sizes, items)
    if len(iloc_body) != lsize - lhdr or len(iref_body) != isize - ihdr:
        raise ValueError("a rewritten box changed size")

    out = bytearray()
    for kind, pos, hdr, size in top:
        if kind == b"meta":
            box = bytearray(data[pos:pos + size])
            box[ipos - pos + ihdr:ipos - pos + isize] = iref_body
            box[lpos - pos + lhdr:lpos - pos + lsize] = iloc_body
            out += box
        elif kind == b"mdat":
            if pos == first[1]:
                if len(out) + first[2] != payload_at:
                    raise ValueError("boxes before the mdat moved")
                out += _box(b"mdat", bytes(blob)) if first[2] == 8 else (
                    struct.pack(">I4sQ", 1, b"mdat", 16 + len(blob)) + blob)
        else:
            out += data[pos:pos + size]
    return bytes(out)


def renumber_item(data: bytes, new_id: int) -> bytes:
    """`data` with its primary item's id changed to new_id, and an item
    that had new_id given the primary's old id: the ids in pitm, iinf,
    iref, ipma and iloc are rewritten at their own widths, so every box
    keeps its size and the mdat, the properties and the payloads stay
    byte for byte."""
    top = _children(data, 0, len(data))
    meta = [b for b in top if b[0] == b"meta"]
    if len(meta) != 1:
        raise ValueError("need one meta box")
    _, mpos, mhdr, msize = meta[0]
    kids = {k: (pos, hdr, size)
            for k, pos, hdr, size in _children(data, mpos + mhdr + 4,
                                               mpos + msize)}
    out = bytearray(data)
    pos, hdr, _ = kids[b"pitm"]
    pitm_sz = 2 if data[pos + hdr] == 0 else 4
    old = _uint(data, pos + hdr + 4, pitm_sz)
    swap = {old: new_id, new_id: old}

    def put(at: int, n: int) -> None:
        item = _uint(out, at, n)
        if item in swap:
            if swap[item] >= 1 << (8 * n) or swap[item] < 1:
                raise ValueError(f"item id {swap[item]} does not fit {n} bytes")
            out[at:at + n] = swap[item].to_bytes(n, "big")

    put(pos + hdr + 4, pitm_sz)
    pos, hdr, size = kids[b"iinf"]
    body = pos + hdr
    count_sz = 2 if data[body] == 0 else 4
    for kind, p, h, _ in _children(data, body + 4 + count_sz, pos + size):
        if kind == b"infe":
            put(p + h + 4, 4 if data[p + h] >= 3 else 2)
    if b"iref" in kids:
        pos, hdr, size = kids[b"iref"]
        id_sz = 2 if data[pos + hdr] == 0 else 4
        for _, p, h, _ in _children(data, pos + hdr + 4, pos + size):
            put(p + h, id_sz)
            for i in range(_uint(data, p + h + id_sz, 2)):
                put(p + h + id_sz + 2 + i * id_sz, id_sz)
    pos, hdr, size = kids[b"iprp"]
    for kind, p, h, _ in _children(data, pos + hdr, pos + size):
        if kind != b"ipma":
            continue
        version, flags = data[p + h], _uint(data, p + h + 1, 3)
        id_sz, assoc_sz = (4 if version else 2), (2 if flags & 1 else 1)
        at = p + h + 8
        for _ in range(_uint(data, p + h + 4, 4)):
            put(at, id_sz)
            at += id_sz + 1 + data[at + id_sz] * assoc_sz
    pos, hdr, size = kids[b"iloc"]
    version, sizes, items = _parse_iloc(data[pos + hdr:pos + size])
    items = [(swap.get(i, i), *rest) for i, *rest in items]
    body = _write_iloc(data[pos + hdr:pos + hdr + 6], version, sizes, items)
    if len(body) != size - hdr:
        raise ValueError("iloc changed size")
    out[pos + hdr:pos + size] = body
    return bytes(out)
