"""ISOBMFF box-tree reader: recursive-descent parse of a HEIF container.

Host-side, zero-copy over a memoryview. Parity target: reference
src/heif/reader.rs:1-865, with the same strict size-accounting semantics
(every box body must consume exactly its declared size) and unknown-box
skipping — plus the two capabilities the reference leaves as todo!():
idat-constructed items (construction_method 1, src/heif/reader.rs:42) and
multi-extent concatenation (src/heif/reader.rs:47). Both are load-bearing
for real Apple HEIC files, whose grid config ships in idat.

This module is the canonical host path. Container parse is KB-scale and
off the critical path (the C++ code in heif_tpu_torch/native accelerates the
entropy stage, not box walking).
"""

from __future__ import annotations

import logging
import struct
from typing import Callable, Optional

from portbench.reference.container import grammar as g

log = logging.getLogger(__name__)


class BoxParseError(ValueError):
    pass


# Box fourcc constants
_CONTAINERS_HANDLED = {
    b"ftyp",
    b"meta",
    b"hdlr",
    b"pitm",
    b"iinf",
    b"infe",
    b"iref",
    b"iprp",
    b"ipco",
    b"ipma",
    b"iloc",
    b"idat",
    b"dinf",
    b"dref",
}


class _Cursor:
    """Big-endian byte cursor (reference src/impl_read.rs:1-13 +
    src/heif/reader.rs:806-864)."""

    __slots__ = ("data", "pos")

    def __init__(self, data: memoryview, pos: int = 0):
        self.data = data
        self.pos = pos

    def remaining(self) -> int:
        return len(self.data) - self.pos

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise BoxParseError(
                f"out of bounds read: need {n} bytes at {self.pos}, "
                f"have {len(self.data)}"
            )
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def read_u8(self) -> int:
        return self._take(1)[0]

    def read_u16(self) -> int:
        return struct.unpack(">H", self._take(2))[0]

    def read_u24(self) -> int:
        b = self._take(3)
        return (b[0] << 16) | (b[1] << 8) | b[2]

    def read_u32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def read_u64(self) -> int:
        return struct.unpack(">Q", self._take(8))[0]

    def read_uint(self, nbytes: int) -> int:
        """Variable-width big-endian read (reference read_variable_size,
        src/heif/reader.rs:706-713). nbytes in {0,1,2,3,4,8}; 0 → 0."""
        if nbytes == 0:
            return 0
        b = self._take(nbytes)
        v = 0
        for byte in b:
            v = (v << 8) | byte
        return v

    def read_fourcc(self) -> str:
        return bytes(self._take(4)).decode("latin-1")

    def read_slice(self, n: int) -> memoryview:
        return self._take(n)

    def read_cstring(self, limit: int) -> str:
        """NUL-terminated UTF-8 string, at most `limit` bytes ahead."""
        end = self.pos
        hard_end = min(len(self.data), self.pos + limit)
        while end < hard_end and self.data[end] != 0:
            end += 1
        s = bytes(self.data[self.pos : end]).decode("utf-8", errors="replace")
        # consume the terminator if present
        self.pos = min(end + 1, hard_end)
        return s


class HeifReader:
    """Parses a HEIF container and resolves item payloads.

    Usage (mirrors reference src/heif/reader.rs:25-57):
        reader = HeifReader(data)
        heif = reader.read()
        payload = reader.get_item_data(item_id)
    """

    def __init__(self, data: bytes | memoryview):
        self._raw = data if isinstance(data, memoryview) else memoryview(data)
        self._cur = _Cursor(self._raw)
        self.box_stack: list[str] = []  # parse breadcrumb for diagnostics
        self._heif: Optional[g.Heif] = None

    # ------------------------------------------------------------------
    # Top level
    # ------------------------------------------------------------------

    def read(self) -> g.Heif:
        ftyp = None
        meta = None
        while self._cur.remaining() >= 8:
            kind, body, _header_len = self._next_box(self._cur)
            if kind == "ftyp":
                ftyp = self._read_ftyp(body)
            elif kind == "meta":
                meta = self._read_meta(body)
            elif kind in ("mdat", "free", "skip"):
                pass  # payload containers; resolved via iloc absolute offsets
            else:
                self._diag_skip(kind)
        if ftyp is None:
            raise BoxParseError("missing ftyp box")
        if meta is None:
            raise BoxParseError("missing meta box")
        self._heif = g.Heif(file_type=ftyp, meta=meta)
        return self._heif

    # ------------------------------------------------------------------
    # Item payload resolution (implements the reference's two todo!()s:
    # construction_method 1 / idat and multi-extent concat,
    # src/heif/reader.rs:33-57)
    # ------------------------------------------------------------------

    def get_item_data(self, item_id: int) -> bytes:
        if self._heif is None:
            self.read()
        heif = self._heif
        assert heif is not None
        loc = heif.meta.item_locations.locations.get(item_id)
        if loc is None:
            raise BoxParseError(f"no iloc entry for item {item_id}")
        if loc.data_reference_index != 0:
            raise BoxParseError(
                f"item {item_id}: external data references unsupported"
            )
        if loc.construction_method == 0:
            source: memoryview | bytes = self._raw
        elif loc.construction_method == 1:
            source = heif.meta.idat
        else:
            raise BoxParseError(
                f"item {item_id}: construction_method 2 (item offsets) unsupported"
            )
        parts = []
        for ext in loc.extents:
            start = loc.base_offset + ext.extent_offset
            length = ext.extent_length
            if length == 0:  # 0 → to end of source
                length = len(source) - start
            if start + length > len(source):
                raise BoxParseError(
                    f"item {item_id}: extent [{start}, {start + length}) out of "
                    f"bounds (source {len(source)} bytes)"
                )
            parts.append(bytes(source[start : start + length]))
        return b"".join(parts)

    # ------------------------------------------------------------------
    # Box framing
    # ------------------------------------------------------------------

    def _next_box(self, cur: _Cursor) -> tuple[str, _Cursor, int]:
        """Read one box header; return (fourcc, body cursor, header bytes).

        Handles u32 size, largesize (size==1), size==0 (to end), and uuid
        usertype skipping (reference read_box_header,
        src/heif/reader.rs:806-819). The body cursor is bounded to exactly
        the declared payload, giving the strict size accounting the
        reference enforces via ensure! (src/heif/reader.rs:757,775,791).
        """
        start = cur.pos
        size = cur.read_u32()
        kind = cur.read_fourcc()
        header = 8
        if size == 1:
            size = cur.read_u64()
            header += 8
        elif size == 0:
            size = len(cur.data) - start
        if kind == "uuid":
            cur.read_slice(16)
            header += 16
        if size < header:
            raise BoxParseError(f"box '{kind}' declares size {size} < header")
        body_len = size - header
        body = _Cursor(cur.read_slice(body_len))
        return kind, body, header

    def _read_version_flags(self, cur: _Cursor) -> g.VersionFlags:
        return g.VersionFlags(version=cur.read_u8(), flags=cur.read_u24())

    def _finish(self, kind: str, cur: _Cursor) -> None:
        """Strict size accounting: the body must be fully consumed."""
        if cur.remaining() != 0:
            raise BoxParseError(
                f"box '{kind}' ({'>'.join(self.box_stack)}): "
                f"{cur.remaining()} unconsumed bytes"
            )

    def _diag_skip(self, kind: str) -> None:
        log.debug("skipping unhandled box '%s' at %s", kind, ">".join(self.box_stack))

    def _with_box(self, kind: str, cur: _Cursor, body_fn: Callable[[_Cursor], object]):
        self.box_stack.append(kind)
        try:
            out = body_fn(cur)
            self._finish(kind, cur)
            return out
        finally:
            self.box_stack.pop()

    # ------------------------------------------------------------------
    # Individual boxes
    # ------------------------------------------------------------------

    def _read_ftyp(self, cur: _Cursor) -> g.FileTypeBox:
        def body(c: _Cursor) -> g.FileTypeBox:
            major = c.read_fourcc()
            minor = c.read_u32()
            brands = []
            while c.remaining() >= 4:
                brands.append(c.read_fourcc())
            return g.FileTypeBox(major, minor, brands)

        return self._with_box("ftyp", cur, body)

    def _read_meta(self, cur: _Cursor) -> g.MetaBox:
        self.box_stack.append("meta")
        try:
            self._read_version_flags(cur)
            handler = None
            meta = g.MetaBox(handler=g.HandlerBox(handler_type="????"))
            while cur.remaining() >= 8:
                kind, body, _ = self._next_box(cur)
                if kind == "hdlr":
                    handler = self._read_hdlr(body)
                    meta.handler = handler
                elif kind == "pitm":
                    meta.primary_item = self._read_pitm(body)
                elif kind == "iinf":
                    meta.item_info = self._read_iinf(body)
                elif kind == "iref":
                    meta.item_references = self._read_iref(body)
                elif kind == "iprp":
                    meta.item_properties = self._read_iprp(body)
                elif kind == "iloc":
                    meta.item_locations = self._read_iloc(body)
                elif kind == "idat":
                    meta.idat = bytes(body.read_slice(body.remaining()))
                elif kind == "dinf":
                    meta.data_information = self._read_dinf(body)
                else:
                    self._diag_skip(kind)
            if handler is None:
                raise BoxParseError("meta box missing hdlr")
            if handler.handler_type != "pict":
                raise BoxParseError(
                    f"unsupported handler '{handler.handler_type}' (want 'pict')"
                )
            return meta
        finally:
            self.box_stack.pop()

    def _read_hdlr(self, cur: _Cursor) -> g.HandlerBox:
        def body(c: _Cursor) -> g.HandlerBox:
            self._read_version_flags(c)
            c.read_u32()  # pre_defined
            handler_type = c.read_fourcc()
            c.read_u32()
            c.read_u32()
            c.read_u32()  # reserved
            name = c.read_cstring(c.remaining())
            # tolerate trailing bytes after the NUL (some muxers pad)
            c.read_slice(c.remaining())
            return g.HandlerBox(handler_type=handler_type, name=name)

        return self._with_box("hdlr", cur, body)

    def _read_pitm(self, cur: _Cursor) -> g.PrimaryItemBox:
        def body(c: _Cursor) -> g.PrimaryItemBox:
            vf = self._read_version_flags(c)
            item_id = c.read_u16() if vf.version == 0 else c.read_u32()
            return g.PrimaryItemBox(item_id=item_id)

        return self._with_box("pitm", cur, body)

    def _read_iinf(self, cur: _Cursor) -> g.ItemInfoBox:
        self.box_stack.append("iinf")
        try:
            vf = self._read_version_flags(cur)
            count = cur.read_u16() if vf.version == 0 else cur.read_u32()
            entries = []
            for _ in range(count):
                kind, body, _ = self._next_box(cur)
                if kind != "infe":
                    raise BoxParseError(f"expected infe in iinf, got '{kind}'")
                entries.append(self._read_infe(body))
            self._finish("iinf", cur)
            return g.ItemInfoBox(entries=entries)
        finally:
            self.box_stack.pop()

    def _read_infe(self, cur: _Cursor) -> g.ItemInfoEntry:
        def body(c: _Cursor) -> g.ItemInfoEntry:
            vf = self._read_version_flags(c)
            if vf.version < 2:
                raise BoxParseError(f"infe version {vf.version} unsupported")
            item_id = c.read_u16() if vf.version == 2 else c.read_u32()
            protection = c.read_u16()
            fourcc = c.read_fourcc()
            item_type = g.ItemType.from_fourcc(fourcc)
            name = c.read_cstring(c.remaining())
            entry = g.ItemInfoEntry(
                item_id=item_id,
                item_protection_index=protection,
                item_type=item_type,
                item_type_fourcc=fourcc,
                item_name=name,
                hidden=bool(vf.flags & 1),
            )
            if item_type == g.ItemType.MIME:
                entry.content_type = c.read_cstring(c.remaining())
                if c.remaining() > 0:
                    entry.content_encoding = c.read_cstring(c.remaining())
            elif item_type == g.ItemType.URI:
                entry.item_uri_type = c.read_cstring(c.remaining())
            c.read_slice(c.remaining())  # tolerate padding
            return entry

        return self._with_box("infe", cur, body)

    def _read_iref(self, cur: _Cursor) -> g.ItemReferenceBox:
        self.box_stack.append("iref")
        try:
            vf = self._read_version_flags(cur)
            wide = vf.version != 0
            refs = []
            while cur.remaining() >= 8:
                ref_type, body, _ = self._next_box(cur)
                from_id = body.read_u32() if wide else body.read_u16()
                count = body.read_u16()
                to_ids = [
                    body.read_u32() if wide else body.read_u16()
                    for _ in range(count)
                ]
                self._finish(ref_type, body)
                refs.append(
                    g.SingleItemReference(
                        reference_type=ref_type,
                        from_item_id=from_id,
                        to_item_ids=to_ids,
                    )
                )
            self._finish("iref", cur)
            return g.ItemReferenceBox(references=refs)
        finally:
            self.box_stack.pop()

    def _read_iprp(self, cur: _Cursor) -> g.ItemPropertiesBox:
        self.box_stack.append("iprp")
        try:
            out = g.ItemPropertiesBox()
            while cur.remaining() >= 8:
                kind, body, _ = self._next_box(cur)
                if kind == "ipco":
                    out.properties = self._read_ipco(body)
                elif kind == "ipma":
                    self._read_ipma(body, out.association)
                else:
                    self._diag_skip(kind)
            self._finish("iprp", cur)
            return out
        finally:
            self.box_stack.pop()

    def _read_ipco(self, cur: _Cursor) -> list[g.ItemProperty]:
        self.box_stack.append("ipco")
        try:
            props: list[g.ItemProperty] = []
            while cur.remaining() >= 8:
                kind, body, _ = self._next_box(cur)
                if kind == "colr":
                    props.append(self._read_colr(body))
                elif kind == "hvcC":
                    props.append(self._read_hvcc(body))
                elif kind == "ispe":
                    self._read_version_flags(body)
                    props.append(
                        g.ImageSpatialExtentsProperty(
                            width=body.read_u32(), height=body.read_u32()
                        )
                    )
                    self._finish("ispe", body)
                elif kind == "irot":
                    props.append(g.ImageRotationProperty(angle=body.read_u8() & 0x3))
                    self._finish("irot", body)
                elif kind == "pixi":
                    self._read_version_flags(body)
                    n = body.read_u8()
                    props.append(
                        g.PixelInformationProperty(
                            bits_per_channel=[body.read_u8() for _ in range(n)]
                        )
                    )
                    self._finish("pixi", body)
                else:
                    self._diag_skip(kind)
                    props.append(
                        g.UnknownProperty(
                            fourcc=kind,
                            payload=bytes(body.read_slice(body.remaining())),
                        )
                    )
            self._finish("ipco", cur)
            return props
        finally:
            self.box_stack.pop()

    def _read_colr(self, cur: _Cursor) -> g.ColorInformationProperty:
        colour_type = cur.read_fourcc()
        if colour_type == "nclx":
            primaries = cur.read_u16()
            transfer = cur.read_u16()
            matrix = cur.read_u16()
            full_range = bool(cur.read_u8() >> 7)
            self._finish("colr", cur)
            return g.ColorInformationProperty(
                colour_type=colour_type,
                colour_primaries=primaries,
                transfer_characteristics=transfer,
                matrix_coefficients=matrix,
                full_range=full_range,
            )
        # rICC / prof: raw ICC payload, passed through
        icc = bytes(cur.read_slice(cur.remaining()))
        return g.ColorInformationProperty(colour_type=colour_type, icc_profile=icc)

    def _read_hvcc(self, cur: _Cursor) -> g.HevcDecoderConfigurationRecord:
        """HEVCDecoderConfigurationRecord (ISO/IEC 14496-15 §8.3.3.1);
        parity: reference src/heif/reader.rs:570-630."""
        version = cur.read_u8()
        if version != 1:
            raise BoxParseError(f"hvcC configurationVersion {version} != 1")
        b = cur.read_u8()
        profile_space = b >> 6
        tier = (b >> 5) & 1
        profile_idc = b & 0x1F
        compat = cur.read_u32()
        constraint = cur.read_uint(6)
        level_idc = cur.read_u8()
        min_spatial = cur.read_u16() & 0x0FFF
        parallelism = cur.read_u8() & 0x3
        chroma_fmt = cur.read_u8() & 0x3
        bd_luma = cur.read_u8() & 0x7
        bd_chroma = cur.read_u8() & 0x7
        avg_fr = cur.read_u16()
        b = cur.read_u8()
        const_fr = b >> 6
        num_layers = (b >> 3) & 0x7
        nested = (b >> 2) & 0x1
        length_size_m1 = b & 0x3
        n_arrays = cur.read_u8()
        arrays = []
        for _ in range(n_arrays):
            b = cur.read_u8()
            completeness = bool(b >> 7)
            nal_type = b & 0x3F
            n_nalus = cur.read_u16()
            nalus = []
            for _ in range(n_nalus):
                ln = cur.read_u16()
                nalus.append(bytes(cur.read_slice(ln)))
            arrays.append(
                g.NalArray(
                    array_completeness=completeness,
                    nal_unit_type=nal_type,
                    nal_units=nalus,
                )
            )
        self._finish("hvcC", cur)
        return g.HevcDecoderConfigurationRecord(
            configuration_version=version,
            general_profile_space=profile_space,
            general_tier_flag=tier,
            general_profile_idc=profile_idc,
            general_profile_compatibility_flags=compat,
            general_constraint_indicator_flags=constraint,
            general_level_idc=level_idc,
            min_spatial_segmentation_idc=min_spatial,
            parallelism_type=parallelism,
            chroma_format_idc=chroma_fmt,
            bit_depth_luma_minus8=bd_luma,
            bit_depth_chroma_minus8=bd_chroma,
            avg_frame_rate=avg_fr,
            constant_frame_rate=const_fr,
            num_temporal_layers=num_layers,
            temporal_id_nested=nested,
            length_size_minus_one=length_size_m1,
            nal_arrays=arrays,
        )

    def _read_ipma(self, cur: _Cursor, assoc: g.ItemPropertyAssociation) -> None:
        """ipma: property-index masking semantics per reference
        src/heif/reader.rs:476-511 (flags bit 0 selects 15- vs 7-bit index)."""
        self.box_stack.append("ipma")
        try:
            vf = self._read_version_flags(cur)
            count = cur.read_u32()
            for _ in range(count):
                item_id = cur.read_u16() if vf.version < 1 else cur.read_u32()
                n = cur.read_u8()
                lst = []
                for _ in range(n):
                    if vf.flags & 1:
                        v = cur.read_u16()
                        essential = bool(v >> 15)
                        index = v & 0x7FFF
                    else:
                        v = cur.read_u8()
                        essential = bool(v >> 7)
                        index = v & 0x7F
                    lst.append(
                        g.PropertyAssociation(property_index=index, essential=essential)
                    )
                assoc.entries[item_id] = lst
            self._finish("ipma", cur)
        finally:
            self.box_stack.pop()

    def _read_iloc(self, cur: _Cursor) -> g.ItemLocationBox:
        """iloc v0-2 (parity: reference src/heif/reader.rs:632-704)."""
        self.box_stack.append("iloc")
        try:
            vf = self._read_version_flags(cur)
            b = cur.read_u8()
            offset_size = b >> 4
            length_size = b & 0xF
            b = cur.read_u8()
            base_offset_size = b >> 4
            index_size = b & 0xF if vf.version in (1, 2) else 0
            count = cur.read_u16() if vf.version < 2 else cur.read_u32()
            out = g.ItemLocationBox()
            for _ in range(count):
                item_id = cur.read_u16() if vf.version < 2 else cur.read_u32()
                construction = 0
                if vf.version in (1, 2):
                    construction = cur.read_u16() & 0xF
                dref_index = cur.read_u16()
                base_offset = cur.read_uint(base_offset_size)
                extent_count = cur.read_u16()
                extents = []
                for _ in range(extent_count):
                    extent_index = (
                        cur.read_uint(index_size)
                        if (vf.version in (1, 2) and index_size > 0)
                        else 0
                    )
                    extents.append(
                        g.ItemExtent(
                            extent_index=extent_index,
                            extent_offset=cur.read_uint(offset_size),
                            extent_length=cur.read_uint(length_size),
                        )
                    )
                out.locations[item_id] = g.ItemLocation(
                    item_id=item_id,
                    construction_method=construction,
                    data_reference_index=dref_index,
                    base_offset=base_offset,
                    extents=extents,
                )
            self._finish("iloc", cur)
            return out
        finally:
            self.box_stack.pop()

    def _read_dinf(self, cur: _Cursor) -> g.DataInformationBox:
        self.box_stack.append("dinf")
        try:
            out = g.DataInformationBox()
            while cur.remaining() >= 8:
                kind, body, _ = self._next_box(cur)
                if kind != "dref":
                    self._diag_skip(kind)
                    continue
                self._read_version_flags(body)
                n = body.read_u32()
                for _ in range(n):
                    ekind, ebody, _ = self._next_box(body)
                    vf = self._read_version_flags(ebody)
                    entry = g.DataEntry(
                        entry_type=ekind, self_contained=bool(vf.flags & 1)
                    )
                    if ebody.remaining():
                        entry.location = ebody.read_cstring(ebody.remaining())
                    if ebody.remaining():
                        entry.name = ebody.read_cstring(ebody.remaining())
                    ebody.read_slice(ebody.remaining())
                    out.entries.append(entry)
                self._finish("dref", body)
            self._finish("dinf", cur)
            return out
        finally:
            self.box_stack.pop()


def parse_grid_config(payload: bytes) -> g.GridConfig:
    """ImageGrid item body, ISO/IEC 23008-12 §6.6.2.3.2.

    The reference cannot reach this data (idat construction is its todo! at
    src/heif/reader.rs:42); layout verified against halfmoonbay.heic
    (00 00 05 07 0fc0 0bd0 → 6x8 grid, 4032x3024).
    """
    if len(payload) < 8:
        raise BoxParseError("grid payload too short")
    version = payload[0]
    if version != 0:
        raise BoxParseError(f"grid item version {version} unsupported")
    flags = payload[1]
    rows = payload[2] + 1
    cols = payload[3] + 1
    if flags & 1:
        if len(payload) < 12:
            raise BoxParseError("grid payload too short for 32-bit extents")
        w, h = struct.unpack(">II", payload[4:12])
    else:
        w, h = struct.unpack(">HH", payload[4:8])
    return g.GridConfig(rows=rows, columns=cols, output_width=w, output_height=h)
