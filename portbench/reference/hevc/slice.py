"""Slice-segment header parsing and NAL unwrapping for HEIF tile items.

Parity target: reference src/hevc/slice.rs:44-204 (I-slice header incl. WPP
entry points) and src/heic/decoder.rs:135-164 (NAL unwrappers). The CTU
loop itself lives in the entropy layer (portbench.reference.cabac / portbench.reference.native).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.reference.hevc import grammar as g
from portbench.reference.hevc.rbsp import BitReader, remove_emulation_prevention_np


def split_length_prefixed_nals(payload: bytes, length_size: int) -> list[bytes]:
    """Split an hvc1 item payload into NAL units (4-/2-/1-byte length
    prefixes per hvcC lengthSizeMinusOne; reference
    src/heic/decoder.rs:146-164)."""
    out = []
    pos = 0
    n = len(payload)
    while pos < n:
        if pos + length_size > n:
            raise ValueError("truncated NAL length prefix")
        ln = int.from_bytes(payload[pos : pos + length_size], "big")
        pos += length_size
        if pos + ln > n:
            raise ValueError("NAL length exceeds item payload")
        out.append(payload[pos : pos + ln])
        pos += ln
    return out


def split_annexb_nals(stream: bytes) -> list[bytes]:
    """Split an Annex-B byte stream (00 00 [00] 01 start codes) into NAL
    units. Used by the fixture matrix (x265 emits Annex-B) and the raw
    `.hevc` decode surface; the reference only handles length-prefixed
    item payloads (src/heic/decoder.rs:146-164)."""
    out = []
    n = len(stream)
    pos = 0
    # find the first start code
    while pos + 3 <= n and stream[pos : pos + 3] != b"\x00\x00\x01":
        pos += 1
    pos += 3
    start = pos
    while pos + 3 <= n:
        if stream[pos : pos + 3] == b"\x00\x00\x01":
            end = pos
            if end > start and stream[end - 1] == 0:  # 4-byte start code
                end -= 1
            out.append(stream[start:end])
            pos += 3
            start = pos
        else:
            pos += 1
    if start < n:
        out.append(stream[start:n])
    return [nal for nal in out if nal]


@dataclass
class ParsedSlice:
    """A slice NAL ready for entropy decode."""

    nal_type: g.NalUnitType
    header: g.SliceSegmentHeader
    rbsp: bytes  # de-emulated RBSP (NAL header stripped)

    def substream_ranges(self) -> list[tuple[int, int]]:
        """Byte ranges of the WPP substreams within `rbsp`.

        entry_point_offset_minus1 values are offsets in the *emulation-
        -prevented* slice data per spec §7.4.7.1 — but because the offsets
        in practice are derived after de-emulation by encoders writing
        aligned substreams, we compute ranges in de-emulated space by
        re-walking. To stay exact we instead store rbsp already de-emulated
        and convert offsets at parse time (see parse_slice, which adjusts
        entry points to de-emulated coordinates).
        """
        h = self.header
        start = h.data_byte_offset
        if h.num_entry_point_offsets == 0:
            return [(start, len(self.rbsp))]
        out = []
        pos = start
        for off in h.entry_point_offsets:
            out.append((pos, pos + off))
            pos += off
        out.append((pos, len(self.rbsp)))
        return out


def parse_slice_header(
    nal: bytes,
    sps: g.SequenceParameterSet,
    pps: g.PictureParameterSet,
) -> ParsedSlice:
    """Parse an I-slice segment header (H.265 §7.3.6.1, IRAP subset).

    Keeps the reference's restrictions: first slice segment only
    (src/hevc/slice.rs:60-63), I-slices only (src/hevc/slice.rs:106-108).
    Entry-point offsets are converted from emulation-prevented coordinates
    to de-emulated RBSP coordinates so substream_ranges() indexes `rbsp`
    directly.
    """
    nal_header = g.NalUnitHeader.parse(nal)
    nt = nal_header.nal_unit_type
    if not nt.is_vcl:
        raise ValueError(f"not a VCL NAL: {nt.name}")
    payload = nal[2:]
    # vectorized de-emulation: tile payloads are tens of KB and this runs
    # once per tile on the critical path; the kept-byte mask drives exact
    # entry-point coordinate conversion below with no second walk
    rbsp_arr, kept_mask = remove_emulation_prevention_np(
        np.frombuffer(payload, dtype=np.uint8), return_mask=True
    )
    rbsp = rbsp_arr.tobytes()
    # map from emulation-prevented byte index -> de-emulated byte index
    # (needed for exact entry-point conversion)
    r = BitReader(rbsp)
    h = g.SliceSegmentHeader()

    h.first_slice_segment_in_pic_flag = r.read_flag()
    if not h.first_slice_segment_in_pic_flag:
        raise NotImplementedError(
            "multi-slice pictures unsupported (HEIF tiles are single-slice)"
        )
    if nt.is_irap:
        h.no_output_of_prior_pics_flag = r.read_flag()
    h.slice_pic_parameter_set_id = r.read_ue()
    for _ in range(pps.num_extra_slice_header_bits):
        r.read_bit()  # slice_reserved_flag
    h.slice_type = g.SliceType(r.read_ue())
    if h.slice_type != g.SliceType.I:
        raise NotImplementedError("P/B slices unsupported (still-image decode)")
    if pps.output_flag_present_flag:
        h.pic_output_flag = r.read_flag()
    if sps.separate_colour_plane_flag:
        h.colour_plane_id = r.read_bits(2)
    if not nt.is_idr:
        # CRA/BLA still-image: POC lsb + ref pic set machinery
        r.read_bits(sps.log2_max_pic_order_cnt_lsb_minus4 + 4)  # slice_pic_order_cnt_lsb
        short_term_ref_pic_set_sps_flag = r.read_flag()
        if not short_term_ref_pic_set_sps_flag:
            from portbench.reference.hevc.params import parse_short_term_ref_pic_set

            parse_short_term_ref_pic_set(
                r,
                len(sps.short_term_ref_pic_sets),
                len(sps.short_term_ref_pic_sets),
                sps.short_term_ref_pic_sets,
            )
        elif len(sps.short_term_ref_pic_sets) > 1:
            import math

            bits = max(1, math.ceil(math.log2(len(sps.short_term_ref_pic_sets))))
            r.read_bits(bits)
        if sps.long_term_ref_pics_present_flag:
            raise NotImplementedError("long-term ref pics in still image")
        if sps.sps_temporal_mvp_enabled_flag:
            r.read_flag()  # slice_temporal_mvp_enabled_flag
    if sps.sample_adaptive_offset_enabled_flag:
        h.slice_sao_luma_flag = r.read_flag()
        if sps.chroma_array_type != 0:
            h.slice_sao_chroma_flag = r.read_flag()
    h.slice_qp_delta = r.read_se()
    if pps.pps_slice_chroma_qp_offsets_present_flag:
        h.slice_cb_qp_offset = r.read_se()
        h.slice_cr_qp_offset = r.read_se()
    if pps.deblocking_filter_control_present_flag:
        if pps.deblocking_filter_override_enabled_flag:
            h.deblocking_filter_override_flag = r.read_flag()
        if h.deblocking_filter_override_flag:
            h.slice_deblocking_filter_disabled_flag = r.read_flag()
            if not h.slice_deblocking_filter_disabled_flag:
                h.slice_beta_offset_div2 = r.read_se()
                h.slice_tc_offset_div2 = r.read_se()
        else:
            h.slice_deblocking_filter_disabled_flag = (
                pps.pps_deblocking_filter_disabled_flag
            )
            h.slice_beta_offset_div2 = pps.pps_beta_offset_div2
            h.slice_tc_offset_div2 = pps.pps_tc_offset_div2
    if pps.pps_loop_filter_across_slices_enabled_flag and (
        h.slice_sao_luma_flag
        or h.slice_sao_chroma_flag
        or not h.slice_deblocking_filter_disabled_flag
    ):
        h.slice_loop_filter_across_slices_enabled_flag = r.read_flag()
    if pps.tiles_enabled_flag or pps.entropy_coding_sync_enabled_flag:
        h.num_entry_point_offsets = r.read_ue()
        if h.num_entry_point_offsets > 0:
            offset_len = r.read_ue() + 1
            raw_offsets = [
                r.read_bits(offset_len) + 1
                for _ in range(h.num_entry_point_offsets)
            ]
        else:
            raw_offsets = []
    else:
        raw_offsets = []
    if pps.slice_segment_header_extension_present_flag:
        ext_len = r.read_ue()
        for _ in range(ext_len):
            r.read_bits(8)
    r.byte_alignment()
    h.data_byte_offset = r.byte_pos

    # Convert entry-point offsets (counted over emulation-prevented bytes,
    # §7.4.7.1) into de-emulated coordinates by re-walking the original
    # payload and counting stripped 0x03s per segment.
    if raw_offsets:
        h.entry_point_offsets = _deemulated_offsets(
            kept_mask, h.data_byte_offset, raw_offsets
        )
    return ParsedSlice(nal_type=nt, header=h, rbsp=rbsp)


def _deemulated_offsets(
    kept_mask: np.ndarray, data_start_rbsp: int, raw_offsets: list[int]
) -> list[int]:
    """Convert per-substream sizes from emulation-prevented to de-emulated
    byte counts using the kept-byte mask from de-emulation (vectorized:
    searchsorted over the emulated position of each surviving byte)."""
    # emu_of[d] = emulated index of de-emulated byte d
    emu_of = np.nonzero(kept_mask)[0]
    # substream k spans emulated bytes [emu_start, emu_start + raw_offsets[k])
    bounds = emu_of[data_start_rbsp] + np.cumsum(
        np.asarray(raw_offsets, dtype=np.int64)
    )
    de_ends = np.searchsorted(emu_of, bounds, side="left")
    de_starts = np.concatenate([[data_start_rbsp], de_ends[:-1]])
    return (de_ends - de_starts).tolist()
