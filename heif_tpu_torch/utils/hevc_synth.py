"""Minimal conformant HEVC bitstream synthesis (test fixtures; the port's
copy of heif_tpu.utils.hevc_synth, logic unchanged, held against it in
tests/test_torch_copies.py).

x265 cannot emit PCM blocks, so the PCM decode path (engine flush +
byte-aligned raw samples + arithmetic re-init, §7.3.8.7 / §9.3.1) had no
encoded-bitstream coverage. This module writes real bitstreams from
scratch: a BitWriter with Exp-Golomb, minimal VPS/SPS/PPS/slice-header
writers that round-trip through this package's own parsers, and a small
CABAC *encoder* (§9.3.4.3 encoding side: EncodeDecision /
EncodeTerminate / EncodeFlush) sharing the decoder's context tables.

`synthesize_pcm_stream` builds an all-PCM I-picture: every CTU is one
PCM coding block carrying the given samples verbatim, so the decoded
output must equal the input exactly — verified against libde265 and
both of this package's entropy front ends in tests/test_fixture_matrix.

Exceeds the reference, which has no bitstream-writing capability at all.
"""

from __future__ import annotations

import numpy as np

from heif_tpu_torch.cabac.engine import (
    CTX_OFFSET,
    RANGE_TAB_LPS,
    TRANS_IDX_LPS,
    TRANS_IDX_MPS,
    init_context_state,
)
from heif_tpu_torch.hevc.rbsp import insert_emulation_prevention


class BitWriter:
    def __init__(self):
        self._bits: list[int] = []

    def bit(self, b: int) -> None:
        self._bits.append(b & 1)

    def bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self._bits.append((v >> i) & 1)

    def ue(self, v: int) -> None:
        assert v >= 0
        code = v + 1
        n = code.bit_length()
        self.bits(0, n - 1)
        self.bits(code, n)

    def se(self, v: int) -> None:
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def byte_align(self, stop_bit: bool = True) -> None:
        if stop_bit:
            self.bit(1)
        while len(self._bits) % 8:
            self.bit(0)

    @property
    def bit_len(self) -> int:
        return len(self._bits)

    def tobytes(self) -> bytes:
        assert len(self._bits) % 8 == 0
        out = bytearray(len(self._bits) // 8)
        for i, b in enumerate(self._bits):
            if b:
                out[i >> 3] |= 0x80 >> (i & 7)
        return bytes(out)


class CabacEncoder:
    """§9.3.4.3 encoding engine over a BitWriter (context-coded and
    terminate bins; enough for the PCM-only syntax tree)."""

    def __init__(self, bw: BitWriter, slice_qp_y: int):
        self.bw = bw
        self.p_state, self.val_mps = init_context_state(slice_qp_y)
        self.p_state = self.p_state.copy()
        self.val_mps = self.val_mps.copy()
        self._restart()

    def _restart(self) -> None:
        """Arithmetic-engine init (contexts persist — §9.3.1 after PCM)."""
        self.low = 0
        self.range = 510
        self.outstanding = 0
        self.first_bit = True

    def _put(self, b: int) -> None:
        if self.first_bit:
            self.first_bit = False
        else:
            self.bw.bit(b)
        while self.outstanding:
            self.bw.bit(1 - b)
            self.outstanding -= 1

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low >= 512:
                self._put(1)
                self.low -= 512
            elif self.low < 256:
                self._put(0)
            else:
                self.outstanding += 1
                self.low -= 256
            self.low <<= 1
            self.range <<= 1

    def encode_bin(self, ctx: int, b: int) -> None:
        p = self.p_state[ctx]
        mps = self.val_mps[ctx]
        lps = RANGE_TAB_LPS[(p << 2) | ((self.range >> 6) & 3)]
        self.range -= lps
        if b != mps:
            self.low += self.range
            self.range = lps
            if p == 0:
                self.val_mps[ctx] = 1 - mps
            self.p_state[ctx] = TRANS_IDX_LPS[p]
        else:
            self.p_state[ctx] = TRANS_IDX_MPS[p]
        self._renorm()

    def encode_bypass(self, b: int) -> None:
        """§9.3.4.3.4 EncodeBypass."""
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.outstanding += 1
            self.low -= 512

    def encode_bypass_bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.encode_bypass((v >> i) & 1)

    def encode_terminate(self, b: int) -> None:
        self.range -= 2
        if b:
            self.low += self.range
            self.range = 2
            self._renorm()
            self._flush()
        else:
            self._renorm()

    def _flush(self) -> None:
        """§9.3.4.3.5 EncodeFlush: PutBit((low>>9)&1), then two RAW bits
        ((low>>7)&3)|1 (the trailing 1 doubles as the stop bit)."""
        self._put((self.low >> 9) & 1)
        self.bw.bit((self.low >> 8) & 1)
        self.bw.bit(1)  # ((low >> 7) & 1) | 1 == 1


def _nal(nal_type: int, rbsp: bytes) -> bytes:
    hdr = bytes([(nal_type << 1) & 0x7E, 1])  # layer 0, tid+1 = 1
    return b"\x00\x00\x00\x01" + hdr + insert_emulation_prevention(rbsp)


def _write_ptl(w: BitWriter) -> None:
    w.bits(0, 2)  # profile_space
    w.bit(0)  # tier
    w.bits(1, 5)  # profile_idc: Main
    w.bits(0x60000000, 32)  # compatibility: Main + Main10
    w.bit(1)  # progressive_source
    w.bit(0)  # interlaced_source
    w.bit(1)  # non_packed_constraint
    w.bit(1)  # frame_only_constraint
    w.bits(0, 32)
    w.bits(0, 12)  # 44 reserved bits total
    w.bits(120, 8)  # level 4.0


def write_vps() -> bytes:
    w = BitWriter()
    w.bits(0, 4)  # vps id
    w.bit(1)  # base_layer_internal
    w.bit(1)  # base_layer_available
    w.bits(0, 6)  # max_layers_minus1
    w.bits(0, 3)  # max_sub_layers_minus1
    w.bit(1)  # temporal_id_nesting
    w.bits(0xFFFF, 16)  # reserved
    _write_ptl(w)
    w.bit(1)  # sub_layer_ordering_info_present
    w.ue(0)  # max_dec_pic_buffering_minus1
    w.ue(0)  # max_num_reorder_pics
    w.ue(0)  # max_latency_increase_plus1
    w.bits(0, 6)  # max_layer_id
    w.ue(0)  # num_layer_sets_minus1
    w.bit(0)  # timing_info_present
    w.bit(0)  # vps_extension
    w.byte_align()
    return w.tobytes()


def write_sps(
    width: int,
    height: int,
    *,
    ctb_log2: int = 5,
    min_cb_log2: int = 3,
    pcm: bool = True,
    pcm_log2: int = 5,
    pcm_bd: int = 8,
    conf_win: tuple[int, int, int, int] | None = None,
) -> bytes:
    """conf_win: (left, right, top, bottom) conformance-window offsets
    in chroma units (§7.4.3.2.1; luma crop = 2x for 4:2:0). x265 never
    emits nonzero left/top offsets, so synthesized streams are the only
    way to exercise that crop-origin path."""
    w = BitWriter()
    w.bits(0, 4)  # sps_video_parameter_set_id
    w.bits(0, 3)  # max_sub_layers_minus1
    w.bit(1)  # temporal_id_nesting
    _write_ptl(w)
    w.ue(0)  # sps id
    w.ue(1)  # chroma_format_idc 4:2:0
    w.ue(width)
    w.ue(height)
    if conf_win:
        w.bit(1)  # conformance_window_flag
        for v in conf_win:
            w.ue(v)
    else:
        w.bit(0)  # conformance_window
    w.ue(0)  # bit_depth_luma_minus8
    w.ue(0)  # bit_depth_chroma_minus8
    w.ue(4)  # log2_max_pic_order_cnt_lsb_minus4
    w.bit(1)  # sub_layer_ordering_info_present
    w.ue(0)
    w.ue(0)
    w.ue(0)
    w.ue(min_cb_log2 - 3)  # log2_min_luma_coding_block_size_minus3
    w.ue(ctb_log2 - min_cb_log2)  # log2_diff_max_min
    w.ue(0)  # log2_min_tb_minus2 (4)
    w.ue(3)  # log2_diff_max_min_tb (-> 32)
    w.ue(0)  # max_transform_hierarchy_depth_inter
    w.ue(0)  # max_transform_hierarchy_depth_intra
    w.bit(0)  # scaling_list_enabled
    w.bit(0)  # amp_enabled
    w.bit(0)  # sample_adaptive_offset_enabled
    w.bit(1 if pcm else 0)
    if pcm:
        w.bits(pcm_bd - 1, 4)  # pcm_sample_bit_depth_luma_minus1
        w.bits(pcm_bd - 1, 4)  # chroma
        w.ue(pcm_log2 - 3)  # log2_min_pcm_luma_coding_block_size_minus3
        w.ue(0)  # log2_diff_max_min_pcm
        w.bit(1)  # pcm_loop_filter_disabled
    w.ue(0)  # num_short_term_ref_pic_sets
    w.bit(0)  # long_term_ref_pics_present
    w.bit(0)  # temporal_mvp
    w.bit(0)  # strong_intra_smoothing
    w.bit(0)  # vui_present
    w.bit(0)  # sps_extension
    w.byte_align()
    return w.tobytes()


def write_pps(tiles: tuple[int, int] | None = None) -> bytes:
    """Minimal I-slice PPS; tiles=(n_cols, n_rows) enables uniform tile
    partitioning (loop_filter_across_tiles=1)."""
    w = BitWriter()
    w.ue(0)  # pps id
    w.ue(0)  # sps id
    w.bit(0)  # dependent_slice_segments
    w.bit(0)  # output_flag_present
    w.bits(0, 3)  # num_extra_slice_header_bits
    w.bit(0)  # sign_data_hiding
    w.bit(0)  # cabac_init_present
    w.ue(0)  # num_ref_idx_l0
    w.ue(0)  # num_ref_idx_l1
    w.se(0)  # init_qp_minus26
    w.bit(0)  # constrained_intra_pred
    w.bit(0)  # transform_skip
    w.bit(0)  # cu_qp_delta_enabled
    w.se(0)  # cb_qp_offset
    w.se(0)  # cr_qp_offset
    w.bit(0)  # slice_chroma_qp_offsets_present
    w.bit(0)  # weighted_pred
    w.bit(0)  # weighted_bipred
    w.bit(0)  # transquant_bypass_enabled
    w.bit(1 if tiles else 0)  # tiles_enabled
    w.bit(0)  # entropy_coding_sync (WPP)
    if tiles:
        nc, nr = tiles
        w.ue(nc - 1)  # num_tile_columns_minus1
        w.ue(nr - 1)  # num_tile_rows_minus1
        w.bit(1)  # uniform_spacing
        w.bit(1)  # loop_filter_across_tiles
    w.bit(0)  # loop_filter_across_slices
    w.bit(1)  # deblocking_filter_control_present
    w.bit(0)  # deblocking_filter_override_enabled
    w.bit(1)  # pps_deblocking_filter_disabled
    w.bit(0)  # pps_scaling_list_data_present
    w.bit(0)  # lists_modification_present
    w.ue(0)  # log2_parallel_merge_level_minus2
    w.bit(0)  # slice_segment_header_extension
    w.bit(0)  # pps_extension
    w.byte_align()
    return w.tobytes()


def synthesize_pcm_stream(
    y: np.ndarray, cb: np.ndarray, cr: np.ndarray, nal_type: int = 20,
    conf_win: tuple[int, int, int, int] | None = None,
) -> bytes:
    """All-PCM I-picture: every 32x32 CTU is one PCM block whose samples
    are taken verbatim from the given 8-bit planes. Returns Annex-B.

    nal_type 20 (IDR_N_LP, default) or 21 (CRA_NUT): a CRA slice header
    additionally carries slice_pic_order_cnt_lsb and an (empty)
    st_ref_pic_set — the non-IDR IRAP path of hevc/slice.py (reference
    anchor src/hevc/slice.rs:52-57)."""
    assert nal_type in (20, 21)
    h, wd = y.shape
    assert h % 32 == 0 and wd % 32 == 0, "dims must be CTU-aligned"
    assert cb.shape == cr.shape == (h // 2, wd // 2)

    w = BitWriter()
    # --- slice segment header (IDR_N_LP or CRA_NUT) ---
    w.bit(1)  # first_slice_segment_in_pic
    w.bit(1)  # no_output_of_prior_pics (IRAP)
    w.ue(0)  # slice_pic_parameter_set_id
    w.ue(2)  # slice_type I
    if nal_type == 21:  # CRA: POC + ref-pic-set fields (§7.3.6.1)
        w.bits(0, 8)  # slice_pic_order_cnt_lsb (log2_max_poc_lsb = 8)
        w.bit(0)  # short_term_ref_pic_set_sps_flag
        # st_ref_pic_set(0): empty set (no inter-RPS prediction at idx 0)
        w.ue(0)  # num_negative_pics
        w.ue(0)  # num_positive_pics
    w.se(0)  # slice_qp_delta (SliceQpY = 26)
    w.byte_align()  # §7.3.6.1 byte_alignment before slice data

    enc = CabacEncoder(w, slice_qp_y=26)
    split_ctx = CTX_OFFSET["split_cu"]
    ctbs_x, ctbs_y = wd // 32, h // 32
    n_ctb = ctbs_x * ctbs_y
    for addr in range(n_ctb):
        cx, cy = addr % ctbs_x, addr // ctbs_x
        # coding_quadtree at depth 0 (32 > min CB 8): split_cu_flag = 0.
        # Neighbor ct-depths are all 0, so ctxInc is 0 for every CTU.
        enc.encode_bin(split_ctx + 0, 0)
        # coding_unit (I, 2Nx2N, pcm range [32,32]): pcm_flag = 1
        enc.encode_terminate(1)  # includes EncodeFlush
        w.byte_align(stop_bit=False)  # pcm_alignment_zero_bit(s)
        # raw samples: luma then Cb then Cr, raster order, 8 bits each
        x0, y0 = cx * 32, cy * 32
        for row in y[y0 : y0 + 32, x0 : x0 + 32]:
            for v in row:
                w.bits(int(v), 8)
        for plane in (cb, cr):
            for row in plane[y0 // 2 : y0 // 2 + 16, x0 // 2 : x0 // 2 + 16]:
                for v in row:
                    w.bits(int(v), 8)
        enc._restart()  # re-init arithmetic engine, keep contexts (§9.3.1)
        # end_of_slice_segment_flag
        enc.encode_terminate(1 if addr == n_ctb - 1 else 0)
    # final terminate=1 ran EncodeFlush (ends in the stop bit); pad to byte
    w.byte_align(stop_bit=False)

    return (
        _nal(32, write_vps())
        + _nal(33, write_sps(wd, h, conf_win=conf_win))
        + _nal(34, write_pps())
        + _nal(nal_type, w.tobytes())
    )


def synthesize_tiled_intra_stream(
    width: int,
    height: int,
    tiles: tuple[int, int],
    seed: int = 0,
) -> bytes:
    """Tiles-enabled mixed PCM/intra picture (Annex-B).

    Picture is partitioned into uniform tiles (PPS tiles_enabled_flag=1 —
    the geometry the reference parses but never decodes,
    src/hevc/parameter_set_reader.rs:383-412). Each CTB is one 32x32 CU:
    roughly half are PCM blocks carrying random samples (content
    sources), the rest no-residual intra CUs with randomized modes that
    predict from their neighbors. The PCM content makes tile-boundary
    prediction availability OBSERVABLE: a decoder that wrongly reads
    across a tile boundary picks up real (non-substituted) samples and
    diverges — exercising tile-scan CTU order, per-tile CABAC substreams
    with spec re-init, end_of_subset signalling, and §6.4.1 availability.
    Bins are arbitrary; the correctness oracle is libde265 decoding the
    same bytes.
    """
    assert width % 32 == 0 and height % 32 == 0
    ctbs_x, ctbs_y = width // 32, height // 32
    nc, nr = tiles
    col_bd = [(i * ctbs_x) // nc for i in range(nc + 1)]
    row_bd = [(i * ctbs_y) // nr for i in range(nr + 1)]
    rng = np.random.default_rng(seed)

    data = BitWriter()
    tile_ends = []  # byte offsets into data after each tile
    n_tiles = nc * nr
    t_idx = 0
    for tr in range(nr):
        for tc in range(nc):
            t_idx += 1
            last_tile = t_idx == n_tiles
            enc = CabacEncoder(data, slice_qp_y=26)
            coords = [
                (x, y)
                for y in range(row_bd[tr], row_bd[tr + 1])
                for x in range(col_bd[tc], col_bd[tc + 1])
            ]
            for ci, (x, y) in enumerate(coords):
                last_ctu_in_tile = ci == len(coords) - 1
                # coding_quadtree: split_cu=0 (32x32 CU; neighbor depths
                # are all 0 so ctxInc is 0 regardless of availability)
                enc.encode_bin(CTX_OFFSET["split_cu"] + 0, 0)
                # pcm_flag (SPS pcm range [32,32]): ~half the CTBs carry
                # random PCM samples so predictions have real content
                if rng.integers(2):
                    enc.encode_terminate(1)  # pcm_flag, incl. flush
                    data.byte_align(stop_bit=False)
                    # samples in [1,254]: keeps the slice EP-clean
                    for _ in range(32 * 32 + 2 * 16 * 16):
                        data.bits(int(rng.integers(1, 255)), 8)
                    enc._restart()
                else:
                    enc.encode_terminate(0)  # pcm_flag = 0
                    # coding_unit: prev_intra_luma_pred_flag
                    if rng.integers(2):
                        enc.encode_bin(CTX_OFFSET["prev_intra"], 1)
                        mpm = int(rng.integers(3))  # TR cMax=2 bypass
                        if mpm == 0:
                            enc.encode_bypass(0)
                        else:
                            enc.encode_bypass(1)
                            enc.encode_bypass(mpm - 1)
                    else:
                        enc.encode_bin(CTX_OFFSET["prev_intra"], 0)
                        enc.encode_bypass_bits(int(rng.integers(32)), 5)
                    # intra_chroma_pred_mode: bin0=0 -> DM (luma mode)
                    enc.encode_bin(CTX_OFFSET["chroma_mode"], 0)
                    # transform_tree depth 0: cbf_cb/cbf_cr/cbf_luma = 0
                    enc.encode_bin(CTX_OFFSET["cbf_chroma"] + 0, 0)
                    enc.encode_bin(CTX_OFFSET["cbf_chroma"] + 0, 0)
                    enc.encode_bin(CTX_OFFSET["cbf_luma"] + 1, 0)
                # end_of_slice_segment_flag
                is_very_last = last_tile and last_ctu_in_tile
                if is_very_last:
                    enc.encode_terminate(1)
                    data.byte_align(stop_bit=False)
                elif last_ctu_in_tile:
                    enc.encode_terminate(0)
                    enc.encode_terminate(1)  # end_of_subset_one_bit
                    data.byte_align(stop_bit=False)
                else:
                    enc.encode_terminate(0)
            if not last_tile:
                tile_ends.append(data.bit_len // 8)

    data_bytes = data.tobytes()
    # entry point offsets are expressed in the emulation-prevented
    # domain; this writer requires the slice data to be EP-clean
    assert insert_emulation_prevention(data_bytes) == data_bytes, (
        "synthesized tile substreams hit an emulation-prevention pattern; "
        "pick a different seed"
    )
    offsets = []
    prev = 0
    for e in tile_ends:
        offsets.append(e - prev)
        prev = e

    # --- slice segment header (IDR_N_LP, tiles entry points) ---
    h = BitWriter()
    h.bit(1)  # first_slice_segment_in_pic
    h.bit(1)  # no_output_of_prior_pics
    h.ue(0)  # slice_pic_parameter_set_id
    h.ue(2)  # slice_type I
    h.se(0)  # slice_qp_delta
    h.ue(len(offsets))  # num_entry_point_offsets
    if offsets:
        maxoff = max(offsets)
        olen = max(1, maxoff.bit_length())
        h.ue(olen - 1)  # offset_len_minus1
        for off in offsets:
            h.bits(off - 1, olen)  # entry_point_offset_minus1
    h.byte_align()

    return (
        _nal(32, write_vps())
        + _nal(33, write_sps(width, height, pcm=True))
        + _nal(34, write_pps(tiles=tiles))
        + _nal(20, h.tobytes() + data_bytes)
    )
