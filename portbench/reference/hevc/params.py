"""VPS / SPS / PPS parsers (H.265 §7.3.2), value-retaining.

Parity target: reference src/hevc/parameter_set_reader.rs:1-551 — but where
the reference parses-and-skips (profile_tier_level, scaling lists,
ref-pic-sets, most of VUI), these parsers retain the decoded values because
the reconstruction stack consumes them (scaling lists drive dequant; VUI
full-range drives the oracle patch).

All parsers consume a de-emulated RBSP (NAL header already stripped).
"""

from __future__ import annotations

from portbench.reference.hevc import grammar as g
from portbench.reference.hevc.rbsp import BitReader, insert_emulation_prevention, remove_emulation_prevention


# ---------------------------------------------------------------------------
# profile_tier_level (§7.3.3)
# ---------------------------------------------------------------------------


def parse_profile_tier_level(
    r: BitReader, profile_present: bool, max_sub_layers_minus1: int
) -> g.ProfileTierLevel:
    ptl = g.ProfileTierLevel()
    if profile_present:
        ptl.general_profile_space = r.read_bits(2)
        ptl.general_tier_flag = r.read_bit()
        ptl.general_profile_idc = r.read_bits(5)
        ptl.general_profile_compatibility_flags = r.read_bits(32)
        # progressive/interlaced/non_packed/frame_only + 43 reserved + 1
        ptl.general_constraint_flags = (r.read_bits(32) << 16) | r.read_bits(16)
    ptl.general_level_idc = r.read_bits(8)
    sub_profile_present = []
    sub_level_present = []
    for _ in range(max_sub_layers_minus1):
        sub_profile_present.append(r.read_flag())
        sub_level_present.append(r.read_flag())
    if max_sub_layers_minus1 > 0:
        for _ in range(max_sub_layers_minus1, 8):
            r.read_bits(2)  # reserved_zero_2bits
    for i in range(max_sub_layers_minus1):
        if sub_profile_present[i]:
            r.read_bits(32)
            r.read_bits(32)
            r.read_bits(24)  # 88 bits sub-layer profile
        if sub_level_present[i]:
            r.read_bits(8)
    return ptl


# ---------------------------------------------------------------------------
# scaling_list_data (§7.3.4) + defaults (§7.4.5, Tables 7-5/7-6)
# ---------------------------------------------------------------------------


def diag_scan_order(blk_size: int) -> list[tuple[int, int]]:
    """Up-right diagonal scan (§6.5.3): list of (x, y) per scan index."""
    out: list[tuple[int, int]] = []
    x = y = 0
    while True:
        while y >= 0:
            if x < blk_size and y < blk_size:
                out.append((x, y))
            y -= 1
            x += 1
        y = x
        x = 0
        if len(out) >= blk_size * blk_size:
            return out


_DIAG8 = None


def _diag8() -> list[tuple[int, int]]:
    global _DIAG8
    if _DIAG8 is None:
        _DIAG8 = diag_scan_order(8)
    return _DIAG8


def make_default_scaling_lists() -> g.ScalingListData:
    """Default ScalingList values (Tables 7-5/7-6), stored in the
    up-right-diagonal order that §7.3.4 decoding produces."""
    data = g.ScalingListData()
    data.scaling_list = []
    for size_id in range(4):
        per_matrix = []
        n_matrices = 6
        for matrix_id in range(n_matrices):
            raster = g.ScalingListData.default_list(size_id, matrix_id)
            if size_id == 0:
                # 4x4: all 16s; diag of constant == constant
                per_matrix.append(list(raster))
            else:
                diag = [raster[y * 8 + x] for (x, y) in _diag8()]
                per_matrix.append(diag)
        data.scaling_list.append(per_matrix)
    data.dc = [[16] * 6, [16] * 6]  # sizeId 2, 3
    return data


def parse_scaling_list_data(r: BitReader) -> g.ScalingListData:
    """§7.3.4 with ref-matrix copy semantics (§7.4.5)."""
    data = g.ScalingListData()
    data.scaling_list = [[None] * 6 for _ in range(4)]  # type: ignore
    data.dc = [[16] * 6, [16] * 6]
    defaults = make_default_scaling_lists()
    for size_id in range(4):
        matrix_id = 0
        while matrix_id < 6:
            pred_mode = r.read_flag()
            if not pred_mode:
                delta = r.read_ue()
                if delta == 0:
                    data.scaling_list[size_id][matrix_id] = list(
                        defaults.scaling_list[size_id][matrix_id]
                    )
                    if size_id >= 2:
                        data.dc[size_id - 2][matrix_id] = 16
                else:
                    ref_id = matrix_id - delta * (3 if size_id == 3 else 1)
                    data.scaling_list[size_id][matrix_id] = list(
                        data.scaling_list[size_id][ref_id]
                    )
                    if size_id >= 2:
                        data.dc[size_id - 2][matrix_id] = data.dc[size_id - 2][ref_id]
            else:
                coef_num = min(64, 1 << (4 + (size_id << 1)))
                next_coef = 8
                if size_id > 1:
                    dc_minus8 = r.read_se()
                    data.dc[size_id - 2][matrix_id] = dc_minus8 + 8
                    next_coef = dc_minus8 + 8
                lst = []
                for _ in range(coef_num):
                    delta_coef = r.read_se()
                    next_coef = (next_coef + delta_coef + 256) % 256
                    lst.append(next_coef)
                data.scaling_list[size_id][matrix_id] = lst
            matrix_id += 3 if size_id == 3 else 1
    # sizeId 3 only codes matrixId 0,3; fill 1,2,4,5 by §7.4.5 inference
    for m in range(6):
        if data.scaling_list[3][m] is None:
            src = 0 if m < 3 else 3
            data.scaling_list[3][m] = list(data.scaling_list[3][src])
            data.dc[1][m] = data.dc[1][src]
    return data


# ---------------------------------------------------------------------------
# st_ref_pic_set (§7.3.7)
# ---------------------------------------------------------------------------


def parse_short_term_ref_pic_set(
    r: BitReader, idx: int, num_sets: int, parsed: list[g.ShortTermRefPicSet]
) -> g.ShortTermRefPicSet:
    s = g.ShortTermRefPicSet()
    inter_pred = r.read_flag() if idx != 0 else False
    if inter_pred:
        delta_idx_minus1 = r.read_ue() if idx == num_sets else 0
        ref = parsed[idx - 1 - delta_idx_minus1]
        delta_rps_sign = r.read_bit()
        abs_delta_rps_minus1 = r.read_ue()
        delta_rps = (1 - 2 * delta_rps_sign) * (abs_delta_rps_minus1 + 1)
        use = []
        for _ in range(ref.num_delta_pocs + 1):
            used = r.read_flag()
            use_delta = True if used else r.read_flag()
            use.append((used, use_delta))
        # Full derivation of the predicted set (§7.4.8) — still-image decode
        # only needs the parse to stay in sync, but keep counts consistent:
        ref_pocs = (
            [-d for d in _cum(ref.delta_poc_s0)]
            + [0]
            + list(_cum(ref.delta_poc_s1))
        )
        neg, pos = [], []
        for j, poc in enumerate(ref_pocs):
            used, use_delta = use[j if j < len(use) else -1]
            if use_delta:
                d = poc + delta_rps
                if d < 0:
                    neg.append((-d, used))
                elif d > 0:
                    pos.append((d, used))
        neg.sort()
        pos.sort()
        s.num_negative_pics = len(neg)
        s.num_positive_pics = len(pos)
        s.delta_poc_s0 = _dedelta([d for d, _ in neg])
        s.used_by_curr_pic_s0 = [u for _, u in neg]
        s.delta_poc_s1 = _dedelta([d for d, _ in pos])
        s.used_by_curr_pic_s1 = [u for _, u in pos]
        return s
    s.num_negative_pics = r.read_ue()
    s.num_positive_pics = r.read_ue()
    for _ in range(s.num_negative_pics):
        s.delta_poc_s0.append(r.read_ue() + 1)
        s.used_by_curr_pic_s0.append(r.read_flag())
    for _ in range(s.num_positive_pics):
        s.delta_poc_s1.append(r.read_ue() + 1)
        s.used_by_curr_pic_s1.append(r.read_flag())
    return s


def _cum(deltas: list[int]) -> list[int]:
    out, acc = [], 0
    for d in deltas:
        acc += d
        out.append(acc)
    return out


def _dedelta(absolute: list[int]) -> list[int]:
    out, prev = [], 0
    for a in absolute:
        out.append(a - prev)
        prev = a
    return out


# ---------------------------------------------------------------------------
# VUI (§E.2.1)
# ---------------------------------------------------------------------------


def parse_vui(r: BitReader, sps_max_sub_layers_minus1: int) -> g.VuiParameters:
    vui = g.VuiParameters()
    if r.read_flag():  # aspect_ratio_info_present
        vui.aspect_ratio_idc = r.read_bits(8)
        if vui.aspect_ratio_idc == 255:
            vui.sar_width = r.read_bits(16)
            vui.sar_height = r.read_bits(16)
    if r.read_flag():  # overscan_info_present
        vui.overscan_appropriate_flag = r.read_flag()
    if r.read_flag():  # video_signal_type_present
        vui.video_format = r.read_bits(3)
        vui.full_range_flag_bit_pos = r.bit_pos
        vui.video_full_range_flag = r.read_flag()
        if r.read_flag():  # colour_description_present
            vui.colour_primaries = r.read_bits(8)
            vui.transfer_characteristics = r.read_bits(8)
            vui.matrix_coeffs = r.read_bits(8)
    if r.read_flag():  # chroma_loc_info_present
        vui.chroma_sample_loc_type_top_field = r.read_ue()
        vui.chroma_sample_loc_type_bottom_field = r.read_ue()
    vui.neutral_chroma_indication_flag = r.read_flag()
    vui.field_seq_flag = r.read_flag()
    vui.frame_field_info_present_flag = r.read_flag()
    if r.read_flag():  # default_display_window
        r.read_ue()
        r.read_ue()
        r.read_ue()
        r.read_ue()
    if r.read_flag():  # vui_timing_info_present
        r.read_bits(32)  # num_units_in_tick
        r.read_bits(32)  # time_scale
        if r.read_flag():  # poc_proportional_to_timing
            r.read_ue()
        if r.read_flag():  # hrd_parameters_present
            _skip_hrd_parameters(r, sps_max_sub_layers_minus1)
    if r.read_flag():  # bitstream_restriction
        r.read_flag()  # tiles_fixed_structure
        r.read_flag()  # motion_vectors_over_pic_boundaries
        r.read_flag()  # restricted_ref_pic_lists
        r.read_ue()  # min_spatial_segmentation_idc
        r.read_ue()  # max_bytes_per_pic_denom
        r.read_ue()  # max_bits_per_min_cu_denom
        r.read_ue()  # log2_max_mv_length_horizontal
        r.read_ue()  # log2_max_mv_length_vertical
    return vui


def _skip_hrd_parameters(r: BitReader, max_sub_layers_minus1: int) -> None:
    """hrd_parameters(1, maxSubLayers) — §E.2.2, values discarded
    (reference skips the same way, src/hevc/parameter_set_reader.rs:338-349)."""
    nal_hrd = r.read_flag()
    vcl_hrd = r.read_flag()
    sub_pic_hrd = False
    if nal_hrd or vcl_hrd:
        sub_pic_hrd = r.read_flag()
        if sub_pic_hrd:
            r.read_bits(8)  # tick_divisor_minus2
            r.read_bits(5)  # du_cpb_removal_delay_increment_length_minus1
            r.read_bit()  # sub_pic_cpb_params_in_pic_timing_sei_flag
            r.read_bits(5)  # dpb_output_delay_du_length_minus1
        r.read_bits(4)  # bit_rate_scale
        r.read_bits(4)  # cpb_size_scale
        if sub_pic_hrd:
            r.read_bits(4)  # cpb_size_du_scale
        r.read_bits(5)  # initial_cpb_removal_delay_length_minus1
        r.read_bits(5)  # au_cpb_removal_delay_length_minus1
        r.read_bits(5)  # dpb_output_delay_length_minus1
    for _ in range(max_sub_layers_minus1 + 1):
        fixed_rate_general = r.read_flag()
        fixed_rate_within_cvs = r.read_flag() if not fixed_rate_general else True
        low_delay = False
        if fixed_rate_within_cvs:
            r.read_ue()  # elemental_duration_in_tc_minus1
        else:
            low_delay = r.read_flag()
        cpb_cnt = 1 if low_delay else r.read_ue() + 1
        for hrd_present in (nal_hrd, vcl_hrd):
            if hrd_present:
                for _ in range(cpb_cnt):
                    r.read_ue()  # bit_rate_value_minus1
                    r.read_ue()  # cpb_size_value_minus1
                    if sub_pic_hrd:
                        r.read_ue()  # cpb_size_du_value_minus1
                        r.read_ue()  # bit_rate_du_value_minus1
                    r.read_flag()  # cbr_flag


# ---------------------------------------------------------------------------
# VPS (§7.3.2.1)
# ---------------------------------------------------------------------------


def parse_vps(rbsp: bytes) -> g.VideoParameterSet:
    r = BitReader(rbsp)
    vps = g.VideoParameterSet()
    vps.vps_video_parameter_set_id = r.read_bits(4)
    r.read_bits(2)  # vps_base_layer_internal/available (reserved in v1)
    vps.vps_max_layers_minus1 = r.read_bits(6)
    vps.vps_max_sub_layers_minus1 = r.read_bits(3)
    vps.vps_temporal_id_nesting_flag = r.read_flag()
    r.read_bits(16)  # vps_reserved_0xffff_16bits
    vps.profile_tier_level = parse_profile_tier_level(
        r, True, vps.vps_max_sub_layers_minus1
    )
    vps.vps_sub_layer_ordering_info_present_flag = r.read_flag()
    start = (
        0
        if vps.vps_sub_layer_ordering_info_present_flag
        else vps.vps_max_sub_layers_minus1
    )
    for _ in range(start, vps.vps_max_sub_layers_minus1 + 1):
        vps.vps_max_dec_pic_buffering_minus1.append(r.read_ue())
        vps.vps_max_num_reorder_pics.append(r.read_ue())
        vps.vps_max_latency_increase_plus1.append(r.read_ue())
    vps.vps_max_layer_id = r.read_bits(6)
    vps.vps_num_layer_sets_minus1 = r.read_ue()
    for _ in range(vps.vps_num_layer_sets_minus1):
        for _ in range(vps.vps_max_layer_id + 1):
            r.read_flag()  # layer_id_included_flag
    vps.vps_timing_info_present_flag = r.read_flag()
    # timing info / extensions not needed for still decode; stop here
    # (reference defaults these too, src/hevc/parameter_set_reader.rs:28-32)
    return vps


# ---------------------------------------------------------------------------
# SPS (§7.3.2.2)
# ---------------------------------------------------------------------------


def parse_sps(rbsp: bytes) -> g.SequenceParameterSet:
    r = BitReader(rbsp)
    sps = g.SequenceParameterSet()
    sps.sps_video_parameter_set_id = r.read_bits(4)
    sps.sps_max_sub_layers_minus1 = r.read_bits(3)
    sps.sps_temporal_id_nesting_flag = r.read_flag()
    sps.profile_tier_level = parse_profile_tier_level(
        r, True, sps.sps_max_sub_layers_minus1
    )
    sps.sps_seq_parameter_set_id = r.read_ue()
    sps.chroma_format_idc = r.read_ue()
    if sps.chroma_format_idc == 3:
        sps.separate_colour_plane_flag = r.read_flag()
    sps.pic_width_in_luma_samples = r.read_ue()
    sps.pic_height_in_luma_samples = r.read_ue()
    if r.read_flag():  # conformance_window_flag
        sps.conf_win_left_offset = r.read_ue()
        sps.conf_win_right_offset = r.read_ue()
        sps.conf_win_top_offset = r.read_ue()
        sps.conf_win_bottom_offset = r.read_ue()
    sps.bit_depth_luma_minus8 = r.read_ue()
    sps.bit_depth_chroma_minus8 = r.read_ue()
    sps.log2_max_pic_order_cnt_lsb_minus4 = r.read_ue()
    sub_layer_ordering_present = r.read_flag()
    start = 0 if sub_layer_ordering_present else sps.sps_max_sub_layers_minus1
    for _ in range(start, sps.sps_max_sub_layers_minus1 + 1):
        sps.sps_max_dec_pic_buffering_minus1.append(r.read_ue())
        sps.sps_max_num_reorder_pics.append(r.read_ue())
        sps.sps_max_latency_increase_plus1.append(r.read_ue())
    sps.log2_min_luma_coding_block_size_minus3 = r.read_ue()
    sps.log2_diff_max_min_luma_coding_block_size = r.read_ue()
    sps.log2_min_luma_transform_block_size_minus2 = r.read_ue()
    sps.log2_diff_max_min_luma_transform_block_size = r.read_ue()
    sps.max_transform_hierarchy_depth_inter = r.read_ue()
    sps.max_transform_hierarchy_depth_intra = r.read_ue()
    sps.scaling_list_enabled_flag = r.read_flag()
    if sps.scaling_list_enabled_flag:
        sps.sps_scaling_list_data_present_flag = r.read_flag()
        if sps.sps_scaling_list_data_present_flag:
            sps.scaling_list_data = parse_scaling_list_data(r)
    sps.amp_enabled_flag = r.read_flag()
    sps.sample_adaptive_offset_enabled_flag = r.read_flag()
    sps.pcm_enabled_flag = r.read_flag()
    if sps.pcm_enabled_flag:
        sps.pcm_sample_bit_depth_luma_minus1 = r.read_bits(4)
        sps.pcm_sample_bit_depth_chroma_minus1 = r.read_bits(4)
        sps.log2_min_pcm_luma_coding_block_size_minus3 = r.read_ue()
        sps.log2_diff_max_min_pcm_luma_coding_block_size = r.read_ue()
        sps.pcm_loop_filter_disabled_flag = r.read_flag()
    num_st = r.read_ue()
    for i in range(num_st):
        sps.short_term_ref_pic_sets.append(
            parse_short_term_ref_pic_set(r, i, num_st, sps.short_term_ref_pic_sets)
        )
    sps.long_term_ref_pics_present_flag = r.read_flag()
    if sps.long_term_ref_pics_present_flag:
        n = r.read_ue()
        for _ in range(n):
            sps.lt_ref_pic_poc_lsb_sps.append(
                r.read_bits(sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
            )
            sps.used_by_curr_pic_lt_sps_flag.append(r.read_flag())
    sps.sps_temporal_mvp_enabled_flag = r.read_flag()
    sps.strong_intra_smoothing_enabled_flag = r.read_flag()
    if r.read_flag():  # vui_parameters_present
        sps.vui = parse_vui(r, sps.sps_max_sub_layers_minus1)
    if r.read_flag():  # sps_extension_present
        # range/multilayer/3d extensions unsupported, same restriction as the
        # reference (src/hevc/parameter_set_reader.rs:153-158)
        raise NotImplementedError("sps_extension not supported")
    return sps


# ---------------------------------------------------------------------------
# PPS (§7.3.2.3)
# ---------------------------------------------------------------------------


def parse_pps(rbsp: bytes) -> g.PictureParameterSet:
    r = BitReader(rbsp)
    pps = g.PictureParameterSet()
    pps.pps_pic_parameter_set_id = r.read_ue()
    pps.pps_seq_parameter_set_id = r.read_ue()
    pps.dependent_slice_segments_enabled_flag = r.read_flag()
    pps.output_flag_present_flag = r.read_flag()
    pps.num_extra_slice_header_bits = r.read_bits(3)
    pps.sign_data_hiding_enabled_flag = r.read_flag()
    pps.cabac_init_present_flag = r.read_flag()
    pps.num_ref_idx_l0_default_active_minus1 = r.read_ue()
    pps.num_ref_idx_l1_default_active_minus1 = r.read_ue()
    pps.init_qp_minus26 = r.read_se()
    pps.constrained_intra_pred_flag = r.read_flag()
    pps.transform_skip_enabled_flag = r.read_flag()
    pps.cu_qp_delta_enabled_flag = r.read_flag()
    if pps.cu_qp_delta_enabled_flag:
        pps.diff_cu_qp_delta_depth = r.read_ue()
    pps.pps_cb_qp_offset = r.read_se()
    pps.pps_cr_qp_offset = r.read_se()
    pps.pps_slice_chroma_qp_offsets_present_flag = r.read_flag()
    pps.weighted_pred_flag = r.read_flag()
    pps.weighted_bipred_flag = r.read_flag()
    pps.transquant_bypass_enabled_flag = r.read_flag()
    pps.tiles_enabled_flag = r.read_flag()
    pps.entropy_coding_sync_enabled_flag = r.read_flag()
    if pps.tiles_enabled_flag:
        pps.num_tile_columns_minus1 = r.read_ue()
        pps.num_tile_rows_minus1 = r.read_ue()
        pps.uniform_spacing_flag = r.read_flag()
        if not pps.uniform_spacing_flag:
            pps.column_width_minus1 = [
                r.read_ue() for _ in range(pps.num_tile_columns_minus1)
            ]
            pps.row_height_minus1 = [
                r.read_ue() for _ in range(pps.num_tile_rows_minus1)
            ]
        pps.loop_filter_across_tiles_enabled_flag = r.read_flag()
    pps.pps_loop_filter_across_slices_enabled_flag = r.read_flag()
    pps.deblocking_filter_control_present_flag = r.read_flag()
    if pps.deblocking_filter_control_present_flag:
        pps.deblocking_filter_override_enabled_flag = r.read_flag()
        pps.pps_deblocking_filter_disabled_flag = r.read_flag()
        if not pps.pps_deblocking_filter_disabled_flag:
            pps.pps_beta_offset_div2 = r.read_se()
            pps.pps_tc_offset_div2 = r.read_se()
    pps.pps_scaling_list_data_present_flag = r.read_flag()
    if pps.pps_scaling_list_data_present_flag:
        pps.scaling_list_data = parse_scaling_list_data(r)
    pps.lists_modification_present_flag = r.read_flag()
    pps.log2_parallel_merge_level_minus2 = r.read_ue()
    pps.slice_segment_header_extension_present_flag = r.read_flag()
    if r.read_flag():  # pps_extension_present
        raise NotImplementedError("pps_extension not supported")
    return pps


# ---------------------------------------------------------------------------
# Oracle helper: force VUI video_full_range_flag to 0 in an SPS NAL
# ---------------------------------------------------------------------------


def patch_sps_full_range(sps_nal: bytes) -> bytes:
    """Return a copy of the SPS NAL (with header) whose VUI
    video_full_range_flag is cleared.

    Purely informational metadata — decoded sample values are unchanged —
    but it makes ffmpeg report yuv420p instead of yuvj420p, so cv2 returns
    the full planar I420 buffer for golden comparison.
    """
    header, payload = sps_nal[:2], sps_nal[2:]
    rbsp = bytearray(remove_emulation_prevention(payload))
    sps = parse_sps(bytes(rbsp))
    if sps.vui is None or sps.vui.full_range_flag_bit_pos < 0:
        return sps_nal
    pos = sps.vui.full_range_flag_bit_pos
    rbsp[pos >> 3] &= ~(1 << (7 - (pos & 7)))
    return header + insert_emulation_prevention(bytes(rbsp))
