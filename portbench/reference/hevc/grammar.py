"""HEVC bitstream grammar: NAL header, parameter sets, slice header.

Typed host-side records (parity target: reference src/hevc/grammar.rs:1-592)
with the derived-dimension helpers that feed kernel grid shapes. Unlike the
reference, parsers retain every field reconstruction needs (scaling lists,
VUI, ref-pic-set structure) instead of parse-and-skip.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Optional


class NalUnitType(IntEnum):
    """All 64 H.265 NAL unit types (reference src/hevc/grammar.rs:223-326)."""

    TRAIL_N = 0
    TRAIL_R = 1
    TSA_N = 2
    TSA_R = 3
    STSA_N = 4
    STSA_R = 5
    RADL_N = 6
    RADL_R = 7
    RASL_N = 8
    RASL_R = 9
    RSV_VCL_N10 = 10
    RSV_VCL_R11 = 11
    RSV_VCL_N12 = 12
    RSV_VCL_R13 = 13
    RSV_VCL_N14 = 14
    RSV_VCL_R15 = 15
    BLA_W_LP = 16
    BLA_W_RADL = 17
    BLA_N_LP = 18
    IDR_W_RADL = 19
    IDR_N_LP = 20
    CRA_NUT = 21
    RSV_IRAP_VCL22 = 22
    RSV_IRAP_VCL23 = 23
    RSV_VCL24 = 24
    RSV_VCL25 = 25
    RSV_VCL26 = 26
    RSV_VCL27 = 27
    RSV_VCL28 = 28
    RSV_VCL29 = 29
    RSV_VCL30 = 30
    RSV_VCL31 = 31
    VPS_NUT = 32
    SPS_NUT = 33
    PPS_NUT = 34
    AUD_NUT = 35
    EOS_NUT = 36
    EOB_NUT = 37
    FD_NUT = 38
    PREFIX_SEI_NUT = 39
    SUFFIX_SEI_NUT = 40
    RSV_NVCL41 = 41
    RSV_NVCL42 = 42
    RSV_NVCL43 = 43
    RSV_NVCL44 = 44
    RSV_NVCL45 = 45
    RSV_NVCL46 = 46
    RSV_NVCL47 = 47
    UNSPEC48 = 48
    UNSPEC49 = 49
    UNSPEC50 = 50
    UNSPEC51 = 51
    UNSPEC52 = 52
    UNSPEC53 = 53
    UNSPEC54 = 54
    UNSPEC55 = 55
    UNSPEC56 = 56
    UNSPEC57 = 57
    UNSPEC58 = 58
    UNSPEC59 = 59
    UNSPEC60 = 60
    UNSPEC61 = 61
    UNSPEC62 = 62
    UNSPEC63 = 63

    @property
    def is_irap(self) -> bool:
        """IRAP NAL range 16..23 (reference src/hevc/slice.rs:258-270)."""
        return 16 <= self.value <= 23

    @property
    def is_idr(self) -> bool:
        return self.value in (19, 20)

    @property
    def is_vcl(self) -> bool:
        return self.value <= 31


@dataclass(frozen=True)
class NalUnitHeader:
    """16-bit NAL unit header (reference src/hevc/grammar.rs:349-369)."""

    nal_unit_type: NalUnitType
    nuh_layer_id: int
    nuh_temporal_id_plus1: int

    @classmethod
    def parse(cls, data: bytes) -> "NalUnitHeader":
        if len(data) < 2:
            raise ValueError("NAL unit shorter than its 2-byte header")
        b0, b1 = data[0], data[1]
        if b0 & 0x80:
            raise ValueError("forbidden_zero_bit set in NAL header")
        return cls(
            nal_unit_type=NalUnitType((b0 >> 1) & 0x3F),
            nuh_layer_id=((b0 & 1) << 5) | (b1 >> 3),
            nuh_temporal_id_plus1=b1 & 0x7,
        )


class ChromaFormat(IntEnum):
    MONOCHROME = 0
    YUV420 = 1
    YUV422 = 2
    YUV444 = 3


class SliceType(IntEnum):
    """slice_type values (reference src/hevc/grammar.rs:574-592)."""

    B = 0
    P = 1
    I = 2


@dataclass
class ProfileTierLevel:
    general_profile_space: int = 0
    general_tier_flag: int = 0
    general_profile_idc: int = 0
    general_profile_compatibility_flags: int = 0
    general_constraint_flags: int = 0  # 48 bits
    general_level_idc: int = 0


@dataclass
class VideoParameterSet:
    """VPS (reference src/hevc/grammar.rs:371-385)."""

    vps_video_parameter_set_id: int = 0
    vps_max_layers_minus1: int = 0
    vps_max_sub_layers_minus1: int = 0
    vps_temporal_id_nesting_flag: bool = False
    profile_tier_level: ProfileTierLevel = field(default_factory=ProfileTierLevel)
    vps_sub_layer_ordering_info_present_flag: bool = False
    vps_max_dec_pic_buffering_minus1: list[int] = field(default_factory=list)
    vps_max_num_reorder_pics: list[int] = field(default_factory=list)
    vps_max_latency_increase_plus1: list[int] = field(default_factory=list)
    vps_max_layer_id: int = 0
    vps_num_layer_sets_minus1: int = 0
    vps_timing_info_present_flag: bool = False


@dataclass
class ScalingListData:
    """Decoded scaling lists (H.265 §7.3.4 / §7.4.5).

    scaling_list[size_id][matrix_id] is the up-right-diagonal-ordered coef
    list (length min(64, 1<<(4+2*size_id))); dc[size_id-2][matrix_id] the DC
    coefficient for 16x16/32x32. Defaults per Tables 7-5/7-6 are produced by
    `default()`.
    """

    scaling_list: list[list[list[int]]] = field(default_factory=list)
    dc: list[list[int]] = field(default_factory=list)

    @staticmethod
    def default_list(size_id: int, matrix_id: int) -> list[int]:
        if size_id == 0:
            return [16] * 16
        # Table 7-6: intra (matrix 0..2) vs inter (3..5) 8x8 base lists
        intra = [
            16, 16, 16, 16, 17, 18, 21, 24,
            16, 16, 16, 16, 17, 19, 22, 25,
            16, 16, 17, 18, 20, 22, 25, 29,
            16, 16, 18, 21, 24, 27, 31, 36,
            17, 17, 20, 24, 30, 35, 41, 47,
            18, 19, 22, 27, 35, 44, 54, 65,
            21, 22, 25, 31, 41, 54, 70, 88,
            24, 25, 29, 36, 47, 65, 88, 115,
        ]
        inter = [
            16, 16, 16, 16, 17, 18, 20, 24,
            16, 16, 16, 17, 18, 20, 24, 25,
            16, 16, 17, 18, 20, 24, 25, 28,
            16, 17, 18, 20, 24, 25, 28, 33,
            17, 18, 20, 24, 25, 28, 33, 41,
            18, 20, 24, 25, 28, 33, 41, 54,
            20, 24, 25, 28, 33, 41, 54, 71,
            24, 25, 28, 33, 41, 54, 71, 91,
        ]
        base = intra if matrix_id < 3 else inter
        # Note: these raster-order tables must be converted to the
        # up-right-diagonal scan order used by ScalingList storage. The
        # parser module performs that conversion; see params.default_scaling_list.
        return list(base)

    @classmethod
    def default(cls) -> "ScalingListData":
        # Filled by params.make_default_scaling_lists (needs scan-order maps).
        from portbench.reference.hevc import params

        return params.make_default_scaling_lists()


@dataclass
class ShortTermRefPicSet:
    num_negative_pics: int = 0
    num_positive_pics: int = 0
    delta_poc_s0: list[int] = field(default_factory=list)
    used_by_curr_pic_s0: list[bool] = field(default_factory=list)
    delta_poc_s1: list[int] = field(default_factory=list)
    used_by_curr_pic_s1: list[bool] = field(default_factory=list)

    @property
    def num_delta_pocs(self) -> int:
        return self.num_negative_pics + self.num_positive_pics


@dataclass
class VuiParameters:
    aspect_ratio_idc: Optional[int] = None
    sar_width: int = 0
    sar_height: int = 0
    overscan_appropriate_flag: Optional[bool] = None
    video_format: int = 5
    video_full_range_flag: bool = False
    colour_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coeffs: int = 2
    chroma_sample_loc_type_top_field: int = 0
    chroma_sample_loc_type_bottom_field: int = 0
    neutral_chroma_indication_flag: bool = False
    field_seq_flag: bool = False
    frame_field_info_present_flag: bool = False
    # bit position of video_full_range_flag within the RBSP (for the
    # oracle-stream full-range patch); -1 if absent
    full_range_flag_bit_pos: int = -1


@dataclass
class SequenceParameterSet:
    """SPS with derived-dimension helpers (reference
    src/hevc/grammar.rs:387-508)."""

    sps_video_parameter_set_id: int = 0
    sps_max_sub_layers_minus1: int = 0
    sps_temporal_id_nesting_flag: bool = False
    profile_tier_level: ProfileTierLevel = field(default_factory=ProfileTierLevel)
    sps_seq_parameter_set_id: int = 0
    chroma_format_idc: int = 1
    separate_colour_plane_flag: bool = False
    pic_width_in_luma_samples: int = 0
    pic_height_in_luma_samples: int = 0
    conf_win_left_offset: int = 0
    conf_win_right_offset: int = 0
    conf_win_top_offset: int = 0
    conf_win_bottom_offset: int = 0
    bit_depth_luma_minus8: int = 0
    bit_depth_chroma_minus8: int = 0
    log2_max_pic_order_cnt_lsb_minus4: int = 0
    sps_max_dec_pic_buffering_minus1: list[int] = field(default_factory=list)
    sps_max_num_reorder_pics: list[int] = field(default_factory=list)
    sps_max_latency_increase_plus1: list[int] = field(default_factory=list)
    log2_min_luma_coding_block_size_minus3: int = 0
    log2_diff_max_min_luma_coding_block_size: int = 0
    log2_min_luma_transform_block_size_minus2: int = 0
    log2_diff_max_min_luma_transform_block_size: int = 0
    max_transform_hierarchy_depth_inter: int = 0
    max_transform_hierarchy_depth_intra: int = 0
    scaling_list_enabled_flag: bool = False
    sps_scaling_list_data_present_flag: bool = False
    scaling_list_data: Optional[ScalingListData] = None
    amp_enabled_flag: bool = False
    sample_adaptive_offset_enabled_flag: bool = False
    pcm_enabled_flag: bool = False
    pcm_sample_bit_depth_luma_minus1: int = 0
    pcm_sample_bit_depth_chroma_minus1: int = 0
    log2_min_pcm_luma_coding_block_size_minus3: int = 0
    log2_diff_max_min_pcm_luma_coding_block_size: int = 0
    pcm_loop_filter_disabled_flag: bool = False
    short_term_ref_pic_sets: list[ShortTermRefPicSet] = field(default_factory=list)
    long_term_ref_pics_present_flag: bool = False
    lt_ref_pic_poc_lsb_sps: list[int] = field(default_factory=list)
    used_by_curr_pic_lt_sps_flag: list[bool] = field(default_factory=list)
    sps_temporal_mvp_enabled_flag: bool = False
    strong_intra_smoothing_enabled_flag: bool = False
    vui: Optional[VuiParameters] = None

    # ---- derived dimensions (reference src/hevc/grammar.rs:430-508) ----

    @property
    def min_cb_log2_size_y(self) -> int:
        return self.log2_min_luma_coding_block_size_minus3 + 3

    @property
    def ctb_log2_size_y(self) -> int:
        return self.min_cb_log2_size_y + self.log2_diff_max_min_luma_coding_block_size

    @property
    def ctb_size_y(self) -> int:
        return 1 << self.ctb_log2_size_y

    @property
    def min_tb_log2_size_y(self) -> int:
        return self.log2_min_luma_transform_block_size_minus2 + 2

    @property
    def max_tb_log2_size_y(self) -> int:
        return (
            self.min_tb_log2_size_y
            + self.log2_diff_max_min_luma_transform_block_size
        )

    @property
    def pic_width_in_ctbs_y(self) -> int:
        return -(-self.pic_width_in_luma_samples // self.ctb_size_y)

    @property
    def pic_height_in_ctbs_y(self) -> int:
        return -(-self.pic_height_in_luma_samples // self.ctb_size_y)

    @property
    def pic_size_in_ctbs_y(self) -> int:
        return self.pic_width_in_ctbs_y * self.pic_height_in_ctbs_y

    @property
    def pic_width_in_min_cbs_y(self) -> int:
        return self.pic_width_in_luma_samples >> self.min_cb_log2_size_y

    @property
    def pic_height_in_min_cbs_y(self) -> int:
        return self.pic_height_in_luma_samples >> self.min_cb_log2_size_y

    @property
    def sub_width_c(self) -> int:
        return 2 if self.chroma_format_idc in (1, 2) else 1

    @property
    def sub_height_c(self) -> int:
        return 2 if self.chroma_format_idc == 1 else 1

    @property
    def chroma_array_type(self) -> int:
        return 0 if self.separate_colour_plane_flag else self.chroma_format_idc

    @property
    def bit_depth_y(self) -> int:
        return 8 + self.bit_depth_luma_minus8

    @property
    def bit_depth_c(self) -> int:
        return 8 + self.bit_depth_chroma_minus8

    def effective_scaling_lists(self) -> Optional[ScalingListData]:
        """Scaling lists in effect when scaling_list_enabled_flag is set:
        explicit SPS data or the default matrices (H.265 §7.4.3.2.1)."""
        if not self.scaling_list_enabled_flag:
            return None
        if self.sps_scaling_list_data_present_flag and self.scaling_list_data:
            return self.scaling_list_data
        return ScalingListData.default()


@dataclass
class PictureParameterSet:
    """PPS (reference src/hevc/grammar.rs:510-548)."""

    pps_pic_parameter_set_id: int = 0
    pps_seq_parameter_set_id: int = 0
    dependent_slice_segments_enabled_flag: bool = False
    output_flag_present_flag: bool = False
    num_extra_slice_header_bits: int = 0
    sign_data_hiding_enabled_flag: bool = False
    cabac_init_present_flag: bool = False
    num_ref_idx_l0_default_active_minus1: int = 0
    num_ref_idx_l1_default_active_minus1: int = 0
    init_qp_minus26: int = 0
    constrained_intra_pred_flag: bool = False
    transform_skip_enabled_flag: bool = False
    cu_qp_delta_enabled_flag: bool = False
    diff_cu_qp_delta_depth: int = 0
    pps_cb_qp_offset: int = 0
    pps_cr_qp_offset: int = 0
    pps_slice_chroma_qp_offsets_present_flag: bool = False
    weighted_pred_flag: bool = False
    weighted_bipred_flag: bool = False
    transquant_bypass_enabled_flag: bool = False
    tiles_enabled_flag: bool = False
    entropy_coding_sync_enabled_flag: bool = False
    num_tile_columns_minus1: int = 0
    num_tile_rows_minus1: int = 0
    uniform_spacing_flag: bool = True
    column_width_minus1: list[int] = field(default_factory=list)
    row_height_minus1: list[int] = field(default_factory=list)
    loop_filter_across_tiles_enabled_flag: bool = True
    pps_loop_filter_across_slices_enabled_flag: bool = False
    deblocking_filter_control_present_flag: bool = False
    deblocking_filter_override_enabled_flag: bool = False
    pps_deblocking_filter_disabled_flag: bool = False
    pps_beta_offset_div2: int = 0
    pps_tc_offset_div2: int = 0
    pps_scaling_list_data_present_flag: bool = False
    scaling_list_data: Optional[ScalingListData] = None
    lists_modification_present_flag: bool = False
    log2_parallel_merge_level_minus2: int = 0
    slice_segment_header_extension_present_flag: bool = False

    def tile_bounds(self, sps: "SequenceParameterSet"):
        """Tile column/row CTB boundaries (§6.5.1): returns
        (col_bd, row_bd) where col_bd has num_tile_columns+1 entries in
        CTBs (col i spans [col_bd[i], col_bd[i+1])). Uniform spacing uses
        the spec's integer split; explicit widths fill the remainder into
        the last column/row."""
        ctbs_x = sps.pic_width_in_ctbs_y
        ctbs_y = sps.pic_height_in_ctbs_y
        nc = self.num_tile_columns_minus1 + 1
        nr = self.num_tile_rows_minus1 + 1
        if not self.tiles_enabled_flag:
            return [0, ctbs_x], [0, ctbs_y]
        if self.uniform_spacing_flag:
            col_bd = [(i * ctbs_x) // nc for i in range(nc + 1)]
            row_bd = [(i * ctbs_y) // nr for i in range(nr + 1)]
        else:
            col_bd = [0]
            for w in self.column_width_minus1:
                col_bd.append(col_bd[-1] + w + 1)
            col_bd.append(ctbs_x)
            row_bd = [0]
            for h in self.row_height_minus1:
                row_bd.append(row_bd[-1] + h + 1)
            row_bd.append(ctbs_y)
        return col_bd, row_bd

    def tile_id_map(self, sps: "SequenceParameterSet"):
        """Per-CTB tile id, raster-indexed: list of ctbs_y rows, each a
        list of ctbs_x ints."""
        col_bd, row_bd = self.tile_bounds(sps)
        nc = len(col_bd) - 1
        out = []
        for y in range(sps.pic_height_in_ctbs_y):
            tr = next(i for i in range(len(row_bd) - 1)
                      if row_bd[i] <= y < row_bd[i + 1])
            row = []
            for x in range(sps.pic_width_in_ctbs_y):
                tc = next(i for i in range(nc)
                          if col_bd[i] <= x < col_bd[i + 1])
                row.append(tr * nc + tc)
            out.append(row)
        return out

    def ctb_tile_scan(self, sps: "SequenceParameterSet"):
        """CTB (x, y) coordinates in TILE SCAN order (§6.5.1): tiles in
        raster order, CTBs raster within each tile. Identity raster scan
        when tiles are disabled."""
        col_bd, row_bd = self.tile_bounds(sps)
        out = []
        for tr in range(len(row_bd) - 1):
            for tc in range(len(col_bd) - 1):
                for y in range(row_bd[tr], row_bd[tr + 1]):
                    for x in range(col_bd[tc], col_bd[tc + 1]):
                        out.append((x, y))
        return out


@dataclass
class SliceSegmentHeader:
    """I-slice segment header (reference src/hevc/grammar.rs:550-572)."""

    first_slice_segment_in_pic_flag: bool = True
    no_output_of_prior_pics_flag: bool = False
    slice_pic_parameter_set_id: int = 0
    dependent_slice_segment_flag: bool = False
    slice_segment_address: int = 0
    slice_type: SliceType = SliceType.I
    pic_output_flag: bool = True
    colour_plane_id: int = 0
    slice_sao_luma_flag: bool = False
    slice_sao_chroma_flag: bool = False
    slice_qp_delta: int = 0
    slice_cb_qp_offset: int = 0
    slice_cr_qp_offset: int = 0
    deblocking_filter_override_flag: bool = False
    slice_deblocking_filter_disabled_flag: bool = False
    slice_beta_offset_div2: int = 0
    slice_tc_offset_div2: int = 0
    slice_loop_filter_across_slices_enabled_flag: bool = False
    num_entry_point_offsets: int = 0
    entry_point_offsets: list[int] = field(default_factory=list)
    # byte offset (into the de-emulated slice RBSP) where slice data begins
    data_byte_offset: int = 0

    def slice_qp_y(self, pps: PictureParameterSet) -> int:
        """SliceQpY = 26 + init_qp_minus26 + slice_qp_delta (H.265 §7.4.7.1;
        reference src/cabac/decoder.rs:15)."""
        return 26 + pps.init_qp_minus26 + self.slice_qp_delta
