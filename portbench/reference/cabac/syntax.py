"""Full I-slice syntax decode: CTU loop, SAO, coding quadtree, intra CUs,
transform trees, residual coding — CABAC bins → SyntaxTensors.

This implements precisely the layers the reference leaves as todo!()
(src/hevc/slice.rs:249-255: sao() and coding_quadtree()) plus the WPP
row protocol it does implement (src/hevc/slice.rs:206-231), following
H.265 §7.3.8 (syntax), §9.3.4.2 (ctxInc derivations) and §8.6.1 (QP
prediction).

Host oracle implementation: the canonical, bit-exact reference for the C++
fast path and the device entropy stage. Output is flat tensors only (see
cabac.types) — the dynamic quadtree is consumed here and never escapes.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.cabac import types as T
from portbench.reference.cabac.engine import CTX_OFFSET, CabacEngine
from portbench.reference.hevc import grammar as g
from portbench.reference.hevc.scans import intra_scan_idx, scan_order, scan_pos_of
from portbench.reference.hevc.slice import ParsedSlice

# §9.3.4.2.5: sig_coeff_flag 4x4 context index map
_SIG_CTX_MAP_4x4 = (0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8)

# Table 8-10 (ChromaArrayType==1): qPi -> QpC for the 30..43 range
_CHROMA_QP_TABLE = (29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37)


def chroma_qp_from_luma(qp_y: int, offset: int, bd_offset_c: int = 0) -> int:
    """QP'Cb/Cr derivation for 4:2:0 (§8.6.1, Table 8-10)."""
    q_pi = min(max(qp_y + offset, -bd_offset_c), 57)
    if q_pi < 30:
        q_pc = q_pi
    elif q_pi <= 43:
        q_pc = _CHROMA_QP_TABLE[q_pi - 30]
    else:
        q_pc = q_pi - 6
    return q_pc + bd_offset_c


class DecodeError(ValueError):
    pass


class TileSyntaxDecoder:
    """Entropy-decodes one single-slice picture (a HEIF tile)."""

    def __init__(
        self,
        sps: g.SequenceParameterSet,
        pps: g.PictureParameterSet,
        parsed: ParsedSlice,
    ):
        self.sps = sps
        self.pps = pps
        self.sh = parsed.header
        self.rbsp = parsed.rbsp
        self.substreams = parsed.substream_ranges()

        if sps.chroma_format_idc not in (0, 1):
            raise NotImplementedError(
                f"chroma_format_idc={sps.chroma_format_idc} not supported "
                "(only 4:0:0 and 4:2:0)"
            )
        self.has_chroma = sps.chroma_format_idc == 1
        if pps.tiles_enabled_flag and pps.entropy_coding_sync_enabled_flag:
            # tiles+WPP simultaneously is legal but needs per-tile
            # per-row substream bookkeeping this decoder doesn't carry
            raise NotImplementedError(
                "tiles + entropy_coding_sync in one PPS is not supported"
            )

        self.W = sps.pic_width_in_luma_samples
        self.H = sps.pic_height_in_luma_samples
        self.ctb_log2 = sps.ctb_log2_size_y
        self.ctb = sps.ctb_size_y
        self.ctbs_x = sps.pic_width_in_ctbs_y
        self.ctbs_y = sps.pic_height_in_ctbs_y
        self.min_cb_log2 = sps.min_cb_log2_size_y
        self.max_tb_log2 = sps.max_tb_log2_size_y
        self.min_tb_log2 = sps.min_tb_log2_size_y
        self.slice_qp_y = self.sh.slice_qp_y(pps)
        self.bd_y = sps.bit_depth_y
        self.bd_c = sps.bit_depth_c
        self.qp_bd_y = 6 * (self.bd_y - 8)  # QpBdOffsetY (§7.4.3.2.1)
        self.qp_bd_c = 6 * (self.bd_c - 8)
        self.log2_min_cu_qp_delta = self.ctb_log2 - pps.diff_cu_qp_delta_depth

        # 4x4-granularity state planes (luma coordinates)
        g4h, g4w = self.H >> 2, self.W >> 2
        self.ct_depth = np.zeros((g4h, g4w), dtype=np.int8)
        self.intra_mode_y = np.full((g4h, g4w), 1, dtype=np.int8)  # DC default
        self.intra_mode_c = np.full((g4h, g4w), 1, dtype=np.int8)
        self.qp_map = np.zeros((g4h, g4w), dtype=np.int8)
        self.bypass_map = np.zeros((g4h, g4w), dtype=bool)
        self.pcm_map = np.zeros((g4h, g4w), dtype=bool)
        self.vert_edges = np.zeros((g4h, g4w), dtype=bool)
        self.horiz_edges = np.zeros((g4h, g4w), dtype=bool)

        # outputs
        self.coeffs = [
            np.zeros((self.H, self.W), dtype=np.int32),
            np.zeros((self.H >> 1, self.W >> 1), dtype=np.int32),
            np.zeros((self.H >> 1, self.W >> 1), dtype=np.int32),
        ]
        self.tu_rows: list[list[int]] = []
        self.sao_params = np.zeros(
            (self.ctbs_y, self.ctbs_x, 3, T.SAO_FIELDS), dtype=np.int16
        )
        self.pcm_planes = [
            np.zeros((self.H, self.W), dtype=np.uint16),
            np.zeros((self.H >> 1, self.W >> 1), dtype=np.uint16),
            np.zeros((self.H >> 1, self.W >> 1), dtype=np.uint16),
        ]

        # tiles (§6.5.1): per-CTB tile ids + tile-scan CTB order. The
        # reference parses this PPS geometry but never decodes it
        # (src/hevc/parameter_set_reader.rs:383-412); here tiles decode
        # with per-tile substreams, context re-init, and tile-aware
        # neighbor availability (§6.4.1).
        self.tiles_on = pps.tiles_enabled_flag
        if self.tiles_on:
            self.tile_map = pps.tile_id_map(sps)
            self.ctb_order = pps.ctb_tile_scan(sps)
            n_tiles = max(max(row) for row in self.tile_map) + 1
            if len(self.substreams) < n_tiles:
                # §7.3.6.1: the slice header must carry n_tiles-1 entry
                # points; a malformed stream would otherwise IndexError
                # mid-decode at the first tile jump
                raise DecodeError(
                    f"slice header has {len(self.substreams)} substream(s)"
                    f" for {n_tiles} tiles"
                )
        else:
            self.tile_map = None
            self.ctb_order = [
                (a % self.ctbs_x, a // self.ctbs_x)
                for a in range(self.ctbs_x * self.ctbs_y)
            ]
            if (
                pps.entropy_coding_sync_enabled_flag
                and self.ctbs_y > 1
                and len(self.substreams) < self.ctbs_y
            ):
                # WPP indexes substreams by CTB row; a malformed header
                # with too few entry points must fail loudly up front
                raise DecodeError(
                    f"slice header has {len(self.substreams)} substream(s)"
                    f" for {self.ctbs_y} WPP rows"
                )

        # engine
        self.engine = CabacEngine(self.rbsp, *self.substreams[0])
        self._wpp_snapshot = None

        # QP prediction state (§8.6.1). QP is tracked per quantization
        # group: the final CuQpDeltaVal applies to every CU of the QG
        # (including CUs parsed before the delta-carrying TU), so qp_map
        # is written when a QG closes, not per CU.
        self.last_cu_qp = self.slice_qp_y  # qPY_PREV
        self.is_cu_qp_delta_coded = False
        self.cu_qp_delta_val = 0
        self.qg_x = 0
        self.qg_y = 0
        self.qg_log2 = self.ctb_log2
        self.qg_pred = self.slice_qp_y
        self.qg_open = False

        # per-CU transient state
        self.cu_bypass = False
        self.cu_pcm = False
        self.intra_split = False
        self.cu_x = 0
        self.cu_y = 0
        self.cu_log2 = 0
        self.cu_chroma_mode = 1

        self.n_bins_est = 0

    # ------------------------------------------------------------------
    # ctx helpers
    # ------------------------------------------------------------------

    def _bin(self, element: str, inc: int = 0) -> int:
        return self.engine.decode_bin(CTX_OFFSET[element] + inc)

    def _same_tile(self, x0: int, y0: int, x1: int, y1: int) -> bool:
        """§6.4.1: a neighbor in a different tile is unavailable.
        Coordinates are luma samples."""
        if not self.tiles_on:
            return True
        cl = self.ctb_log2
        return (
            self.tile_map[y0 >> cl][x0 >> cl]
            == self.tile_map[y1 >> cl][x1 >> cl]
        )

    # ------------------------------------------------------------------
    # top level
    # ------------------------------------------------------------------

    def decode(self) -> T.SyntaxTensors:
        eng = self.engine
        wpp = self.pps.entropy_coding_sync_enabled_flag
        n_ctb = self.ctbs_x * self.ctbs_y
        eng.start()
        eng.init_contexts(self.slice_qp_y)

        cur_tile = 0
        for addr in range(n_ctb):
            x, y = self.ctb_order[addr]
            if self.tiles_on:
                t = self.tile_map[y][x]
                if t != cur_tile:
                    # new tile: jump to its substream, spec re-init ctx
                    # (no inheritance across tiles, §9.3.1), reset
                    # qPY_PREV and close the open QG
                    cur_tile = t
                    start, end = self.substreams[t]
                    eng.bit_pos = start * 8
                    eng.bit_end = end * 8
                    eng.start()
                    eng.init_contexts(self.slice_qp_y)
                    self._finalize_qg()
                    self.last_cu_qp = self.slice_qp_y
            elif wpp and x == 0 and y > 0:
                # new WPP substream: jump to entry point, re-init engine,
                # inherit contexts from after 2nd CTU of the row above
                start, end = self.substreams[y]
                eng.bit_pos = start * 8
                eng.bit_end = end * 8
                eng.start()
                if self.ctbs_x > 1 and self._wpp_snapshot is not None:
                    eng.restore_contexts(self._wpp_snapshot)
                else:
                    eng.init_contexts(self.slice_qp_y)
                # close the previous row's open QG, then reset qPY_PREV
                self._finalize_qg()
                self.last_cu_qp = self.slice_qp_y  # qPY_PREV reset (§8.6.1)
            self._decode_ctu(x, y)
            if wpp and x == 1:
                self._wpp_snapshot = eng.snapshot_contexts()
            end_flag = eng.decode_terminate()
            last = addr == n_ctb - 1
            if end_flag != (1 if last else 0):
                raise DecodeError(
                    f"end_of_slice_segment_flag={end_flag} at CTU {addr} "
                    f"(of {n_ctb}) — desync"
                )
            if not last:
                # end_of_subset_one_bit + alignment at tile / WPP-row ends
                at_subset_end = (
                    self.tiles_on
                    and self.tile_map[self.ctb_order[addr + 1][1]][
                        self.ctb_order[addr + 1][0]
                    ]
                    != cur_tile
                ) or (wpp and x == self.ctbs_x - 1)
                if at_subset_end and eng.decode_terminate() != 1:
                    raise DecodeError(
                        f"end_of_subset_one_bit==0 after CTU ({x},{y}) "
                        "— desync"
                    )
        self._finalize_qg()
        return self._finish()

    def _finish(self) -> T.SyntaxTensors:
        out = T.SyntaxTensors(
            width=self.W,
            height=self.H,
            chroma_format_idc=self.sps.chroma_format_idc,
        )
        out.coeffs = self.coeffs
        out.tu_table = (
            np.asarray(self.tu_rows, dtype=np.int32)
            if self.tu_rows
            else np.zeros((0, T.TU_FIELDS), dtype=np.int32)
        )
        out.intra_mode_y = self.intra_mode_y
        out.intra_mode_c = self.intra_mode_c
        out.qp_y = self.qp_map
        out.bypass_map = self.bypass_map
        out.pcm_map = self.pcm_map
        out.vert_edges = self.vert_edges
        out.horiz_edges = self.horiz_edges
        out.sao = self.sao_params
        out.pcm_planes = self.pcm_planes
        return out

    # ------------------------------------------------------------------
    # SAO (§7.3.8.3)
    # ------------------------------------------------------------------

    def _decode_ctu(self, rx: int, ry: int) -> None:
        if self.sh.slice_sao_luma_flag or self.sh.slice_sao_chroma_flag:
            self._sao(rx, ry)
        x0 = rx << self.ctb_log2
        y0 = ry << self.ctb_log2
        self._coding_quadtree(x0, y0, self.ctb_log2, 0)

    def _sao(self, rx: int, ry: int) -> None:
        eng = self.engine
        cl = self.ctb_log2
        merge_left = merge_up = 0
        # merge candidates must lie in the same tile (§7.3.8.3
        # leftCtbInTile / upCtbInTile)
        if rx > 0 and self._same_tile((rx - 1) << cl, ry << cl,
                                      rx << cl, ry << cl):
            merge_left = self._bin("sao_merge")
        if (
            not merge_left
            and ry > 0
            and self._same_tile(rx << cl, (ry - 1) << cl,
                                rx << cl, ry << cl)
        ):
            merge_up = self._bin("sao_merge")
        if merge_left:
            self.sao_params[ry, rx] = self.sao_params[ry, rx - 1]
            return
        if merge_up:
            self.sao_params[ry, rx] = self.sao_params[ry - 1, rx]
            return

        for c in range(3 if self.has_chroma else 1):
            # cMax per component bit depth (§7.3.8.3)
            bd = self.bd_y if c == 0 else self.bd_c
            cmax_off = (1 << (min(bd, 10) - 5)) - 1
            p = self.sao_params[ry, rx, c]
            if c == 0 and not self.sh.slice_sao_luma_flag:
                continue
            if c > 0 and not self.sh.slice_sao_chroma_flag:
                continue
            if c == 2:
                # sao_type_idx_chroma covers both chroma components
                p[T.SAO_TYPE] = self.sao_params[ry, rx, 1, T.SAO_TYPE]
            else:
                # sao_type_idx: TR cMax=2, bin0 ctx, bin1 bypass
                if self._bin("sao_type") == 0:
                    sao_type = 0
                else:
                    sao_type = 1 + eng.decode_bypass()
                p[T.SAO_TYPE] = sao_type
            if p[T.SAO_TYPE] == 0:
                continue
            offsets = [eng.decode_tr_bypass(cmax_off) for _ in range(4)]
            if p[T.SAO_TYPE] == 1:  # band
                for i in range(4):
                    if offsets[i] != 0 and eng.decode_bypass():
                        offsets[i] = -offsets[i]
                # band position decoded per component, including Cr
                p[T.SAO_CLASS] = eng.decode_bypass_bits(5)
            else:  # edge
                if c <= 1:
                    # sao_eo_class_luma / _chroma (Cr copies chroma's)
                    p[T.SAO_CLASS] = eng.decode_bypass_bits(2)
                else:
                    p[T.SAO_CLASS] = self.sao_params[ry, rx, 1, T.SAO_CLASS]
                # edge signs implicit: categories 1,2 positive; 3,4 negative
                offsets = [offsets[0], offsets[1], -offsets[2], -offsets[3]]
            p[T.SAO_O0 : T.SAO_O0 + 4] = offsets

    # ------------------------------------------------------------------
    # coding quadtree (§7.3.8.4)
    # ------------------------------------------------------------------

    def _coding_quadtree(self, x0: int, y0: int, log2_size: int, depth: int) -> None:
        is_qg = (
            log2_size >= self.log2_min_cu_qp_delta
            if self.pps.cu_qp_delta_enabled_flag
            else depth == 0
        )
        if is_qg:
            # A nested >=threshold node supersedes its parent's reset (the
            # effective QG is the smallest such node); only a node OUTSIDE
            # the open QG closes it.
            if self.qg_open:
                qg_size = 1 << self.qg_log2
                nested = (
                    self.qg_x <= x0 < self.qg_x + qg_size
                    and self.qg_y <= y0 < self.qg_y + qg_size
                )
                if not nested:
                    self._finalize_qg()
            self.is_cu_qp_delta_coded = False
            self.cu_qp_delta_val = 0
            self.qg_x, self.qg_y = x0, y0
            self.qg_log2 = log2_size
            self.qg_pred = self._predict_qp()
            self.qg_open = True

        right_in = x0 + (1 << log2_size) <= self.W
        bottom_in = y0 + (1 << log2_size) <= self.H
        if right_in and bottom_in and log2_size > self.min_cb_log2:
            # split_cu_flag ctx from neighbor depths (§9.3.4.2.2;
            # availability per §6.4.1 excludes other tiles)
            inc = 0
            g4x, g4y = x0 >> 2, y0 >> 2
            if (
                x0 > 0
                and self._same_tile(x0 - 1, y0, x0, y0)
                and self.ct_depth[g4y, g4x - 1] > depth
            ):
                inc += 1
            if (
                y0 > 0
                and self._same_tile(x0, y0 - 1, x0, y0)
                and self.ct_depth[g4y - 1, g4x] > depth
            ):
                inc += 1
            split = self._bin("split_cu", inc)
        else:
            split = 1 if log2_size > self.min_cb_log2 else 0

        if split:
            half = 1 << (log2_size - 1)
            x1, y1 = x0 + half, y0 + half
            self._coding_quadtree(x0, y0, log2_size - 1, depth + 1)
            if x1 < self.W:
                self._coding_quadtree(x1, y0, log2_size - 1, depth + 1)
            if y1 < self.H:
                self._coding_quadtree(x0, y1, log2_size - 1, depth + 1)
            if x1 < self.W and y1 < self.H:
                self._coding_quadtree(x1, y1, log2_size - 1, depth + 1)
        else:
            s4 = 1 << (log2_size - 2)
            g4x, g4y = x0 >> 2, y0 >> 2
            self.ct_depth[g4y : g4y + s4, g4x : g4x + s4] = depth
            self._coding_unit(x0, y0, log2_size)

    # ------------------------------------------------------------------
    # coding unit (§7.3.8.5, intra only)
    # ------------------------------------------------------------------

    def _coding_unit(self, x0: int, y0: int, log2_size: int) -> None:
        sps, pps, eng = self.sps, self.pps, self.engine
        self.cu_x, self.cu_y, self.cu_log2 = x0, y0, log2_size
        self.cu_bypass = False
        self.cu_pcm = False
        size = 1 << log2_size
        s4 = size >> 2
        g4x, g4y = x0 >> 2, y0 >> 2

        if pps.transquant_bypass_enabled_flag:
            self.cu_bypass = bool(self._bin("cu_transquant_bypass"))
        # I-slice: CuPredMode inferred INTRA (no cu_skip/pred_mode flags)

        part_nxn = False
        if log2_size == self.min_cb_log2:
            # part_mode, I slice: 1 -> 2Nx2N, 0 -> NxN (Table 9-34 binar.)
            if self._bin("part_mode") == 0:
                part_nxn = True
        self.intra_split = part_nxn

        pcm_flag = False
        if (
            sps.pcm_enabled_flag
            and not part_nxn
            and log2_size >= sps.log2_min_pcm_luma_coding_block_size_minus3 + 3
            and log2_size
            <= sps.log2_min_pcm_luma_coding_block_size_minus3
            + 3
            + sps.log2_diff_max_min_pcm_luma_coding_block_size
        ):
            pcm_flag = bool(eng.decode_terminate())
        if pcm_flag:
            self._decode_pcm(x0, y0, log2_size)
            return

        # luma intra modes: all prev flags first, then per-PU mode data
        n_pu = 4 if part_nxn else 1
        pb = size >> 1 if part_nxn else size
        prev_flags = [self._bin("prev_intra") for _ in range(n_pu)]
        for i in range(n_pu):
            px = x0 + (i & 1) * pb
            py = y0 + (i >> 1) * pb
            if prev_flags[i]:
                # mpm_idx: TR cMax=2 bypass
                mpm_idx = eng.decode_tr_bypass(2)
                rem = None
            else:
                mpm_idx = None
                rem = eng.decode_bypass_bits(5)
            mode = self._derive_intra_mode(px, py, mpm_idx, rem)
            p4 = pb >> 2
            self.intra_mode_y[
                py >> 2 : (py >> 2) + p4, px >> 2 : (px >> 2) + p4
            ] = mode

        # chroma mode (4:2:0: one per CU; absent when ChromaArrayType==0)
        if self.has_chroma:
            if self._bin("chroma_mode") == 0:
                chroma_idx = 4
            else:
                chroma_idx = eng.decode_bypass_bits(2)
            luma0 = int(self.intra_mode_y[g4y, g4x])
            self.cu_chroma_mode = self._derive_chroma_mode(chroma_idx, luma0)
        else:
            self.cu_chroma_mode = 1
        self.intra_mode_c[g4y : g4y + s4, g4x : g4x + s4] = self.cu_chroma_mode

        self.bypass_map[g4y : g4y + s4, g4x : g4x + s4] = self.cu_bypass

        # transform tree
        max_depth = sps.max_transform_hierarchy_depth_intra + (
            1 if part_nxn else 0
        )
        self._max_trafo_depth = max_depth
        self._transform_tree(x0, y0, x0, y0, log2_size, 0, 0, True, True)

        # CU boundary edges for deblocking
        self.vert_edges[g4y : g4y + s4, g4x] = True
        self.horiz_edges[g4y, g4x : g4x + s4] = True

    def _finalize_qg(self) -> None:
        """Close the current quantization group: its final QpY (with the
        decoded delta) covers the whole QG area."""
        if not self.qg_open:
            return
        # §8.6.1: QpY wraps in [-QpBdOffsetY, 51]
        off = self.qp_bd_y
        qp = (
            (self.qg_pred + self.cu_qp_delta_val + 52 + 2 * off)
            % (52 + off)
        ) - off
        size = 1 << self.qg_log2
        g4x, g4y = self.qg_x >> 2, self.qg_y >> 2
        s4w = min(size, self.W - self.qg_x) >> 2
        s4h = min(size, self.H - self.qg_y) >> 2
        self.qp_map[g4y : g4y + s4h, g4x : g4x + s4w] = qp
        self.last_cu_qp = qp
        self.qg_open = False

    def _current_qp_y(self) -> int:
        """QpY per §8.6.1 (wraps in [-QpBdOffsetY, 51]); same formula as
        _finalize_qg so the TU dequant QP and the deblock qp_map agree
        for >8-bit streams."""
        off = self.qp_bd_y
        return (
            (self.qg_pred + self.cu_qp_delta_val + 52 + 2 * off) % (52 + off)
        ) - off

    def _predict_qp(self) -> int:
        """qPY_PRED = (qPY_A + qPY_B + 1) >> 1 (§8.6.1): neighbors used only
        when inside the same CTB as the quantization group."""
        xq, yq = self.qg_x, self.qg_y
        prev = self.last_cu_qp
        ctb_mask = ~(self.ctb - 1)
        qp_a = prev
        if xq > 0 and ((xq - 1) & ctb_mask) == (xq & ctb_mask):
            qp_a = int(self.qp_map[yq >> 2, (xq - 1) >> 2])
        qp_b = prev
        if yq > 0 and ((yq - 1) & ctb_mask) == (yq & ctb_mask):
            qp_b = int(self.qp_map[(yq - 1) >> 2, xq >> 2])
        return (qp_a + qp_b + 1) >> 1

    # -- intra mode derivation (§8.4.2) --------------------------------

    def _neighbor_luma_mode(self, x: int, y: int, cur_x: int, cur_y: int) -> int:
        """candIntraPredModeN for neighbor at (x, y); DC if unavailable
        (incl. different tile, §6.4.1), PCM, or (for above) outside the
        current CTB row."""
        if x < 0 or y < 0:
            return 1  # INTRA_DC
        if y < (cur_y >> self.ctb_log2) << self.ctb_log2:
            return 1  # above neighbor outside current CTB
        if not self._same_tile(x, y, cur_x, cur_y):
            return 1
        if self.pcm_map[y >> 2, x >> 2]:
            return 1
        return int(self.intra_mode_y[y >> 2, x >> 2])

    def _derive_intra_mode(self, px, py, mpm_idx, rem) -> int:
        cand_a = self._neighbor_luma_mode(px - 1, py, px, py)
        cand_b = self._neighbor_luma_mode(px, py - 1, px, py)
        if cand_a == cand_b:
            if cand_a < 2:
                cands = [0, 1, 26]
            else:
                cands = [
                    cand_a,
                    2 + ((cand_a + 29) % 32),
                    2 + ((cand_a - 2 + 1) % 32),
                ]
        else:
            cands = [cand_a, cand_b]
            for fill in (0, 1, 26):
                if fill not in cands:
                    cands.append(fill)
                    if len(cands) == 3:
                        break
        if mpm_idx is not None:
            return cands[mpm_idx]
        mode = rem
        for c in sorted(cands):
            if mode >= c:
                mode += 1
        return mode

    @staticmethod
    def _derive_chroma_mode(chroma_idx: int, luma_mode: int) -> int:
        """Table 8-3."""
        if chroma_idx == 4:
            return luma_mode
        base = (0, 26, 10, 1)[chroma_idx]
        return 34 if luma_mode == base else base

    # -- PCM (§7.3.8.7) ------------------------------------------------

    def _decode_pcm(self, x0: int, y0: int, log2_size: int) -> None:
        sps, eng = self.sps, self.engine
        size = 1 << log2_size
        g4x, g4y, s4 = x0 >> 2, y0 >> 2, size >> 2
        self.pcm_map[g4y : g4y + s4, g4x : g4x + s4] = True
        self.intra_mode_y[g4y : g4y + s4, g4x : g4x + s4] = 1  # DC for MPM
        self.vert_edges[g4y : g4y + s4, g4x] = True
        self.horiz_edges[g4y, g4x : g4x + s4] = True
        # raw sample bits follow at the next byte-aligned position. At a
        # terminate==1 the decoder's consumed bit count equals the
        # encoder's full arithmetic payload (incl. the EncodeFlush tail,
        # which the 9-bit lookahead in ivlOffset has already covered), so
        # alignment starts from bit_pos itself — NOT bit_pos - 9, which
        # lands a byte early whenever the payload isn't byte-aligned
        # (caught by the synthesized all-PCM fixture vs libde265).
        pos = (eng.bit_pos + 7) & ~7
        bd_l = sps.pcm_sample_bit_depth_luma_minus1 + 1
        bd_c = sps.pcm_sample_bit_depth_chroma_minus1 + 1

        def read_bits(p, n):
            v = 0
            for k in range(n):
                byte = self.rbsp[(p + k) >> 3]
                v = (v << 1) | ((byte >> (7 - ((p + k) & 7))) & 1)
            return v, p + n

        for j in range(size):
            for i in range(size):
                v, pos = read_bits(pos, bd_l)
                self.pcm_planes[0][y0 + j, x0 + i] = v << (self.bd_y - bd_l)
        half = size >> 1
        for c in (1, 2) if self.has_chroma else ():
            for j in range(half):
                for i in range(half):
                    v, pos = read_bits(pos, bd_c)
                    self.pcm_planes[c][(y0 >> 1) + j, (x0 >> 1) + i] = v << (
                        self.bd_c - bd_c
                    )
        # re-init arithmetic engine after pcm_sample (§9.3.1)
        eng.bit_pos = pos
        eng.start()
        # emit TU rows so reconstruction knows these blocks are PCM
        for c in range(3 if self.has_chroma else 1):
            lg = log2_size if c == 0 else log2_size - 1
            xs = x0 if c == 0 else x0 >> 1
            ys = y0 if c == 0 else y0 >> 1
            row = [0] * T.TU_FIELDS
            row[T.TU_COMP] = c
            row[T.TU_X] = xs
            row[T.TU_Y] = ys
            row[T.TU_LOG2] = lg
            row[T.TU_PCM] = 1
            self.tu_rows.append(row)

    # ------------------------------------------------------------------
    # transform tree (§7.3.8.8)
    # ------------------------------------------------------------------

    def _transform_tree(
        self,
        x0,
        y0,
        x_base,
        y_base,
        log2_size,
        depth,
        blk_idx,
        parent_cbf_cb,
        parent_cbf_cr,
    ) -> None:
        if (
            log2_size <= self.max_tb_log2
            and log2_size > self.min_tb_log2
            and depth < self._max_trafo_depth
            and not (self.intra_split and depth == 0)
        ):
            split = bool(self._bin("split_transform", 5 - log2_size))
        else:
            split = (
                log2_size > self.max_tb_log2
                or (self.intra_split and depth == 0)
            )

        cbf_cb = parent_cbf_cb
        cbf_cr = parent_cbf_cr
        if not self.has_chroma:
            cbf_cb = cbf_cr = False
        elif log2_size > 2:
            if depth == 0 or parent_cbf_cb:
                cbf_cb = bool(self._bin("cbf_chroma", depth))
            else:
                cbf_cb = False
            if depth == 0 or parent_cbf_cr:
                cbf_cr = bool(self._bin("cbf_chroma", depth))
            else:
                cbf_cr = False

        if split:
            half = 1 << (log2_size - 1)
            self._transform_tree(
                x0, y0, x0, y0, log2_size - 1, depth + 1, 0, cbf_cb, cbf_cr
            )
            self._transform_tree(
                x0 + half, y0, x0, y0, log2_size - 1, depth + 1, 1, cbf_cb, cbf_cr
            )
            self._transform_tree(
                x0, y0 + half, x0, y0, log2_size - 1, depth + 1, 2, cbf_cb, cbf_cr
            )
            self._transform_tree(
                x0 + half,
                y0 + half,
                x0,
                y0,
                log2_size - 1,
                depth + 1,
                3,
                cbf_cb,
                cbf_cr,
            )
            return

        # leaf: cbf_luma (intra: always decoded)
        cbf_luma = bool(self._bin("cbf_luma", 1 if depth == 0 else 0))
        self._transform_unit(
            x0, y0, x_base, y_base, log2_size, depth, blk_idx, cbf_luma, cbf_cb, cbf_cr
        )

    # ------------------------------------------------------------------
    # transform unit (§7.3.8.10)
    # ------------------------------------------------------------------

    def _emit_tu(self, comp, x, y, log2, cbf, mode, qp, skip, scan) -> None:
        row = [0] * T.TU_FIELDS
        row[T.TU_COMP] = comp
        row[T.TU_X] = x
        row[T.TU_Y] = y
        row[T.TU_LOG2] = log2
        row[T.TU_CBF] = int(cbf)
        row[T.TU_PRED_MODE] = mode
        row[T.TU_QP] = qp
        row[T.TU_SKIP] = int(skip)
        row[T.TU_BYPASS] = int(self.cu_bypass)
        row[T.TU_SCAN] = scan
        self.tu_rows.append(row)
        # TU boundary edges for deblocking (luma grid)
        if comp == 0:
            g4x, g4y, s4 = x >> 2, y >> 2, 1 << (log2 - 2)
            self.vert_edges[g4y : g4y + s4, g4x] = True
            self.horiz_edges[g4y, g4x : g4x + s4] = True

    def _transform_unit(
        self, x0, y0, x_base, y_base, log2_size, depth, blk_idx, cbf_luma, cbf_cb, cbf_cr
    ) -> None:
        eng = self.engine
        chroma_here = log2_size > 2
        last_of_quad = log2_size == 2 and blk_idx == 3
        # chroma cbf gates cu_qp_delta for ALL 4x4 TUs of a quad, not just
        # blkIdx 3 (§7.3.8.10 references the parent-node cbf_cb/cbf_cr)
        any_cbf = cbf_luma or cbf_cb or cbf_cr

        if any_cbf:
            if self.pps.cu_qp_delta_enabled_flag and not self.is_cu_qp_delta_coded:
                self._decode_cu_qp_delta()

        # current QG luma QP (for dequant)
        qp_y = self._current_qp_y()
        qp_prime_y = qp_y + self.qp_bd_y  # Qp'Y (§8.6.1)

        # luma TU
        mode_y = int(self.intra_mode_y[y0 >> 2, x0 >> 2])
        skip_y = False
        if (
            cbf_luma
            and self.pps.transform_skip_enabled_flag
            and not self.cu_bypass
            and log2_size == 2
        ):
            skip_y = bool(self._bin("transform_skip_luma"))
        scan_y = intra_scan_idx(log2_size, mode_y, 0)
        self._emit_tu(0, x0, y0, log2_size, cbf_luma, mode_y, qp_prime_y, skip_y, scan_y)
        if cbf_luma:
            self._residual_coding(x0, y0, log2_size, 0, scan_y, skip_y)

        # chroma TUs (4:2:0)
        if self.has_chroma and (chroma_here or last_of_quad):
            xc = (x0 if chroma_here else x_base) >> 1
            yc = (y0 if chroma_here else y_base) >> 1
            log2c = max(2, log2_size - 1)
            mode_c = self.cu_chroma_mode
            qcb = chroma_qp_from_luma(
                qp_y,
                self.pps.pps_cb_qp_offset + self.sh.slice_cb_qp_offset,
                self.qp_bd_c,
            )
            qcr = chroma_qp_from_luma(
                qp_y,
                self.pps.pps_cr_qp_offset + self.sh.slice_cr_qp_offset,
                self.qp_bd_c,
            )
            scan_c = intra_scan_idx(log2c, mode_c, 1)
            for comp, cbf_c, qpc in ((1, cbf_cb, qcb), (2, cbf_cr, qcr)):
                skip_c = False
                if (
                    cbf_c
                    and self.pps.transform_skip_enabled_flag
                    and not self.cu_bypass
                    and log2c == 2
                ):
                    skip_c = bool(self._bin("transform_skip_chroma"))
                self._emit_tu(comp, xc, yc, log2c, cbf_c, mode_c, qpc, skip_c, scan_c)
                if cbf_c:
                    self._residual_coding(xc, yc, log2c, comp, scan_c, skip_c)

    def _decode_cu_qp_delta(self) -> None:
        """cu_qp_delta_abs: TU cMax=5 (bin0 ctx0, bins1-4 ctx1) + EG0 suffix,
        then bypass sign (§9.3.3.10; reference src/cabac/decoder.rs:263-284)."""
        eng = self.engine
        self.is_cu_qp_delta_coded = True
        if self._bin("cu_qp_delta", 0) == 0:
            return
        prefix = 1
        while prefix < 5 and self._bin("cu_qp_delta", 1) == 1:
            prefix += 1
        val = prefix + eng.decode_egk_bypass(0) if prefix == 5 else prefix
        if val > 0 and eng.decode_bypass():
            val = -val
        self.cu_qp_delta_val = val

    # ------------------------------------------------------------------
    # residual coding (§7.3.8.11)
    # ------------------------------------------------------------------

    def _residual_coding(
        self, x0, y0, log2_size, c_idx, scan_idx, transform_skip
    ) -> None:
        eng = self.engine
        size = 1 << log2_size

        # ---- last significant coefficient position ----
        cmax = (log2_size << 1) - 1
        if c_idx == 0:
            ctx_off = 3 * (log2_size - 2) + ((log2_size - 1) >> 2)
            ctx_shift = (log2_size + 1) >> 2
        else:
            ctx_off = 15
            ctx_shift = log2_size - 2

        def last_prefix(table: str) -> int:
            k = 0
            while k < cmax and self._bin(table, ctx_off + (k >> ctx_shift)):
                k += 1
            return k

        px = last_prefix("last_x")
        py = last_prefix("last_y")

        def last_value(prefix: int) -> int:
            if prefix <= 3:
                return prefix
            n = (prefix >> 1) - 1
            suffix = eng.decode_bypass_bits(n)
            return (1 << n) * (2 + (prefix & 1)) + suffix

        last_x = last_value(px)
        last_y = last_value(py)
        if scan_idx == 2:
            last_x, last_y = last_y, last_x

        sb_size = size >> 2  # subblocks per side
        coef_scan = scan_order(4, scan_idx)
        coef_pos = scan_pos_of(4, scan_idx)
        sb_scan = scan_order(sb_size, scan_idx)
        sb_pos = scan_pos_of(sb_size, scan_idx)

        last_sb = int(sb_pos[last_y >> 2, last_x >> 2])
        last_pos_in_sb = int(coef_pos[last_y & 3, last_x & 3])

        csbf = np.zeros((sb_size, sb_size), dtype=np.uint8)
        plane = self.coeffs[c_idx]
        sign_hiding = (
            self.pps.sign_data_hiding_enabled_flag and not self.cu_bypass
        )
        # lastGreater1Ctx of the previous subblock in THIS transform block
        # (§9.3.4.2.6); None until the first subblock with g1 flags
        prev_g1_ctx = None

        for i in range(last_sb, -1, -1):
            xs = int(sb_scan[i, 0])
            ys = int(sb_scan[i, 1])
            infer_sb_dc = 0
            if i < last_sb and i > 0:
                # csbf ctx from right/below neighbors (§9.3.4.2.4)
                ctx = 0
                if xs + 1 < sb_size and csbf[ys, xs + 1]:
                    ctx = 1
                if ys + 1 < sb_size and csbf[ys + 1, xs]:
                    ctx = 1
                sb_coded = self._bin("csbf", ctx + (2 if c_idx else 0))
                csbf[ys, xs] = sb_coded
                infer_sb_dc = 1
            else:
                csbf[ys, xs] = 1
                sb_coded = 1

            if not sb_coded:
                continue

            # ---- significance map ----
            sig = [0] * 16
            start_n = last_pos_in_sb - 1 if i == last_sb else 15
            if i == last_sb:
                sig[last_pos_in_sb] = 1
            for n in range(start_n, -1, -1):
                if n > 0 or not infer_sb_dc:
                    xp = int(coef_scan[n, 0])
                    yp = int(coef_scan[n, 1])
                    xc = (xs << 2) + xp
                    yc = (ys << 2) + yp
                    inc = self._sig_ctx(
                        log2_size, c_idx, scan_idx, xc, yc, xs, ys, xp, yp, csbf, sb_size
                    )
                    b = self._bin("sig", inc)
                    sig[n] = b
                    if b:
                        infer_sb_dc = 0
                else:
                    sig[n] = 1  # inferred DC significance

            sig_positions = [n for n in range(15, -1, -1) if sig[n]]
            if not sig_positions:
                continue

            # ---- greater1 / greater2 flags (§9.3.4.2.6) ----
            ctx_set = 0 if (i == 0 or c_idx > 0) else 2
            if prev_g1_ctx == 0:
                ctx_set += 1

            greater1_ctx = 1
            g1_flags = {}
            n_g1 = 0
            last_g1_pos = -1
            for n in sig_positions:
                if n_g1 < 8:
                    inc = ctx_set * 4 + min(3, greater1_ctx) + (16 if c_idx else 0)
                    b = self._bin("g1", inc)
                    g1_flags[n] = b
                    n_g1 += 1
                    if b:
                        if last_g1_pos == -1:
                            last_g1_pos = n
                        greater1_ctx = 0
                    elif greater1_ctx > 0:
                        greater1_ctx += 1
            prev_g1_ctx = greater1_ctx

            g2_flag = 0
            if last_g1_pos >= 0:
                g2_flag = self._bin("g2", ctx_set + (4 if c_idx else 0))

            # ---- signs ----
            first_sig = sig_positions[-1]
            last_sig = sig_positions[0]
            hidden = sign_hiding and (last_sig - first_sig) > 3
            signs = {}
            for n in sig_positions:
                if hidden and n == first_sig:
                    continue
                signs[n] = eng.decode_bypass()

            # ---- remaining levels (§9.3.3.13, TR/EGk hybrid, threshold 3) ----
            rice = 0
            levels = {}
            sum_abs = 0
            for n in sig_positions:
                base = 1
                limit = 1
                if n in g1_flags:
                    base += g1_flags[n]
                    limit = 2
                    if g1_flags[n] and n == last_g1_pos:
                        base += g2_flag
                        limit = 3
                level = base
                if base == limit:
                    prefix = 0
                    while eng.decode_bypass():
                        prefix += 1
                        if prefix > 31:
                            # conformant levels are 16-bit; both twins
                            # reject longer prefixes as desync
                            raise DecodeError("remaining prefix overflow")
                    if prefix < 3:
                        rem = (prefix << rice) + (
                            eng.decode_bypass_bits(rice) if rice else 0
                        )
                    else:
                        n_suffix = prefix - 3 + rice
                        suffix = eng.decode_bypass_bits(n_suffix)
                        rem = (((1 << (prefix - 3)) + 2) << rice) + suffix
                    level = base + rem
                    # Rice adaptation: only remaining-level invocations update
                    if level > (3 << rice):
                        rice = min(rice + 1, 4)
                levels[n] = level
                sum_abs += level

            # ---- write coefficients ----
            for n in sig_positions:
                xp = int(coef_scan[n, 0])
                yp = int(coef_scan[n, 1])
                xc = x0 + (xs << 2) + xp
                yc = y0 + (ys << 2) + yp
                level = levels[n]
                if n in signs:
                    if signs[n]:
                        level = -level
                else:
                    # hidden sign: parity of subblock level sum
                    if sum_abs & 1:
                        level = -level
                plane[yc, xc] = level

    # sig ctx derivation (§9.3.4.2.5)
    def _sig_ctx(
        self, log2_size, c_idx, scan_idx, xc, yc, xs, ys, xp, yp, csbf, sb_size
    ) -> int:
        if log2_size == 2:
            sig_ctx = _SIG_CTX_MAP_4x4[(yp << 2) + xp]
        elif xc + yc == 0:
            sig_ctx = 0
        else:
            prev_csbf = 0
            if xs + 1 < sb_size and csbf[ys, xs + 1]:
                prev_csbf |= 1
            if ys + 1 < sb_size and csbf[ys + 1, xs]:
                prev_csbf |= 2
            if prev_csbf == 0:
                sig_ctx = 2 if xp + yp == 0 else (1 if xp + yp < 3 else 0)
            elif prev_csbf == 1:
                sig_ctx = 2 if yp == 0 else (1 if yp == 1 else 0)
            elif prev_csbf == 2:
                sig_ctx = 2 if xp == 0 else (1 if xp == 1 else 0)
            else:
                sig_ctx = 2
            if c_idx == 0:
                if xs + ys > 0:
                    sig_ctx += 3
                if log2_size == 3:
                    sig_ctx += 9 if scan_idx == 0 else 15
                else:
                    sig_ctx += 21
            else:
                sig_ctx += 9 if log2_size == 3 else 12
        return sig_ctx + (27 if c_idx else 0)
