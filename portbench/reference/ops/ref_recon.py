"""Bit-exact numpy reference reconstruction (H.265 §8.4-8.7).

The port's copy of heif_tpu/ops/ref_recon.py (logic unchanged): the
host golden behind backend="ref" and chip_smoke.py's oracle for the
device decode. The two implementations must produce identical planes (which are in turn verified
against libde265). Completes the pixel stack absent from the reference
(README.md:7 — "HEVC slice decoding for actual image reconstruction is
still in progress").

Stages:
  residual_planes   dequant (§8.6.3) + inverse DCT/DST (§8.6.4), batched
  intra_reconstruct per-TU prediction (§8.4.4.2) + add, in decode order
  deblock           §8.7.2 (luma strong/weak + chroma), edge-mask driven
  sao               §8.7.3 band/edge offsets per CTB
"""

from __future__ import annotations

import numpy as np

from portbench.reference.cabac import types as T
from portbench.reference.hevc import grammar as g
from portbench.reference.ops.ref_tables import (
    BETA_TABLE,
    DST4,
    LEVEL_SCALE,
    TC_TABLE,
    dct_matrix,
    intra_angle,
    inv_angle,
    INTRA_FILTER_THRES,
    scaling_factor_matrix,
)
from portbench.reference.cabac.syntax import chroma_qp_from_luma


def _clip16(x: np.ndarray) -> np.ndarray:
    return np.clip(x, -32768, 32767)


# --------------------------------------------------------------------------
# Dequant + inverse transform
# --------------------------------------------------------------------------


def dequant_block(
    block: np.ndarray, qp: int, size: int, matrix_id: int, scaling_lists,
    bd: int = 8,
) -> np.ndarray:
    """§8.6.3 scaling process. block: int32 [size,size] quantized levels."""
    log2 = size.bit_length() - 1
    bd_shift = bd + log2 - 5
    m = scaling_factor_matrix(size, matrix_id, scaling_lists)
    scale = int(LEVEL_SCALE[qp % 6]) << (qp // 6)
    d = (block.astype(np.int64) * m * scale + (1 << (bd_shift - 1))) >> bd_shift
    return _clip16(d).astype(np.int32)


def inverse_transform(d: np.ndarray, use_dst: bool, bd: int = 8) -> np.ndarray:
    """§8.6.4.2 two-stage inverse transform, integer exact."""
    n = d.shape[0]
    t = DST4 if use_dst else dct_matrix(n)
    # stage 1 (columns): G = T^T @ D, shift 7, clip 16-bit
    g1 = _clip16((t.T.astype(np.int64) @ d.astype(np.int64) + 64) >> 7)
    # stage 2 (rows): R = G @ T, shift 20-BitDepth
    sh2 = 20 - bd
    r = _clip16((g1 @ t.astype(np.int64) + (1 << (sh2 - 1))) >> sh2)
    return r.astype(np.int32)


def transform_skip_residual(d: np.ndarray, bd: int = 8) -> np.ndarray:
    """§8.6.4.2 transform-skip path (4x4): tsShift=7, bdShift=20-BitDepth."""
    sh2 = 20 - bd
    r = ((d.astype(np.int64) << 7) + (1 << (sh2 - 1))) >> sh2
    return _clip16(r).astype(np.int32)


def residual_planes(
    st: T.SyntaxTensors, sps: g.SequenceParameterSet
) -> list[np.ndarray]:
    """Batched residual computation for every cbf TU -> per-comp planes."""
    planes = [
        np.zeros_like(st.coeffs[0]),
        np.zeros_like(st.coeffs[1]),
        np.zeros_like(st.coeffs[2]),
    ]
    lists = sps.effective_scaling_lists()
    for row in st.tu_table:
        if not row[T.TU_CBF] or row[T.TU_PCM]:
            continue
        c = int(row[T.TU_COMP])
        x, y = int(row[T.TU_X]), int(row[T.TU_Y])
        size = 1 << int(row[T.TU_LOG2])
        blk = st.coeffs[c][y : y + size, x : x + size]
        if row[T.TU_BYPASS]:
            planes[c][y : y + size, x : x + size] = blk
            continue
        bd = sps.bit_depth_y if c == 0 else sps.bit_depth_c
        deq = dequant_block(blk, int(row[T.TU_QP]), size, c, lists, bd)
        if row[T.TU_SKIP]:
            res = transform_skip_residual(deq, bd)
        else:
            use_dst = c == 0 and size == 4  # intra luma 4x4 -> DST
            res = inverse_transform(deq, use_dst, bd)
        planes[c][y : y + size, x : x + size] = res
    return planes


# --------------------------------------------------------------------------
# Z-scan availability
# --------------------------------------------------------------------------


def z_order_plane(width: int, height: int, ctb_log2: int) -> np.ndarray:
    """Z-scan address per 4x4 luma block (§6.5.1 MinTbAddrZs equivalent)."""
    g4w, g4h = width >> 2, height >> 2
    xs = np.arange(g4w, dtype=np.int32)
    ys = np.arange(g4h, dtype=np.int32)
    gx, gy = np.meshgrid(xs, ys)
    cl = ctb_log2 - 2  # 4x4 units per CTB side (log2)
    ctbs_x = -(-g4w // (1 << cl))
    ctb_idx = (gy >> cl) * ctbs_x + (gx >> cl)
    ix = gx & ((1 << cl) - 1)
    iy = gy & ((1 << cl) - 1)
    z = np.zeros_like(gx)
    for b in range(cl):
        z |= ((ix >> b) & 1) << (2 * b)
        z |= ((iy >> b) & 1) << (2 * b + 1)
    return (ctb_idx << (2 * cl)) + z


# --------------------------------------------------------------------------
# Intra prediction (§8.4.4.2)
# --------------------------------------------------------------------------


class IntraPredictor:
    def __init__(self, st: T.SyntaxTensors, sps: g.SequenceParameterSet,
                 pps: "g.PictureParameterSet | None" = None):
        self.st = st
        self.sps = sps
        self.z4 = z_order_plane(st.width, st.height, sps.ctb_log2_size_y)
        self.sub = [1, 2, 2]  # luma/chroma subsampling (4:2:0)
        self.bd = [sps.bit_depth_y, sps.bit_depth_c, sps.bit_depth_c]
        # tiles: per-CTB tile ids — a neighbor in another tile is
        # unavailable for prediction (§6.4.1) even though its samples are
        # already reconstructed
        self.tile_map = None
        self.ctb_log2 = sps.ctb_log2_size_y
        if pps is not None and pps.tiles_enabled_flag:
            self.tile_map = pps.tile_id_map(sps)

    def _available(self, comp: int, xn: int, yn: int, z_cur: int,
                   luma_origin) -> bool:
        """Sample availability (§6.4.1): in picture, earlier in z order,
        same tile. Coordinates are component coords; z compare in luma
        4x4 grid. luma_origin (the current block's luma position) is
        REQUIRED — the different-tile exclusion depends on it, and an
        optional default would silently revert to tile-unaware
        availability (thousands of wrong samples on tiled streams)."""
        sub = self.sub[comp]
        lx, ly = xn * sub, yn * sub
        if lx < 0 or ly < 0 or lx >= self.st.width or ly >= self.st.height:
            return False
        if self.tile_map is not None:
            cl = self.ctb_log2
            if (
                self.tile_map[ly >> cl][lx >> cl]
                != self.tile_map[luma_origin[1] >> cl][luma_origin[0] >> cl]
            ):
                return False
        return self.z4[ly >> 2, lx >> 2] < z_cur

    def reference_samples(
        self, plane: np.ndarray, comp: int, x0: int, y0: int, size: int,
        luma_origin: tuple[int, int],
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """Gather + substitute reference samples (§8.4.4.2.2).

        Returns (left[2S+1], top[2S+1]) where left[0]=top[0]=corner
        p[-1][-1], left[1+i]=p[-1][i] for i in 0..2S-1, top[1+i]=p[i][-1].
        """
        z_cur = self.z4[luma_origin[1] >> 2, luma_origin[0] >> 2]
        n2 = 2 * size
        # ordered sample list: p[-1][2S-1] .. p[-1][-1], p[0][-1] .. p[2S-1][-1]
        coords = [(x0 - 1, y0 + i) for i in range(n2 - 1, -2, -1)]
        coords += [(x0 + i, y0 - 1) for i in range(n2)]
        avail = np.array(
            [
                self._available(comp, cx, cy, z_cur, luma_origin)
                for (cx, cy) in coords
            ]
        )
        h, w = plane.shape
        vals = np.zeros(len(coords), dtype=np.int32)
        for i, (cx, cy) in enumerate(coords):
            if avail[i]:
                vals[i] = plane[cy, cx]
        if not avail.any():
            vals[:] = 1 << (self.bd[comp] - 1)
        else:
            # substitution: first entry takes the first available onwards
            if not avail[0]:
                first = int(np.argmax(avail))
                vals[0] = vals[first]
                avail[0] = True
            for i in range(1, len(coords)):
                if not avail[i]:
                    vals[i] = vals[i - 1]
        left = np.empty(n2 + 1, dtype=np.int32)
        top = np.empty(n2 + 1, dtype=np.int32)
        left[0] = vals[n2]  # corner p[-1][-1]
        left[1:] = vals[n2 - 1 :: -1]  # p[-1][0..2S-1]
        top[0] = vals[n2]
        top[1:] = vals[n2 + 1 :]
        return left, top, z_cur

    @staticmethod
    def _filter_refs(left: np.ndarray, top: np.ndarray, size: int,
                     mode: int, strong_smoothing: bool, bd: int = 8) -> tuple:
        """Reference smoothing (§8.4.4.2.3), luma only."""
        if mode == 1 or size == 4:
            return left, top
        min_dist = min(abs(mode - 26), abs(mode - 10))
        if mode != 0 and min_dist <= INTRA_FILTER_THRES[size]:
            return left, top
        corner = left[0]
        bi = False
        if strong_smoothing and size == 32:
            thr = 1 << (bd - 5)
            bi = (
                abs(int(corner) + int(top[2 * size]) - 2 * int(top[size])) < thr
                and abs(int(corner) + int(left[2 * size]) - 2 * int(left[size]))
                < thr
            )
        lf = left.copy()
        tf = top.copy()
        if bi:
            # §8.4.4.2.3 strong (bilinear) filter: pF[x][-1] =
            # ((63-x)*corner + (x+1)*p[63][-1] + 32) >> 6 for x = 0..62;
            # array slot i holds p[i-1][-1], so the weights are
            # (64-i, i) — (63-i, i+1) here was an off-by-one that
            # surfaced as +-1 errors on flat 32x32 TUs (CTB-64 fixtures)
            i = np.arange(1, 64)
            tf[1:64] = ((64 - i) * int(corner) + i * int(top[64]) + 32) >> 6
            lf[1:64] = ((64 - i) * int(corner) + i * int(left[64]) + 32) >> 6
            tf[64] = top[64]
            lf[64] = left[64]
            corner_f = corner
            lf[0] = tf[0] = corner_f
        else:
            # [1 2 1]
            n2 = 2 * size
            corner_f = (int(left[1]) + 2 * int(corner) + int(top[1]) + 2) >> 2
            lf[1 : n2] = (left[0:n2-1] + 2 * left[1:n2] + left[2:n2+1] + 2) >> 2
            tf[1 : n2] = (top[0:n2-1] + 2 * top[1:n2] + top[2:n2+1] + 2) >> 2
            lf[n2] = left[n2]
            tf[n2] = top[n2]
            lf[0] = tf[0] = corner_f
        return lf, tf

    def predict(
        self, plane: np.ndarray, comp: int, mode: int, x0: int, y0: int,
        size: int, luma_origin: tuple[int, int],
    ) -> np.ndarray:
        left, top, _ = self.reference_samples(
            plane, comp, x0, y0, size, luma_origin
        )
        if comp == 0:
            left, top = self._filter_refs(
                left, top, size, mode,
                self.sps.strong_intra_smoothing_enabled_flag,
                self.bd[0],
            )
        if mode == 0:
            return self._planar(left, top, size)
        if mode == 1:
            return self._dc(left, top, size, comp)
        return self._angular(left, top, size, mode, comp, self.bd[comp])

    @staticmethod
    def _planar(left, top, size):
        s = size
        x = np.arange(s)
        y = np.arange(s)
        px = left[1 : s + 1]  # p[-1][y]
        pt = top[1 : s + 1]  # p[x][-1]
        tr = int(top[s + 1])  # p[nTbS][-1]
        bl = int(left[s + 1])  # p[-1][nTbS]
        log2 = s.bit_length() - 1
        pred = (
            (s - 1 - x)[None, :] * px[:, None]
            + (x + 1)[None, :] * tr
            + (s - 1 - y)[:, None] * pt[None, :]
            + (y + 1)[:, None] * bl
            + s
        ) >> (log2 + 1)
        return pred.astype(np.int32)

    @staticmethod
    def _dc(left, top, size, comp):
        s = size
        log2 = s.bit_length() - 1
        dc = (int(left[1 : s + 1].sum() + top[1 : s + 1].sum()) + s) >> (log2 + 1)
        pred = np.full((s, s), dc, dtype=np.int32)
        if comp == 0 and s < 32:
            pred[0, 1:] = (top[2 : s + 1] + 3 * dc + 2) >> 2
            pred[1:, 0] = (left[2 : s + 1] + 3 * dc + 2) >> 2
            pred[0, 0] = (int(left[1]) + 2 * dc + int(top[1]) + 2) >> 2
        return pred

    @staticmethod
    def _angular(left, top, size, mode, comp, bd=8):
        s = size
        angle = intra_angle(mode)
        vertical = mode >= 18
        main = top if vertical else left  # main[0] = corner
        side = left if vertical else top
        # build ref[] indexed from -s..2s (offset by s)
        ref = np.zeros(3 * s + 2, dtype=np.int32)
        off = s
        ref[off : off + 2 * s + 1] = main[0 : 2 * s + 1]
        if angle < 0:
            ia = inv_angle(angle)
            last = (s * angle) >> 5
            for xx in range(-1, last - 1, -1):
                # index can exceed the side array for (nTbS=4, angle=-2);
                # those entries are provably never read — clamp is safe
                ref[off + xx] = side[min((xx * ia + 128) >> 8, 2 * s)]
        pred = np.zeros((s, s), dtype=np.int32)
        dist = np.arange(1, s + 1)  # (y+1) or (x+1)
        idx = (dist * angle) >> 5
        fact = (dist * angle) & 31
        pos = np.arange(s)
        for d in range(s):
            i = int(idx[d])
            f = int(fact[d])
            row = ref[off + pos + i + 1]
            row2 = ref[off + pos + i + 2]
            line = ((32 - f) * row + f * row2 + 16) >> 5 if f else row
            if vertical:
                pred[d, :] = line
            else:
                pred[:, d] = line
        # pure vertical/horizontal edge compensation (luma, size<32)
        if comp == 0 and s < 32:
            mx = (1 << bd) - 1
            if mode == 26:  # vertical
                delta = (left[1 : s + 1].astype(np.int32) - int(top[0])) >> 1
                pred[:, 0] = np.clip(int(top[1]) + delta, 0, mx)
            elif mode == 10:  # horizontal
                delta = (top[1 : s + 1].astype(np.int32) - int(left[0])) >> 1
                pred[0, :] = np.clip(int(left[1]) + delta, 0, mx)
        return pred


def intra_reconstruct(
    st: T.SyntaxTensors,
    residuals: list[np.ndarray],
    sps: g.SequenceParameterSet,
    pps: "g.PictureParameterSet | None" = None,
) -> list[np.ndarray]:
    """Sequential per-TU predict + add in decode order (tile-scan order
    for tiles-enabled pictures — the TU table is emitted in decode
    order, so the replay is order-correct by construction)."""
    pred = IntraPredictor(st, sps, pps)
    planes = [
        np.zeros((st.height, st.width), dtype=np.int32),
        np.zeros((st.height >> 1, st.width >> 1), dtype=np.int32),
        np.zeros((st.height >> 1, st.width >> 1), dtype=np.int32),
    ]
    for row in st.tu_table:
        c = int(row[T.TU_COMP])
        x, y = int(row[T.TU_X]), int(row[T.TU_Y])
        size = 1 << int(row[T.TU_LOG2])
        if row[T.TU_PCM]:
            planes[c][y : y + size, x : x + size] = st.pcm_planes[c][
                y : y + size, x : x + size
            ]
            continue
        sub = 1 if c == 0 else 2
        luma_origin = (x * sub, y * sub)
        p = pred.predict(
            planes[c], c, int(row[T.TU_PRED_MODE]), x, y, size, luma_origin
        )
        r = residuals[c][y : y + size, x : x + size]
        mx = (1 << pred.bd[c]) - 1
        planes[c][y : y + size, x : x + size] = np.clip(p + r, 0, mx)
    return planes


# --------------------------------------------------------------------------
# Deblocking filter (§8.7.2)
# --------------------------------------------------------------------------


def _no_filter_map(st: T.SyntaxTensors, sps: g.SequenceParameterSet):
    """4x4-grid map of samples exempt from loop filtering: transquant
    bypass CUs and (if pcm_loop_filter_disabled) PCM CUs."""
    m = st.bypass_map.copy()
    if sps.pcm_enabled_flag and sps.pcm_loop_filter_disabled_flag:
        m |= st.pcm_map
    return m


def deblock(
    planes: list[np.ndarray],
    st: T.SyntaxTensors,
    sps: g.SequenceParameterSet,
    pps: g.PictureParameterSet,
    sh: g.SliceSegmentHeader,
) -> list[np.ndarray]:
    if sh.slice_deblocking_filter_disabled_flag:
        return [p.copy() for p in planes]
    y = planes[0].copy()
    cb = planes[1].copy()
    cr = planes[2].copy()
    beta_off = sh.slice_beta_offset_div2 * 2
    tc_off = sh.slice_tc_offset_div2 * 2
    nf = _no_filter_map(st, sps)

    for vertical in (True, False):
        edges = st.vert_edges if vertical else st.horiz_edges
        _deblock_luma_dir(y, st, edges, vertical, beta_off, tc_off, nf,
                          sps.bit_depth_y)
    for vertical in (True, False):
        edges = st.vert_edges if vertical else st.horiz_edges
        _deblock_chroma_dir(
            cb, 1, st, pps, edges, vertical, tc_off, nf, sps.bit_depth_c
        )
        _deblock_chroma_dir(
            cr, 2, st, pps, edges, vertical, tc_off, nf, sps.bit_depth_c
        )
    return [y, cb, cr]


def _deblock_luma_dir(plane, st, edges, vertical, beta_off, tc_off, nf,
                      bd=8):
    """Filter all luma edges in one direction. Operates in-place; HEVC
    applies all vertical edges first (using unfiltered horizontal
    neighbors), then horizontal edges on the vertical result."""
    h, w = plane.shape
    qp = st.qp_y
    # iterate 8-aligned edge positions
    if vertical:
        edge_cols = range(8, w, 8)
    else:
        edge_cols = range(8, h, 8)
    view = plane if vertical else plane.T
    edges_v = edges if vertical else edges.T
    qp_v = qp if vertical else qp.T
    nf_v = nf if vertical else nf.T
    n_seg = (h if vertical else w) // 4
    for e in edge_cols:
        e4 = e >> 2
        for s in range(n_seg):
            y0 = s * 4
            if not edges_v[y0 >> 2, e4]:
                continue
            # bs = 2 (intra); no-filter map per side
            q_blk = (y0 >> 2, e4)
            p_blk = (y0 >> 2, e4 - 1)
            qp_avg = (int(qp_v[p_blk]) + int(qp_v[q_blk]) + 1) >> 1
            # β = β' << (BitDepthY-8), tC = tC' << (BitDepthY-8) (§8.7.2.5.3)
            beta = int(BETA_TABLE[np.clip(qp_avg + beta_off, 0, 51)]) << (bd - 8)
            tc = int(TC_TABLE[np.clip(qp_avg + 2 + tc_off, 0, 53)]) << (bd - 8)
            if beta == 0 and tc == 0:
                continue
            mx = (1 << bd) - 1
            rows = view[y0 : y0 + 4, e - 4 : e + 4].astype(np.int32)
            p3, p2, p1, p0, q0, q1, q2, q3 = rows.T
            dp0 = abs(int(p2[0]) - 2 * int(p1[0]) + int(p0[0]))
            dp3 = abs(int(p2[3]) - 2 * int(p1[3]) + int(p0[3]))
            dq0 = abs(int(q2[0]) - 2 * int(q1[0]) + int(q0[0]))
            dq3 = abs(int(q2[3]) - 2 * int(q1[3]) + int(q0[3]))
            d = dp0 + dq0 + dp3 + dq3
            if d >= beta:
                continue

            def strong_line(i):
                return (
                    2 * (dp0 + dq0 if i == 0 else dp3 + dq3) < (beta >> 2)
                    and abs(int(p3[i]) - int(p0[i])) + abs(int(q0[i]) - int(q3[i]))
                    < (beta >> 3)
                    and abs(int(p0[i]) - int(q0[i])) < ((5 * tc + 1) >> 1)
                )

            strong = strong_line(0) and strong_line(3)
            filter_p = not nf_v[q_blk[0], p_blk[1]]
            filter_q = not nf_v[q_blk[0], q_blk[1]]
            out = rows.copy()
            if strong:
                tc2 = 2 * tc
                if filter_p:
                    out[:, 3] = np.clip(
                        (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                        p0 - tc2, p0 + tc2,
                    )
                    out[:, 2] = np.clip(
                        (p2 + p1 + p0 + q0 + 2) >> 2, p1 - tc2, p1 + tc2
                    )
                    out[:, 1] = np.clip(
                        (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                        p2 - tc2, p2 + tc2,
                    )
                if filter_q:
                    out[:, 4] = np.clip(
                        (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                        q0 - tc2, q0 + tc2,
                    )
                    out[:, 5] = np.clip(
                        (q2 + q1 + q0 + p0 + 2) >> 2, q1 - tc2, q1 + tc2
                    )
                    out[:, 6] = np.clip(
                        (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3,
                        q2 - tc2, q2 + tc2,
                    )
            else:
                dep = dp0 + dp3 < ((beta + (beta >> 1)) >> 3)
                deq = dq0 + dq3 < ((beta + (beta >> 1)) >> 3)
                delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
                mask = np.abs(delta) < tc * 10
                dl = np.clip(delta, -tc, tc)
                if filter_p:
                    out[:, 3] = np.where(mask, np.clip(p0 + dl, 0, mx), p0)
                if filter_q:
                    out[:, 4] = np.where(mask, np.clip(q0 - dl, 0, mx), q0)
                tch = tc >> 1
                if dep and filter_p:
                    dp = np.clip((((p2 + p0 + 1) >> 1) - p1 + dl) >> 1, -tch, tch)
                    out[:, 2] = np.where(mask, np.clip(p1 + dp, 0, mx), p1)
                if deq and filter_q:
                    dq = np.clip((((q2 + q0 + 1) >> 1) - q1 - dl) >> 1, -tch, tch)
                    out[:, 5] = np.where(mask, np.clip(q1 + dq, 0, mx), q1)
            view[y0 : y0 + 4, e - 4 : e + 4] = out


def _deblock_chroma_dir(plane, comp, st, pps, edges, vertical, tc_off, nf,
                        bd=8):
    """Chroma edges every 8 chroma samples (16 luma), processed in 2-chroma-
    line units (one luma 4x4 partition): edge flags and the QP pair — hence
    tC — can change every 4 luma samples along the edge."""
    h, w = plane.shape  # chroma dims
    qp = st.qp_y
    c_off = pps.pps_cb_qp_offset if comp == 1 else pps.pps_cr_qp_offset
    if vertical:
        edge_cols = range(8, w, 8)
    else:
        edge_cols = range(8, h, 8)
    view = plane if vertical else plane.T
    edges_v = edges if vertical else edges.T
    qp_v = qp if vertical else qp.T
    nf_v = nf if vertical else nf.T
    n_units = (h if vertical else w) // 2
    for e in edge_cols:
        el4 = (e * 2) >> 2  # luma 4x4 column of the edge
        for u in range(n_units):
            yc0 = u * 2
            yl4 = (yc0 * 2) >> 2
            if not edges_v[yl4, el4]:
                continue
            qp_avg = (int(qp_v[yl4, el4 - 1]) + int(qp_v[yl4, el4]) + 1) >> 1
            qpc = chroma_qp_from_luma(qp_avg, c_off)
            tc = int(TC_TABLE[np.clip(qpc + 2 + tc_off, 0, 53)]) << (bd - 8)
            if tc == 0:
                continue
            mx = (1 << bd) - 1
            rows = view[yc0 : yc0 + 2, e - 2 : e + 2].astype(np.int32)
            p1, p0, q0, q1 = rows.T
            delta = np.clip((((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tc, tc)
            out = rows.copy()
            if not nf_v[yl4, el4 - 1]:
                out[:, 1] = np.clip(p0 + delta, 0, mx)
            if not nf_v[yl4, el4]:
                out[:, 2] = np.clip(q0 - delta, 0, mx)
            view[yc0 : yc0 + 2, e - 2 : e + 2] = out


# --------------------------------------------------------------------------
# SAO (§8.7.3)
# --------------------------------------------------------------------------

_EO_OFFS = {
    0: ((-1, 0), (1, 0)),
    1: ((0, -1), (0, 1)),
    2: ((-1, -1), (1, 1)),
    3: ((1, -1), (-1, 1)),
}


def sao_filter(
    planes: list[np.ndarray],
    st: T.SyntaxTensors,
    sps: g.SequenceParameterSet,
) -> list[np.ndarray]:
    out = [p.copy() for p in planes]
    nf = _no_filter_map(st, sps)
    ctb = sps.ctb_size_y
    for c in range(3):
        src = planes[c]
        dst = out[c]
        h, w = src.shape
        sub = 1 if c == 0 else 2
        cs = ctb // sub
        bd = sps.bit_depth_y if c == 0 else sps.bit_depth_c
        mx = (1 << bd) - 1
        # saoOffsetVal scale: 1 << (bd - min(bd, 10)) == 1 for 8/10-bit
        oscale = 1 << (bd - min(bd, 10))
        for ry in range(st.sao.shape[0]):
            for rx in range(st.sao.shape[1]):
                params = st.sao[ry, rx, c]
                t = int(params[T.SAO_TYPE])
                if t == 0:
                    continue
                x0, y0 = rx * cs, ry * cs
                x1, y1 = min(x0 + cs, w), min(y0 + cs, h)
                blk = src[y0:y1, x0:x1].astype(np.int32)
                offs = params[T.SAO_O0 : T.SAO_O0 + 4].astype(np.int32) * oscale
                if t == 1:  # band
                    band_pos = int(params[T.SAO_CLASS])
                    bands = blk >> (bd - 5)
                    delta = np.zeros_like(blk)
                    for i in range(4):
                        delta[bands == ((band_pos + i) & 31)] = offs[i]
                    res = np.clip(blk + delta, 0, mx)
                else:  # edge
                    eo = int(params[T.SAO_CLASS])
                    (dx0, dy0), (dx1, dy1) = _EO_OFFS[eo]
                    padded = np.pad(src.astype(np.int32), 1, mode="edge")
                    reg = padded[1 + y0 : 1 + y1, 1 + x0 : 1 + x1]
                    n0 = padded[
                        1 + y0 + dy0 : 1 + y1 + dy0, 1 + x0 + dx0 : 1 + x1 + dx0
                    ]
                    n1 = padded[
                        1 + y0 + dy1 : 1 + y1 + dy1, 1 + x0 + dx1 : 1 + x1 + dx1
                    ]
                    sgn = np.sign(reg - n0) + np.sign(reg - n1)
                    delta = np.zeros_like(blk)
                    delta[sgn == -2] = offs[0]
                    delta[sgn == -1] = offs[1]
                    delta[sgn == 1] = offs[2]
                    delta[sgn == 2] = offs[3]
                    # picture-boundary samples: no offset where a neighbor
                    # falls outside the picture
                    yy, xx = np.mgrid[y0:y1, x0:x1]
                    valid = (
                        (xx + dx0 >= 0) & (xx + dx0 < w)
                        & (yy + dy0 >= 0) & (yy + dy0 < h)
                        & (xx + dx1 >= 0) & (xx + dx1 < w)
                        & (yy + dy1 >= 0) & (yy + dy1 < h)
                    )
                    delta[~valid] = 0
                    res = np.clip(blk + delta, 0, mx)
                # transquant-bypass / pcm samples unchanged
                nfs = nf[y0 * sub >> 2 : y1 * sub >> 2 : 1, x0 * sub >> 2 : x1 * sub >> 2]
                nfe = np.repeat(
                    np.repeat(nfs, 4 // sub, axis=0), 4 // sub, axis=1
                )[: y1 - y0, : x1 - x0]
                res = np.where(nfe, blk, res)
                dst[y0:y1, x0:x1] = res
    return out


# --------------------------------------------------------------------------
# Full tile reconstruction
# --------------------------------------------------------------------------


def reconstruct_tile(
    st: T.SyntaxTensors,
    sps: g.SequenceParameterSet,
    pps: g.PictureParameterSet,
    sh: g.SliceSegmentHeader,
) -> list[np.ndarray]:
    """SyntaxTensors -> final [Y, Cb, Cr] uint8 planes."""
    res = residual_planes(st, sps)
    planes = intra_reconstruct(st, res, sps, pps)
    if pps.tiles_enabled_flag and not pps.loop_filter_across_tiles_enabled_flag:
        if sh.slice_sao_luma_flag or sh.slice_sao_chroma_flag:
            raise NotImplementedError(
                "SAO with loop_filter_across_tiles_enabled_flag=0 is not "
                "supported"
            )
        # suppress deblocking of edges ON tile boundaries: clear the
        # edge flags along interior tile column/row starts (4x4 grid)
        col_bd, row_bd = pps.tile_bounds(sps)
        cl = sps.ctb_log2_size_y
        for cb in col_bd[1:-1]:
            st.vert_edges[:, (cb << cl) >> 2] = False
        for rb in row_bd[1:-1]:
            st.horiz_edges[(rb << cl) >> 2, :] = False
    planes = deblock(planes, st, sps, pps, sh)
    if sh.slice_sao_luma_flag or sh.slice_sao_chroma_flag:
        planes = sao_filter(planes, st, sps)
    dt = np.uint8 if max(sps.bit_depth_y, sps.bit_depth_c) <= 8 else np.uint16
    return [p.astype(dt) for p in planes]
