"""Batched multi-tile reconstruction on one device: N tiles in one pass.

Host half (numpy, no torch): a copy of the numpy packer of
heif_tpu/ops/batch.py — CLASSES, BatchPlan, _scaling_for_sps, pack_batch
(the per-TU-table path), _finish_plan and schedule_hints — unchanged in
behaviour. It is copied, not imported, because heif_tpu.ops.batch
imports jax at module level and the port must run where jax is absent.
tests/test_torch_decode.py holds the copy against the original.

Device half (torch): `core` is the port of heif_tpu.ops.batch._core.
Transform classes are flattened across tiles (one dense [k, s, s] batch
per (component, size) class), the intra walks run all tiles at once
(one CUDA block per tile), and deblock / SAO run over the tile axis.
All tiles of an image go in one batch: there is no chunking.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from heif_tpu_torch.device import resolve_device
from heif_tpu_torch.ops import intra as I
from heif_tpu_torch.ops import recon as R
from heif_tpu_torch.tables import tables_on

PAD = R.PAD

# fixed class list: (comp, size)
CLASSES = [
    (0, 4), (0, 8), (0, 16), (0, 32),
    (1, 4), (1, 8), (1, 16),
    (2, 4), (2, 8), (2, 16),
]


@dataclass
class BatchPlan:
    n: int
    width: int
    height: int
    # per class: dict keyed by (comp,size)
    tc_coeffs: dict
    tc_qp: dict
    tc_dst: dict
    tc_skip: dict
    tc_bypass: dict
    # per-BLOCK flat scatter origin into [N*(h+PAD)*(w+PAD)]
    tc_org: dict
    scaling: dict
    # scans: per comp tuple of [N, S, ...] arrays
    xs: list
    counts: list  # per comp [N] int32 real TU counts (scan trip bounds)
    pcm: list  # per comp [N, h+PAD, w+PAD] int32 (or None)
    # loop filter meta, stacked [N, ...]
    qp_map: np.ndarray
    nf_map: np.ndarray
    vert_edges: np.ndarray
    horiz_edges: np.ndarray
    sao: np.ndarray
    ctb_log2: int
    deblock_disabled: bool
    sao_luma: bool
    sao_chroma: bool
    beta_off: int
    tc_off: int
    cb_qp_off: int
    cr_qp_off: int
    strong_smoothing: bool
    bit_depth_y: int = 8
    bit_depth_c: int = 8
    # interior tile boundaries in luma pixels (§6.5.1), () = no tiles;
    # drives §6.4.1 availability in the device intra path
    tile_col_bd: tuple = ()
    tile_row_bd: tuple = ()


def _scaling_for_sps(sps):
    """Per-SPS cache of the 12 scaling-factor matrices (a pure function
    of the SPS scaling lists)."""
    cache = getattr(sps, "_heif_tpu_scaling_cache", None)
    if cache is None:
        from heif_tpu.ops.tables import scaling_factor_matrix

        lists = sps.effective_scaling_lists()
        cache = {
            (size, mid): scaling_factor_matrix(size, mid, lists)
            for size in (4, 8, 16, 32)
            for mid in range(3)
        }
        try:
            sps._heif_tpu_scaling_cache = cache
        except Exception:
            pass
    return cache


def pack_batch(
    syntaxes, sps, pps, slices, n_steps=None, class_caps=None
) -> BatchPlan:
    """Pack N tiles (same SPS/PPS geometry) into one BatchPlan.

    All N tiles' TU tables are concatenated (with a tile column) and every
    per-class / per-component tensor is built by one masked gather over
    the whole batch. n_steps / class_caps: optional shape overrides;
    class_caps maps (comp, size) -> padded block count (padding rows are
    all-zero with org -1).
    """
    from heif_tpu.cabac import types as T
    from heif_tpu.ops.pack import _luma_filter_flags_vec
    from heif_tpu.utils.hostmem import tune_allocator

    tune_allocator()
    n = len(syntaxes)
    st0 = syntaxes[0]
    H, W = st0.height, st0.width
    Hc, Wc = H // 2, W // 2

    tts = [st.tu_table for st in syntaxes]
    lens = np.fromiter((t.shape[0] for t in tts), np.int64, n)
    tt = np.concatenate(tts)
    ti = np.repeat(np.arange(n, dtype=np.int32), lens)
    comp_col = tt[:, T.TU_COMP]

    # per-tile per-component TU counts (scan trip bounds)
    counts = (
        np.bincount(ti * 3 + comp_col, minlength=n * 3)
        .reshape(n, 3)
        .astype(np.int32)
    )
    if n_steps is None:
        n_steps = [max(1, -(-int(s) // 64) * 64) for s in counts.max(axis=0)]

    # ---- per-component pred scans: [n, S] field arrays ----
    xs = []
    for c in range(3):
        mask = comp_col == c
        rows = tt[mask]
        rti = ti[mask]
        cnt_c = counts[:, c].astype(np.int64)
        S = n_steps[c]
        if S < (int(cnt_c.max()) if n else 0):
            raise ValueError(f"n_steps[{c}]={S} < {int(cnt_c.max())} TUs")
        # rows are tile-major (concat order), z-order within each tile:
        # position of each row within its tile's scan
        starts = np.concatenate([[0], np.cumsum(cnt_c)[:-1]])
        pos = np.arange(rows.shape[0], dtype=np.int64) - np.repeat(
            starts, cnt_c
        )
        size_v = (1 << rows[:, T.TU_LOG2]).astype(np.int32)
        fields = []
        for col, vals in (
            (T.TU_X, None),
            (T.TU_Y, None),
            (None, size_v),
            (T.TU_PRED_MODE, None),
            ("filter", None),
            (T.TU_PCM, None),
        ):
            out = np.zeros((n, S), np.int32)
            if col == "filter":
                if c == 0 and rows.shape[0]:
                    out[rti, pos] = _luma_filter_flags_vec(
                        size_v, rows[:, T.TU_PRED_MODE]
                    )
            elif vals is not None:
                out[rti, pos] = vals
            else:
                out[rti, pos] = rows[:, col]
            fields.append(out)
        xs.append(tuple(fields))
    counts_out = [counts[:, c].copy() for c in range(3)]

    # ---- transform classes: one gather per (comp, size) over the batch ----
    cbf_mask = (tt[:, T.TU_CBF] != 0) & (tt[:, T.TU_PCM] == 0)
    tc_coeffs, tc_qp, tc_dst, tc_skip, tc_bypass, tc_org = (
        {}, {}, {}, {}, {}, {},
    )
    for comp, size in CLASSES:
        log2 = size.bit_length() - 1
        mask = cbf_mask & (comp_col == comp) & (tt[:, T.TU_LOG2] == log2)
        k = int(mask.sum())
        cap = None if class_caps is None else class_caps.get((comp, size), 0)
        if not k and not cap:
            continue
        key = (comp, size)
        total = k if cap is None else cap
        if k > total:
            raise ValueError(f"class {key}: {k} > cap {cap}")
        h = H if comp == 0 else Hc
        w = W if comp == 0 else Wc
        stride = (h + PAD) * (w + PAD)
        coeffs = np.zeros((total, size, size), np.int16)
        qp = np.zeros(total, np.int32)
        dst = np.full(total, comp == 0 and size == 4, dtype=bool)
        skip = np.zeros(total, bool)
        byp = np.zeros(total, bool)
        org = np.full(total, -1, np.int32)
        if k:
            rows = tt[mask]
            rti = ti[mask]
            ys = rows[:, T.TU_Y]
            xs_ = rows[:, T.TU_X]
            # HEVC transform blocks are size-aligned in the quadtree, so a
            # strided block view turns the gather into contiguous
            # (size, size) row copies
            from numpy.lib.stride_tricks import as_strided

            by = ys >> log2
            bx = xs_ >> log2
            bounds = np.searchsorted(rti, np.arange(n + 1, dtype=np.int32))
            for t in range(n):
                lo, hi = bounds[t], bounds[t + 1]
                if lo == hi:
                    continue
                pl = syntaxes[t].coeffs[comp]
                hh, ww = pl.shape
                r0, e0 = pl.strides
                bv = as_strided(
                    pl,
                    (hh // size, ww // size, size, size),
                    (size * r0, size * e0, r0, e0),
                )
                np.copyto(
                    coeffs[lo:hi], bv[by[lo:hi], bx[lo:hi]], casting="unsafe"
                )
            qp[:k] = rows[:, T.TU_QP]
            skip[:k] = rows[:, T.TU_SKIP] != 0
            byp[:k] = rows[:, T.TU_BYPASS] != 0
            org[:k] = (
                rti * np.int32(stride)
                + ys.astype(np.int32) * np.int32(w + PAD)
                + xs_.astype(np.int32)
            )
        tc_coeffs[key] = coeffs
        tc_qp[key] = qp
        tc_dst[key] = dst
        tc_skip[key] = skip
        tc_bypass[key] = byp
        tc_org[key] = org

    return _finish_plan(
        syntaxes, sps, pps, slices, n, H, W,
        tc_coeffs, tc_qp, tc_dst, tc_skip, tc_bypass, tc_org,
        xs, counts_out,
    )


def _finish_plan(
    syntaxes, sps, pps, slices, n, H, W,
    tc_coeffs, tc_qp, tc_dst, tc_skip, tc_bypass, tc_org,
    xs, counts_out,
):
    Hc, Wc = H // 2, W // 2
    # ---- PCM sample planes ----
    # presence comes from the PCM block map, not from sample values: a
    # pure-black PCM block (all-zero samples) is still PCM
    any_pcm = any(st.pcm_map.any() for st in syntaxes)
    pcm = []
    for c in range(3):
        h = H if c == 0 else Hc
        w = W if c == 0 else Wc
        if any_pcm:
            arr = np.zeros((n, h + PAD, w + PAD), dtype=np.int32)
            for i, st in enumerate(syntaxes):
                arr[i, :h, :w] = st.pcm_planes[c]
            pcm.append(arr)
        else:
            pcm.append(None)

    # ---- loop-filter metadata ----
    nf_map = np.stack([st.bypass_map for st in syntaxes]).copy()
    if sps.pcm_enabled_flag and sps.pcm_loop_filter_disabled_flag:
        nf_map |= np.stack([st.pcm_map for st in syntaxes])

    # ---- tiles: §6.4.1 availability bounds + boundary deblock ----
    tile_col_bd: tuple = ()
    tile_row_bd: tuple = ()
    vert_edges = np.stack([st.vert_edges for st in syntaxes])
    horiz_edges = np.stack([st.horiz_edges for st in syntaxes])
    if pps.tiles_enabled_flag:
        col_bd, row_bd = pps.tile_bounds(sps)
        cl = sps.ctb_log2_size_y
        tile_col_bd = tuple(b << cl for b in col_bd[1:-1])
        tile_row_bd = tuple(b << cl for b in row_bd[1:-1])
        if not pps.loop_filter_across_tiles_enabled_flag:
            # suppress deblocking of edges ON interior tile boundaries
            # (edge maps are on the 4-sample grid)
            vert_edges = vert_edges.copy()
            horiz_edges = horiz_edges.copy()
            for b in tile_col_bd:
                vert_edges[:, :, b >> 2] = False
            for b in tile_row_bd:
                horiz_edges[:, b >> 2, :] = False

    sh = slices[0].header
    return BatchPlan(
        n=n,
        width=W,
        height=H,
        tc_coeffs=tc_coeffs,
        tc_qp=tc_qp,
        tc_dst=tc_dst,
        tc_skip=tc_skip,
        tc_bypass=tc_bypass,
        tc_org=tc_org,
        scaling=_scaling_for_sps(sps),
        xs=xs,
        counts=counts_out,
        pcm=pcm,
        qp_map=np.stack([st.qp_y for st in syntaxes]).astype(np.int32),
        nf_map=nf_map,
        vert_edges=vert_edges,
        horiz_edges=horiz_edges,
        sao=np.stack([st.sao for st in syntaxes]).astype(np.int32),
        ctb_log2=sps.ctb_log2_size_y,
        deblock_disabled=sh.slice_deblocking_filter_disabled_flag,
        sao_luma=sh.slice_sao_luma_flag,
        sao_chroma=sh.slice_sao_chroma_flag,
        beta_off=sh.slice_beta_offset_div2 * 2,
        tc_off=sh.slice_tc_offset_div2 * 2,
        cb_qp_off=pps.pps_cb_qp_offset,
        cr_qp_off=pps.pps_cr_qp_offset,
        strong_smoothing=bool(sps.strong_intra_smoothing_enabled_flag),
        bit_depth_y=sps.bit_depth_y,
        bit_depth_c=sps.bit_depth_c,
        tile_col_bd=tile_col_bd,
        tile_row_bd=tile_row_bd,
    )


def schedule_hints(rec, sps, pps, n_tiles: int) -> dict:
    """Scheduler inputs from the stream's declared parallelism hints
    (hvcC parallelism_type / min_spatial_segmentation_idc, PPS WPP flag).

    rec: container hvcC record (or None for raw streams). Returns
    {chunk, entropy_workers, parallelism_type,
    min_spatial_segmentation_idc}, recorded in DecodeStats.scheduler.
    """
    import os as _os

    ptype = getattr(rec, "parallelism_type", 0) if rec else 0
    mss = getattr(rec, "min_spatial_segmentation_idc", 0) if rec else 0
    ncpu = _os.cpu_count() or 2
    # WPP (declared via ptype 3, or authoritative in the PPS) means each
    # tile's CTB rows entropy-decode in parallel substreams, so worker
    # threads can exceed the tile count; without it, tiles are the only
    # parallel axis.
    wpp = ptype == 3 or bool(
        getattr(pps, "entropy_coding_sync_enabled_flag", False)
    )
    rows = max(int(getattr(sps, "pic_height_in_ctbs_y", 1)), 1)
    if wpp:
        workers = min(max(n_tiles, 1) * rows, ncpu)
    else:
        workers = min(max(n_tiles, 1), ncpu)
    # idc > 4 bounds segments to at most 4*PicSize/9 < PicSize/2 luma
    # samples: real sub-picture segmentation, so finer chunks pay
    chunk = 16 if mss <= 4 else 8
    return {
        "chunk": chunk,
        "entropy_workers": workers,
        "parallelism_type": ptype,
        "min_spatial_segmentation_idc": mss,
    }


# --------------------------------------------------------------------------
# device half
# --------------------------------------------------------------------------


@contextmanager
def _stage(stats, name: str, device: torch.device):
    """Attribute wall time to stats.stages[name]. On CUDA the stage ends
    in a synchronize (only when stats are kept), so device work is
    charged to the stage that queued it."""
    if stats is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stats.stages[name] = stats.stages.get(name, 0.0) + (
            time.perf_counter() - t0
        )


def plan_to_device(bp: BatchPlan, device: torch.device) -> dict:
    """Ship the BatchPlan arrays to `device`. On CUDA each array goes
    through pinned host memory as a non_blocking copy on the current
    stream (the core's kernels queue behind it on the same stream)."""
    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t

    used = {(size, comp) for comp, size in bp.tc_coeffs}
    return {
        "classes": [
            (*k, put(bp.tc_coeffs[k]), put(bp.tc_qp[k]), put(bp.tc_dst[k]),
             put(bp.tc_skip[k]), put(bp.tc_bypass[k]), put(bp.tc_org[k]))
            for k in bp.tc_coeffs
        ],
        "scaling": {k: put(bp.scaling[k]) for k in used},
        "steps": [put(np.stack(bp.xs[c], axis=-1)) for c in range(3)],
        "counts": [put(bp.counts[c]) for c in range(3)],
        "pcm": [None if p is None else put(p) for p in bp.pcm],
        "qp_map": put(bp.qp_map),
        "nf_map": put(bp.nf_map),
        "vert_edges": put(bp.vert_edges),
        "horiz_edges": put(bp.horiz_edges),
        "sao": put(bp.sao),
    }


def residual_planes(d: dict, bp: BatchPlan, device: torch.device) -> list:
    """Stage 1: every transform class dequantised and inverse-transformed,
    then scattered into [N, h+PAD, w+PAD] int32 planes per component."""
    tables = tables_on(device)
    H, W = bp.height, bp.width
    dims = [(H, W), (H // 2, W // 2), (H // 2, W // 2)]
    classes = []
    for comp, size, coeffs, qp, dst, skip, byp, org in d["classes"]:
        r = R.residual_class(
            coeffs, qp, dst, skip, byp, d["scaling"][(size, comp)], size,
            bp.bit_depth_y if comp == 0 else bp.bit_depth_c, tables,
        )
        classes.append((comp, size, r, org))
    return R.scatter_classes(classes, bp.n, dims, device)


def source_tables(d: dict, bp: BatchPlan) -> list:
    """[luma, chroma] reference-source tables [N, S, 2, 65] uint8. Cb and
    Cr share TU geometry and intra mode (one intra_chroma_pred_mode per
    PU), so one chroma worklist and one table serve both planes."""
    steps = d["steps"]
    return [
        R.ref_sources(
            steps[c][..., 0], steps[c][..., 1], steps[c][..., 2],
            comp=c, W=bp.width, H=bp.height, ctb_log2=bp.ctb_log2,
            tile_col_bd=bp.tile_col_bd, tile_row_bd=bp.tile_row_bd,
        )
        for c in range(2)
    ]


def core(d: dict, bp: BatchPlan, device: torch.device, stats=None) -> list:
    """The batched reconstruction (port of heif_tpu.ops.batch._core).

    d: plan_to_device(bp, device). Returns [Y, Cb, Cr] as [N, h, w] int32
    device tensors.
    """
    tables = tables_on(device)
    H, W = bp.height, bp.width
    Hc, Wc = H // 2, W // 2
    dims = [(H, W), (Hc, Wc), (Hc, Wc)]
    bd_y, bd_c = bp.bit_depth_y, bp.bit_depth_c

    # ---- stage 1: residuals ----
    with _stage(stats, "residual", device):
        res = residual_planes(d, bp, device)

    # ---- stage 2: intra walks ----
    with _stage(stats, "intra", device):
        steps, counts, pcm = d["steps"], d["counts"], d["pcm"]
        srcs = source_tables(d, bp)
        y = I.intra_scan_luma(
            res[0], steps[0], srcs[0], counts[0], pcm[0], h=H, w=W,
            strong_smoothing=bp.strong_smoothing, bd=bd_y,
        )
        cb, cr = I.intra_scan_chroma2(
            res[1], res[2], steps[1], srcs[1], counts[1], pcm[1], pcm[2],
            h=Hc, w=Wc, bd=bd_c,
        )
        planes = [y, cb, cr]

    # ---- stage 3: deblocking ----
    if not bp.deblock_disabled:
        with _stage(stats, "deblock", device):
            planes = _deblock(planes, d, bp, device, tables)

    # ---- stage 4: SAO ----
    if bp.sao_luma or bp.sao_chroma:
        with _stage(stats, "sao", device):
            planes = _sao(planes, d, bp, dims)
    return planes


def _deblock(planes, d, bp, device, tables):
    H, W = bp.height, bp.width
    Hc, Wc = H // 2, W // 2
    qp, nf = d["qp_map"], d["nf_map"]
    ve, he = d["vert_edges"], d["horiz_edges"]
    qT, nT, hT = qp.transpose(1, 2), nf.transpose(1, 2), he.transpose(1, 2)
    bo, to = bp.beta_off, bp.tc_off
    bd_y, bd_c = bp.bit_depth_y, bp.bit_depth_c

    def ar(k, mul, add):
        return torch.arange(k, device=device) * mul + add

    # vertical edges index by W, the transposed (horizontal) pass by H
    cols = ar(W // 8 - 1, 2, 2)
    rows = ar(H // 8 - 1, 2, 2)
    y = R.deblock_luma_pass(
        planes[0], ve[:, :, cols], qp[:, :, cols - 1], qp[:, :, cols],
        nf[:, :, cols - 1], nf[:, :, cols], bo, to, bd_y, tables,
    )
    y = R.deblock_luma_pass(
        y.transpose(1, 2), hT[:, :, rows], qT[:, :, rows - 1], qT[:, :, rows],
        nT[:, :, rows - 1], nT[:, :, rows], bo, to, bd_y, tables,
    ).transpose(1, 2)
    out = [y]

    ccols = ar(Wc // 8 - 1, 4, 4)
    crows = ar(Hc // 8 - 1, 4, 4)
    lut = tables.chroma_qp_lut
    for ci, c_off in ((1, bp.cb_qp_off), (2, bp.cr_qp_off)):
        qp_avg = (qp[:, :, ccols - 1] + qp[:, :, ccols] + 1) >> 1
        qpc = lut[(qp_avg + c_off).clamp(0, 57).long()]
        p = R.deblock_chroma_pass(
            planes[ci], ve[:, :, ccols], qpc, nf[:, :, ccols - 1],
            nf[:, :, ccols], to, bd_c, tables,
        )
        qp_avg_t = (qT[:, :, crows - 1] + qT[:, :, crows] + 1) >> 1
        qpc_t = lut[(qp_avg_t + c_off).clamp(0, 57).long()]
        p = R.deblock_chroma_pass(
            p.transpose(1, 2), hT[:, :, crows], qpc_t, nT[:, :, crows - 1],
            nT[:, :, crows], to, bd_c, tables,
        ).transpose(1, 2)
        out.append(p)
    return out


def _sao(planes, d, bp, dims):
    sao, nf = d["sao"], d["nf_map"]
    out = []
    for c in range(3):
        enabled = bp.sao_luma if c == 0 else bp.sao_chroma
        if not enabled:
            out.append(planes[c])
            continue
        sub = 1 if c == 0 else 2
        cs = (1 << bp.ctb_log2) // sub
        h, w = dims[c]

        def rep(a, k=cs):
            return a.repeat_interleave(k, 1).repeat_interleave(k, 2)[:, :h, :w]

        stype = rep(sao[:, :, :, c, 0])
        sclass = rep(sao[:, :, :, c, 1])
        offs = torch.stack([rep(sao[:, :, :, c, 2 + i]) for i in range(4)], dim=-1)
        nf_pix = rep(nf, 4 // sub)
        out.append(R.sao_component(
            planes[c], stype, sclass, offs, nf_pix,
            bp.bit_depth_y if c == 0 else bp.bit_depth_c,
        ))
    return out


def planes_to_host(planes, bd_y: int, bd_c: int, device, stats=None) -> list:
    """[N, h, w] int32 device planes -> uint8 numpy (uint16 above 8 bits;
    torch's uint16 support is thin, so that cast happens in numpy)."""
    with _stage(stats, "d2h", device):
        if max(bd_y, bd_c) <= 8:
            return [p.to(torch.uint8).cpu().numpy() for p in planes]
        return [p.to(torch.int16).cpu().numpy().astype(np.uint16) for p in planes]


def reconstruct_batch(bp: BatchPlan, device="cuda", stats=None) -> list:
    """Reconstruct a packed batch on `device`; returns [Y, Cb, Cr] numpy
    [N, h, w] planes (uint8, or uint16 above 8 bits)."""
    device = resolve_device(device)
    with _stage(stats, "h2d", device):
        d = plan_to_device(bp, device)
    planes = core(d, bp, device, stats)
    return planes_to_host(planes, bp.bit_depth_y, bp.bit_depth_c, device, stats)


def reconstruct_tiles(syntaxes, sps, pps, slices, device="cuda",
                      stats=None) -> list:
    """Decode-backend entry: all tiles in one batch. Returns a per-tile
    list of [Y, Cb, Cr] numpy planes."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    bp = pack_batch(syntaxes, sps, pps, slices)
    if stats is not None:
        stats.stages["pack"] = stats.stages.get("pack", 0.0) + (
            time.perf_counter() - t0
        )
    planes = reconstruct_batch(bp, device, stats)
    return [[planes[0][i], planes[1][i], planes[2][i]] for i in range(bp.n)]
