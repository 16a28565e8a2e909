"""Batched multi-tile reconstruction on one device: N tiles in one pass.

Host half (numpy, no torch): a copy of the numpy packer of
heif_tpu/ops/batch.py — CLASSES, BatchPlan, _scaling_for_sps, pack_batch
(the per-TU-table path and the native pre-pack path, _assemble_packed),
_finish_plan and schedule_hints — unchanged in behaviour, with
_luma_filter_flags_vec from heif_tpu/ops/pack.py. The port imports
nothing of heif_tpu. tests/test_torch_decode.py and
tests/test_torch_overlap.py hold the copy against the original.

Device half (torch): `core` is the port of heif_tpu.ops.batch._core.
Transform classes are flattened across tiles (one dense [k, s, s] batch
per (component, size) class) and go through one residual launch
(ops.residual), the reference-source tables one launch for both
worklists (ops.refsrc), the intra walks run all tiles at once (one CUDA
block per tile), and deblock / SAO run over the tile axis
(ops.loopfilter: one deblocking launch and one SAO launch a batch).

Entry points: reconstruct_tiles (all tiles of an image in one batch, the
path of HeicDecoder.decode) and the bulk paths, which cut the tiles into
chunks: reconstruct_pipelined, decode_reconstruct_overlapped (host
entropy of chunk k+1 on a worker thread while chunk k is packed and on
the device; async readback or decode-to-device) and decode_burst (the
chunks of many images through one entropy queue). Each chunk packs at
its own minimal shape: nothing is compiled per shape, so the reference's
sticky shape caps are not needed, and chunks hold only real tiles.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from heif_tpu_torch.device import resolve_device
from heif_tpu_torch.ops import intra as I
from heif_tpu_torch.ops import loopfilter as LF
from heif_tpu_torch.ops import recon as R
from heif_tpu_torch.ops import refsrc as RF
from heif_tpu_torch.ops import residual as RS
from heif_tpu_torch.utils.profiling import device_seconds, span

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
        from heif_tpu_torch.ops.ref_tables import scaling_factor_matrix

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


# filter threshold indexed by log2 size (2..5); size 4 never filters
_FILTER_THRES_BY_LOG2 = np.array([99, 99, 99, 7, 1, 0], dtype=np.int32)


def _luma_filter_flags_vec(size: np.ndarray, mode: np.ndarray) -> np.ndarray:
    """Luma reference-smoothing eligibility (§8.4.4.2.3) over TU arrays
    (copy of heif_tpu/ops/pack.py's)."""
    log2 = np.log2(np.maximum(size, 1)).astype(np.int32)
    min_dist = np.minimum(np.abs(mode - 26), np.abs(mode - 10))
    out = (mode == 0) | (min_dist > _FILTER_THRES_BY_LOG2[log2])
    return out & (mode != 1) & (size != 4)


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
    from heif_tpu_torch.cabac import types as T
    from heif_tpu_torch.utils.hostmem import tune_allocator

    tune_allocator()
    n = len(syntaxes)
    st0 = syntaxes[0]
    H, W = st0.height, st0.width
    Hc, Wc = H // 2, W // 2

    if all(
        getattr(st, "packed", None) is not None and st.packed.pad == PAD
        for st in syntaxes
    ):
        xs, counts_out, tc = _assemble_packed(
            syntaxes, n, H, W, n_steps, class_caps
        )
        return _finish_plan(
            syntaxes, sps, pps, slices, n, H, W, *tc, xs, counts_out
        )

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


def _assemble_packed(syntaxes, n, H, W, n_steps, class_caps):
    """The plan tensors from native per-tile packs (st.packed, made by
    heif_tpu_torch.native.pack_tile_native inside the entropy workers): segment
    copies only, no per-TU work on the calling thread. Returns (xs,
    counts, (tc_coeffs, tc_qp, tc_dst, tc_skip, tc_bypass, tc_org))."""
    Hc, Wc = H // 2, W // 2
    packs = [st.packed for st in syntaxes]
    counts = np.array(
        [[p.scans[c].shape[1] for c in range(3)] for p in packs], np.int32
    ).reshape(n, 3)
    if n_steps is None:
        n_steps = [max(1, -(-int(s) // 64) * 64) for s in counts.max(axis=0)]

    xs = []
    for c in range(3):
        S = n_steps[c]
        if S < int(counts[:, c].max()):
            raise ValueError(
                f"n_steps[{c}]={S} < {int(counts[:, c].max())} TUs")
        fields = [np.zeros((n, S), np.int32) for _ in range(6)]
        for i, p in enumerate(packs):
            sc = p.scans[c]
            for f in range(6):
                fields[f][i, : sc.shape[1]] = sc[f]
        xs.append(tuple(fields))
    counts_out = [counts[:, c].copy() for c in range(3)]

    tc_coeffs, tc_qp, tc_dst, tc_skip, tc_bypass, tc_org = (
        {}, {}, {}, {}, {}, {},
    )
    for ci, (comp, size) in enumerate(CLASSES):
        ks = [int(p.cls_counts[ci]) for p in packs]
        k = sum(ks)
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
        lo = 0
        for i, p in enumerate(packs):
            if not ks[i]:
                continue
            blocks, meta = p.cls[ci]
            hi = lo + ks[i]
            coeffs[lo:hi] = blocks
            qp[lo:hi] = meta[0]
            skip[lo:hi] = meta[1]
            byp[lo:hi] = meta[2]
            np.add(meta[3], np.int32(i * stride), out=org[lo:hi])
            lo = hi
        tc_coeffs[key] = coeffs
        tc_qp[key] = qp
        tc_dst[key] = dst
        tc_skip[key] = skip
        tc_bypass[key] = byp
        tc_org[key] = org
    tc = (tc_coeffs, tc_qp, tc_dst, tc_skip, tc_bypass, tc_org)
    return xs, counts_out, tc


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


# byte alignment of each array in a plan's buffer: every view starts
# aligned for its dtype and for the kernels' vector loads
ALIGN = 256
_TORCH_DTYPE = {np.dtype(np.bool_): torch.bool,
                np.dtype(np.int16): torch.int16,
                np.dtype(np.int32): torch.int32}


def _ship(arrays: list, device: torch.device, stats=None) -> list:
    """`arrays` as views of one buffer on `device`: each array is written
    once into one host buffer (pinned on CUDA, from torch's caching host
    allocator, which reuses a block only once its copy is done) at an
    ALIGN-rounded offset, and the buffer goes over in one non_blocking
    copy on the current stream; on the CPU the views are of the host
    buffer itself. An entry that is a tuple of equal-shape arrays ships
    as their stack on a new last axis. stats counts h2d_copies (one) and
    h2d_bytes (the buffer, padding included)."""
    slots, total = [], 0
    for a in arrays:
        one = a[0] if isinstance(a, tuple) else a
        shape = one.shape + ((len(a),) if isinstance(a, tuple) else ())
        nbytes = one.dtype.itemsize * int(np.prod(shape))
        slots.append((total, nbytes, shape, one.dtype))
        total += -(-nbytes // ALIGN) * ALIGN
    host = torch.empty(total, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    raw = host.numpy()
    for a, (off, nbytes, shape, dt) in zip(arrays, slots):
        dst = raw[off:off + nbytes].view(dt).reshape(shape)
        if isinstance(a, tuple):
            for f, x in enumerate(a):
                dst[..., f] = x
        else:
            dst[...] = a
    buf = (host.to(device, non_blocking=True) if device.type == "cuda"
           else host)
    if stats is not None:
        c = stats.counters
        c["h2d_copies"] = c.get("h2d_copies", 0) + 1
        c["h2d_bytes"] = c.get("h2d_bytes", 0) + total
    typed = {dt: buf.view(_TORCH_DTYPE[dt]) for dt in {s[3] for s in slots}}
    return [typed[dt][off // dt.itemsize:(off + nbytes) // dt.itemsize]
            .view(shape) for off, nbytes, shape, dt in slots]


def plan_to_device(bp: BatchPlan, device: torch.device, stats=None,
                   events=None) -> dict:
    """Ship the BatchPlan arrays to `device` as views of one buffer in
    one copy (_ship); the steps of component c are its six scan fields
    bp.xs[c] stacked on the last axis, [N, S, 6]. The core's kernels
    queue behind the copy on the same stream. On CUDA the intra kernels'
    schedules ("schedules", unit_tables) are built there from the
    shipped worklists; the plain walks on the CPU need none ([None,
    None]). The span h2d covers it all; stats also counts h2d_copies,
    one a plan, and h2d_bytes; events: see utils.profiling.span."""
    used = sorted({(size, comp) for comp, size in bp.tc_coeffs})
    with span("h2d", stats, events):
        arrays = [a for k in bp.tc_coeffs
                  for a in (bp.tc_coeffs[k], bp.tc_qp[k], bp.tc_dst[k],
                            bp.tc_skip[k], bp.tc_bypass[k], bp.tc_org[k])]
        arrays += [bp.scaling[k] for k in used]
        arrays += [*bp.xs, *bp.counts, *(p for p in bp.pcm if p is not None),
                   bp.qp_map, bp.nf_map, bp.vert_edges, bp.horiz_edges,
                   bp.sao]
        ts = iter(_ship(arrays, device, stats))  # in the order of arrays
        d = {
            "classes": [(*k, *(next(ts) for _ in range(6)))
                        for k in bp.tc_coeffs],
            "scaling": {k: next(ts) for k in used},
            "steps": [next(ts) for _ in range(3)],
            "counts": [next(ts) for _ in range(3)],
            "pcm": [None if p is None else next(ts) for p in bp.pcm],
            "qp_map": next(ts),
            "nf_map": next(ts),
            "vert_edges": next(ts),
            "horiz_edges": next(ts),
            "sao": next(ts),
        }
        d["schedules"] = (unit_tables(d, bp) if device.type == "cuda"
                          else [None, None])
    return d


def walk_ctb_log2(bp: BatchPlan, comp: int) -> int:
    """log2 of the CTB size in samples of component comp (4:2:0)."""
    return bp.ctb_log2 - (1 if comp else 0)


def unit_tables(d: dict, bp: BatchPlan) -> list:
    """[luma, chroma] wavefront schedules of the intra kernels
    (ops.intra.unit_table) of the plan's worklists d["steps"], on their
    device, like source_tables."""
    out = []
    for c in range(2):
        sub = 1 if c == 0 else 2
        cl = walk_ctb_log2(bp, c)
        out.append(I.unit_table(
            d["steps"][c], d["counts"][c], ctb_log2=cl,
            rows=-(-(bp.height // sub) >> cl),
            tile_col_bd=tuple(b // sub for b in bp.tile_col_bd),
            tile_row_bd=tuple(b // sub for b in bp.tile_row_bd)))
    return out


def source_tables(d: dict, bp: BatchPlan) -> list:
    """[luma, chroma] reference-source tables [N, S, 2, 65] uint8
    (ops.refsrc.ref_sources2: one kernel launch for both on CUDA). Cb and
    Cr share TU geometry and intra mode (one intra_chroma_pred_mode per
    PU), so one chroma worklist and one table serve both planes."""
    return RF.ref_sources2(
        d["steps"][0], d["steps"][1], W=bp.width, H=bp.height,
        ctb_log2=bp.ctb_log2, tile_col_bd=bp.tile_col_bd,
        tile_row_bd=bp.tile_row_bd,
    )


def core(d: dict, bp: BatchPlan, device: torch.device, stats=None,
         events=None) -> list:
    """The batched reconstruction (port of heif_tpu.ops.batch._core).

    d: plan_to_device(bp, device). Returns [Y, Cb, Cr] as [N, h, w] int32
    device tensors, queued with no synchronize. Its four stages are the
    spans residual, intra, deblock and sao (stats, events: see
    utils.profiling.span).
    """
    H, W = bp.height, bp.width
    Hc, Wc = H // 2, W // 2
    bd_y, bd_c = bp.bit_depth_y, bp.bit_depth_c

    # ---- stage 1: residuals (one launch on CUDA) ----
    with span("residual", stats, events):
        res = RS.residual_planes(d, bp)

    # ---- stage 2: source tables (one launch on CUDA), intra walks ----
    with span("intra", stats, events):
        steps, counts, pcm, sch = (d["steps"], d["counts"], d["pcm"],
                                   d["schedules"])
        srcs = source_tables(d, bp)
        y = I.intra_scan_luma(
            res[0], steps[0], srcs[0], counts[0], pcm[0], h=H, w=W,
            strong_smoothing=bp.strong_smoothing, bd=bd_y, schedule=sch[0],
        )
        cb, cr = I.intra_scan_chroma2(
            res[1], res[2], steps[1], srcs[1], counts[1], pcm[1], pcm[2],
            h=Hc, w=Wc, bd=bd_c, schedule=sch[1],
        )
        planes = [y, cb, cr]

    # ---- stage 3: deblocking (one launch on CUDA) ----
    if not bp.deblock_disabled:
        with span("deblock", stats, events):
            planes = LF.deblock(planes, d, bp)

    # ---- stage 4: SAO (one launch on CUDA) ----
    if bp.sao_luma or bp.sao_chroma:
        with span("sao", stats, events):
            planes = LF.sao(planes, d, bp)
    return planes


def out_dtype(bd_y: int, bd_c: int) -> torch.dtype:
    """Device dtype of decoded planes: uint8 up to 8 bits, int16 above.
    torch's uint16 support is thin; int16 holds every sample of up to 15
    bits, and the host view of it is uint16 (host_view)."""
    return torch.uint8 if max(bd_y, bd_c) <= 8 else torch.int16


def host_view(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(np.uint16) if a.dtype == np.int16 else a


def reconstruct_batch(bp: BatchPlan, device="cuda", stats=None) -> list:
    """Reconstruct a packed batch on `device`; returns [Y, Cb, Cr] numpy
    [N, h, w] planes (uint8, or uint16 above 8 bits). The spans h2d,
    launch and d2h; with stats on CUDA, also the device seconds of h2d,
    core's four stages and d2h (stats.device), from CUDA event pairs read
    once the D2H copy, which synchronizes, is done."""
    device = resolve_device(device)
    events = [] if stats is not None and device.type == "cuda" else None
    d = plan_to_device(bp, device, stats, events)
    dt = out_dtype(bp.bit_depth_y, bp.bit_depth_c)
    with span("launch", stats):
        planes = [p.to(dt) for p in core(d, bp, device, stats, events)]
    with span("d2h", stats, events):
        out = [host_view(p.cpu()) for p in planes]
    if events is not None:
        device_seconds(stats, events)
    return out


def reconstruct_tiles(syntaxes, sps, pps, slices, device="cuda",
                      stats=None) -> list:
    """Decode-backend entry: all tiles in one batch. Returns a per-tile
    list of [Y, Cb, Cr] numpy planes."""
    device = resolve_device(device)
    with span("pack", stats):
        bp = pack_batch(syntaxes, sps, pps, slices)
    planes = reconstruct_batch(bp, device, stats)
    return [[planes[0][i], planes[1][i], planes[2][i]] for i in range(bp.n)]


# --------------------------------------------------------------------------
# bulk paths: chunked, overlapped, decode-to-device, burst
# --------------------------------------------------------------------------


def device_planes(bp: BatchPlan, device: torch.device, stats=None) -> list:
    """H2D + core for one packed chunk, queued on the current stream with
    no synchronize: [Y, Cb, Cr] contiguous [N, h, w] device planes in
    out_dtype. stats: the spans h2d and launch and the h2d_copies and
    h2d_bytes counters; core's own stages are left to the trace."""
    device = resolve_device(device)
    d = plan_to_device(bp, device, stats)
    dt = out_dtype(bp.bit_depth_y, bp.bit_depth_c)
    with span("launch", stats):
        return [p.to(dtype=dt, memory_format=torch.contiguous_format)
                for p in core(d, bp, device)]


class Readback:
    """Async D2H of device planes into pinned host tensors.

    On CUDA each submit orders a side stream after the current (compute)
    stream, copies there non_blocking into freshly allocated pinned
    tensors, marks the source with record_stream (so the allocator does
    not hand its memory to later work before the copy has read it) and
    records one event. No pinned buffer is ever rewritten: the caching
    host allocator frees a block for reuse only after the work recorded
    on it has completed. drain() waits on each event. On the CPU the
    planes are already host tensors.
    """

    def __init__(self):
        self._streams: dict = {}
        self._pending: list = []

    def submit(self, planes: list) -> None:
        dev = planes[0].device
        if dev.type != "cuda":
            self._pending.append((planes, None))
            return
        side = self._streams.get(dev)
        if side is None:
            side = self._streams[dev] = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        host = []
        with torch.cuda.device(dev), torch.cuda.stream(side):
            for p in planes:
                h = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                h.copy_(p, non_blocking=True)
                p.record_stream(side)
                host.append(h)
            ev = torch.cuda.Event()
            ev.record(side)
        self._pending.append((host, ev))

    def drain(self) -> list:
        """Per submit, in order, the [Y, Cb, Cr] numpy planes (uint8, or
        uint16 above 8 bits)."""
        out = []
        for host, ev in self._pending:
            if ev is not None:
                ev.synchronize()
            out.append([host_view(h) for h in host])
        self._pending = []
        return out


def stack_chunks(per_chunk: list) -> list:
    return [np.concatenate([o[c] for o in per_chunk], axis=0) for c in range(3)]


def reconstruct_pipelined(syntaxes, sps, pps, slices, chunk: int = 12,
                          device="cuda") -> list:
    """Chunked counterpart of reconstruct_tiles: chunks of `chunk` tiles
    are packed, shipped and queued one after another, each chunk's
    readback overlapping the next chunk's pack. Returns [Y, Cb, Cr]
    stacked numpy planes of all N tiles (uint8, or uint16 above 8 bits)."""
    device = resolve_device(device)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    rb = Readback()
    for lo in range(0, len(syntaxes), chunk):
        bp = pack_batch(syntaxes[lo : lo + chunk], sps, pps,
                        slices[lo : lo + chunk])
        rb.submit(device_planes(bp, device))
    with span("readback"):
        return stack_chunks(rb.drain())


def default_entropy(sps, pps, hints: dict, stats=None):
    """The overlapped paths' entropy: native C++ with pack_pad=PAD, so
    each worker also pre-packs its tile and pack_batch only copies
    segments (GIL released inside); the Python twin without native.
    stats: receives the native pool's counters (entropy_tasks,
    entropy_busy_s, entropy_bins; native.decode_tiles_parallel)."""
    from heif_tpu_torch import native

    if native.available():
        workers = hints.get("entropy_workers")
        return lambda ps: native.decode_tiles_parallel(
            sps, pps, ps, pack_pad=PAD, max_workers=workers, stats=stats
        )
    from heif_tpu_torch.cabac.syntax import TileSyntaxDecoder

    return lambda ps: [TileSyntaxDecoder(sps, pps, p).decode() for p in ps]


def run_chunks(chunks, entropy_fn, step, stats=None) -> None:
    """The overlapped loop. A one-thread executor runs entropy_fn over
    every chunk of slices in order (native entropy releases the GIL and
    fans out to its own pool; that thread never touches torch). This
    thread waits for each chunk's syntax and calls step(i, syntaxes,
    slices), which packs and queues device work without synchronizing.
    stats: the spans entropy (the worker's wall) and entropy_wait (this
    thread blocked on entropy)."""
    def entropy(c):
        with span("entropy", stats):
            return entropy_fn(c)

    ex = ThreadPoolExecutor(max_workers=1)
    try:
        futs = [ex.submit(entropy, c) for c in chunks]
        for i, (sl_chunk, fut) in enumerate(zip(chunks, futs)):
            with span("entropy_wait", stats):
                syn = list(fut.result())
            step(i, syn, list(sl_chunk))
    finally:
        ex.shutdown(wait=True, cancel_futures=True)


def _run_one_device(sps, pps, chunks, entropy_fn, device, stats, sink):
    """run_chunks on one device: each chunk is packed, H2D + core are
    queued on the current stream and the device planes go to sink(i,
    planes). stats time host work only: entropy (worker wall),
    entropy_wait, pack, dispatch (h2d + launch + sink), h2d, launch."""

    def step(i, syn, sl):
        with span("pack", stats):
            bp = pack_batch(syn, sps, pps, sl)
        with span("dispatch", stats):
            sink(i, device_planes(bp, device, stats))

    run_chunks(chunks, entropy_fn, step, stats)


def decode_reconstruct_overlapped(
    sps, pps, slices, entropy_fn=None, chunk: int | None = None,
    readback: bool = True, stats=None, hints: dict | None = None,
    device="cuda",
) -> list:
    """Full tile decode with host entropy overlapped against the device.

    Entropy of chunk k+1 runs on a worker thread while chunk k is packed
    and queued on the device (run_chunks). chunk=None takes the stream
    hints' chunk (schedule_hints: 16, or 8 for fine spatial segments).

    readback=True: returns [Y, Cb, Cr] stacked numpy planes of all N
    tiles (uint8, or uint16 above 8 bits); each chunk's D2H runs on a
    side stream as soon as its planes are queued (Readback).
    readback=False (decode to device): returns one [y, cb, cr] list per
    chunk of contiguous device tensors in out_dtype (uint8, or int16
    above 8 bits), without waiting for the device. Chunks hold only
    real tiles: the last one may be shorter.

    stats: optional DecodeStats; records the scheduler hints, the
    h2d_copies and h2d_bytes counters, the native entropy pool's
    counters (default_entropy) and host stage times entropy,
    entropy_wait, pack, dispatch, h2d, launch and, with readback,
    readback (the drain).
    Overlapped stages sum to more than the wall by design.
    """
    device = resolve_device(device)
    if hints is None:
        hints = schedule_hints(None, sps, pps, len(slices))
    if stats is not None:
        stats.scheduler = hints
    if entropy_fn is None:
        entropy_fn = default_entropy(sps, pps, hints, stats)
    if chunk is None:
        chunk = hints.get("chunk", 16)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    chunks = [slices[lo : lo + chunk] for lo in range(0, len(slices), chunk)]
    if not readback:
        outs = []
        _run_one_device(sps, pps, chunks, entropy_fn, device, stats,
                        lambda i, planes: outs.append(planes))
        return outs
    rb = Readback()
    _run_one_device(sps, pps, chunks, entropy_fn, device, stats,
                    lambda i, planes: rb.submit(planes))
    with span("readback", stats):
        return stack_chunks(rb.drain())


def decode_burst(sps, pps, image_slice_lists, chunk: int | None = None,
                 hints: dict | None = None, stats=None, device="cuda"):
    """Pipelined multi-image decode to device: the chunks of all images
    (sharing sps / pps geometry) go through one entropy queue, so host
    entropy of image k+1 overlaps pack and device work of image k.

    Returns a list (per image) of lists (per chunk) of [y, cb, cr]
    device tensors in out_dtype, without waiting for the device
    (torch.cuda.synchronize to wait for the last image). Each image's
    chunks hold exactly its own tiles, in order. stats as in
    decode_reconstruct_overlapped (no readback stage).
    """
    device = resolve_device(device)
    if not image_slice_lists:
        return []
    if hints is None:
        hints = schedule_hints(None, sps, pps, len(image_slice_lists[0]))
    if stats is not None:
        stats.scheduler = hints
    if chunk is None:
        chunk = hints.get("chunk", 16)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    owner, chunks = [], []
    for ii, slices in enumerate(image_slice_lists):
        for lo in range(0, len(slices), chunk):
            owner.append(ii)
            chunks.append(list(slices[lo : lo + chunk]))
    outs = [[] for _ in image_slice_lists]
    _run_one_device(sps, pps, chunks,
                    default_entropy(sps, pps, hints, stats), device, stats,
                    lambda i, planes: outs[owner[i]].append(planes))
    return outs
