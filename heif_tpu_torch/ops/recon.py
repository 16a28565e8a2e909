"""Reconstruction stages in plain PyTorch: levels -> YCbCr planes.

Integer-exact port of heif_tpu/ops/jax_recon.py, batched over tiles:
where the JAX package vmaps a per-tile function, the functions here take
a leading tile axis N. Everything is int32 and right shifts are
arithmetic (spec >>), as in the reference.

- residual_class / scatter_classes: dequant + two exact float64 batched
  matmuls per (component, size) class, then a block row-scatter into
  [N, h+PAD, w+PAD] residual planes.
- ref_sources: the [..., 2, 65] uint8 reference-source table of every TU
  (availability + substitution), computed on the device.
- intra_scan_component: the plain intra walk, one Python step per TU
  index for all N tiles at once. It is the CPU path and the oracle the
  CUDA kernels (ops.intra) are held against.
- deblock_luma_pass / deblock_chroma_pass, sao_component.
"""

from __future__ import annotations

import torch

from heif_tpu_torch.tables import ReconTables

MAX_S = 32
REF_LEN = 2 * MAX_S + 1  # 65: corner + 2N samples per side at N = 32
N_REF = 2 * REF_LEN  # 130
PAD = MAX_S  # residual-plane padding on bottom/right
SPAD = 2 * MAX_S  # recon-plane padding (reference strips reach 2N ahead)
# recon planes carry a 1-sample top/left border (origin +1), so the
# reference strips at (y0-1, x0-1) never need clamping

I32 = torch.int32


def _clip16(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(-32768, 32767)


# ==========================================================================
# Stage 1: dequant + inverse transforms -> residual planes
# ==========================================================================


def residual_class(coeffs, qp, dst, skip, bypass, scaling, size: int,
                   bd: int, tables: ReconTables) -> torch.Tensor:
    """One (comp, size) class: [n, s, s] levels -> [n, s, s] int32 residual.

    coeffs may arrive int16. The two transform stages run as float64
    batched matmuls, which are exact here: each output is a sum of s <= 32
    products |d| <= 32768 times |T| <= 90, so |sum| <= 9.4e7 < 2^53
    (float32 is NOT exact: 9.4e7 > 2^24; CUDA has no int32 matmul).
    """
    coeffs = coeffs.to(I32)
    n = coeffs.shape[0]
    log2 = size.bit_length() - 1
    bd_shift = bd + log2 - 5
    qp = qp.to(I32)
    v = coeffs * scaling.to(I32)[None] * tables.level_scale[qp % 6][:, None, None]
    e = (qp // 6)[:, None, None]
    zero = torch.zeros_like(e)
    lo = torch.where(
        e < bd_shift,
        (v + (torch.ones_like(e) << torch.maximum(bd_shift - e - 1, zero)))
        >> torch.maximum(bd_shift - e, zero),
        v << torch.maximum(e - bd_shift, zero),
    )
    d = _clip16(lo)

    t = tables.dct(size)
    if size == 4:
        t = torch.where(dst.to(torch.bool)[:, None, None], tables.dst4[None],
                        t[None])
    else:
        t = t[None].expand(n, size, size)
    t64 = t.to(torch.float64)
    # stage 1: G = T^T @ D ; stage 2: R = G @ T (both exact in float64)
    g1 = torch.bmm(t64.transpose(1, 2), d.to(torch.float64)).to(I32)
    g1 = _clip16((g1 + 64) >> 7)
    r = torch.bmm(g1.to(torch.float64), t64).to(I32)
    r = _clip16((r + (1 << (19 - bd))) >> (20 - bd))
    r_skip = _clip16(((d << 7) + (1 << (19 - bd))) >> (20 - bd))
    r = torch.where(skip.to(torch.bool)[:, None, None], r_skip, r)
    return torch.where(bypass.to(torch.bool)[:, None, None], coeffs, r)


def scatter_classes(classes, n: int, dims, device, pad: int = PAD) -> list:
    """Place every class's residual blocks into per-tile planes.

    classes: iterable of (comp, size, r [k, s, s] int32, org [k] int32),
    where org is the flat origin tile * (h+pad)*(w+pad) + y*(w+pad) + x
    (negative for cap-padding rows). dims: [(h, w)] per component.
    TUs are size-aligned (HEVC quadtree), so each class maps onto a dense
    [n*gh*gw, s*s] slot grid: a row-scatter of whole blocks, then
    depth-to-space. Classes never overlap, so their planes add.
    Returns [N, h+pad, w+pad] int32 planes per component.
    """
    out = [torch.zeros((n, h + pad, w + pad), dtype=I32, device=device)
           for h, w in dims]
    for comp, size, r, org in classes:
        h, w = dims[comp]
        gh, gw = h // size, w // size
        stride = (h + pad) * (w + pad)
        org = org.to(torch.int64)
        ti = org // stride
        rem = org % stride
        oy = rem // (w + pad)
        ox = rem % (w + pad)
        slot = ti * (gh * gw) + (oy // size) * gw + (ox // size)
        # cap-padding rows (org < 0) land on a dummy trailing slot
        slot = torch.where(org < 0, n * gh * gw, slot)
        grid = torch.zeros((n * gh * gw + 1, size * size), dtype=I32,
                           device=device)
        grid[slot] = r.reshape(-1, size * size)
        plane = (
            grid[: n * gh * gw]
            .reshape(n, gh, gw, size, size)
            .permute(0, 1, 3, 2, 4)
            .reshape(n, h, w)
        )
        out[comp][:, :h, :w] += plane
    return out


# ==========================================================================
# Stage 2a: reference-source tables
# ==========================================================================


def z_addr(g4y: torch.Tensor, g4x: torch.Tensor, cl: int, ctbs_x: int):
    """Z-scan address of the 4x4 block at grid coords (g4y, g4x)."""
    ctb_idx = (g4y >> cl) * ctbs_x + (g4x >> cl)
    ix = g4x & ((1 << cl) - 1)
    iy = g4y & ((1 << cl) - 1)
    z = torch.zeros_like(g4x)
    for b in range(cl):
        z = z | (((ix >> b) & 1) << (2 * b))
        z = z | (((iy >> b) & 1) << (2 * b + 1))
    return (ctb_idx << (2 * cl)) + z


def ref_sources(x, y, size, *, comp: int, W: int, H: int, ctb_log2: int,
                tile_col_bd: tuple = (), tile_row_bd: tuple = ()):
    """Reference-source table for TUs at component coords (x, y), size
    (any matching shape [...]; size 0 marks padding steps).

    tile_col_bd / tile_row_bd: INTERIOR tile boundaries in luma pixels
    (§6.5.1); a neighbour across one is unavailable (§6.4.1).
    Returns uint8 [..., 2, REF_LEN]: per side (left, top) the index into
    the TU's local reference vector (left strip [65] ++ top strip [65]),
    255 = unavailable (substitute 1 << (bd - 1)).
    Port of jax_recon.ref_sources_device.
    """
    sub = 1 if comp == 0 else 2
    cl = ctb_log2 - 2
    ctbs_x = -(-(W >> 2) // (1 << cl))
    dev = x.device
    x = x.to(I32)
    y = y.to(I32)
    size = size.to(I32)
    s2 = (2 * size)[..., None]

    walk = torch.arange(4 * MAX_S + 1, dtype=I32, device=dev)  # [129]
    is_left = walk <= s2
    cx = torch.where(is_left, x[..., None] - 1, x[..., None] + (walk - s2 - 1))
    cy = torch.where(is_left, y[..., None] + (s2 - 1 - walk), y[..., None] - 1)
    lx = cx * sub
    ly = cy * sub
    inb = (lx >= 0) & (ly >= 0) & (lx < W) & (ly < H)
    z_cur = z_addr((y * sub) >> 2, (x * sub) >> 2, cl, ctbs_x)[..., None]
    zn = z_addr(ly.clamp(0, H - 1) >> 2, lx.clamp(0, W - 1) >> 2, cl, ctbs_x)
    avail = inb & (zn < z_cur) & (walk <= 2 * s2)
    if tile_col_bd or tile_row_bd:
        cur_lx = (x * sub)[..., None]
        cur_ly = (y * sub)[..., None]

        def _tidx(v, bounds):
            t = torch.zeros(v.shape, dtype=I32, device=dev)
            for b in bounds:
                t = t + (v >= b).to(I32)
            return t

        same = (_tidx(lx, tile_col_bd) == _tidx(cur_lx, tile_col_bd)) & (
            _tidx(ly, tile_row_bd) == _tidx(cur_ly, tile_row_bd)
        )
        avail = avail & same

    any_avail = avail.any(-1)
    # argmax of a bool is rejected by torch: take it over int32 (first max)
    first_avail = torch.argmax(avail.to(I32), dim=-1).to(I32)
    idx = torch.where(avail, walk, torch.full_like(walk, -1))
    idx = torch.where(
        walk == 0,
        torch.where(avail[..., :1], torch.zeros_like(first_avail)[..., None],
                    first_avail[..., None]),
        idx,
    )
    src_walk = torch.cummax(idx, dim=-1).values
    src_ok = any_avail[..., None] & (src_walk >= 0)
    local_of_walk = torch.where(
        src_walk <= s2, s2 - src_walk, src_walk - s2 + REF_LEN
    )
    local_of_walk = torch.where(src_ok, local_of_walk,
                                torch.full_like(local_of_walk, 255))

    # walk layout -> (left[65], top[65]) sides: corner = walk[2N],
    # left[1+i] = walk[2N-1-i], top[1+i] = walk[2N+1+i] for i < 2N
    n_tail = 2 * MAX_S
    i = torch.arange(n_tail, dtype=I32, device=dev)
    s2b = s2.expand(*s2.shape[:-1], n_tail)
    in_side = i < s2b
    li = torch.where(in_side, s2b - 1 - i, torch.zeros_like(s2b))
    ti = torch.where(in_side, s2b + 1 + i, torch.zeros_like(s2b))
    lw = local_of_walk.to(torch.int64)
    left_vals = torch.where(in_side, lw.gather(-1, li.to(torch.int64)).to(I32),
                            torch.full_like(li, 255))
    top_vals = torch.where(in_side, lw.gather(-1, ti.to(torch.int64)).to(I32),
                           torch.full_like(ti, 255))
    corner = local_of_walk.gather(-1, s2.to(torch.int64))
    valid = (size > 0)[..., None]
    left_side = torch.cat([corner, left_vals], dim=-1)
    top_side = torch.cat([corner, top_vals], dim=-1)
    left_side = torch.where(valid, left_side, torch.full_like(left_side, 255))
    top_side = torch.where(valid, top_side, torch.full_like(top_side, 255))
    return torch.stack([left_side, top_side], dim=-2).to(torch.uint8)


# ==========================================================================
# Stage 2: plain intra walk (the kernels' oracle)
# ==========================================================================


def _log2_of(size: torch.Tensor) -> torch.Tensor:
    return (
        (size == 4).to(I32) * 2 + (size == 8).to(I32) * 3
        + (size == 16).to(I32) * 4 + (size == 32).to(I32) * 5
    )


def filter_refs(left, top, size, filt, strong_smoothing: bool, bd: int):
    """§8.4.4.2.3 reference smoothing ([1 2 1] or bilinear), [N, 65] sides.

    Port of jax_recon._filter_refs, batched over the leading axis."""
    idx = torch.arange(REF_LEN, dtype=I32, device=left.device)[None]
    n2 = (2 * size)[:, None]
    corner = left[:, :1]
    thr = 1 << (bd - 5)
    bi = (
        (size == 32)
        & ((corner[:, 0] + top[:, 64] - 2 * top[:, 32]).abs() < thr)
        & ((corner[:, 0] + left[:, 64] - 2 * left[:, 32]).abs() < thr)
    )[:, None] & bool(strong_smoothing)

    def smooth121(a):
        am1 = torch.cat([a[:, :1], a[:, :-1]], dim=1)
        ap1 = torch.cat([a[:, 1:], a[:, -1:]], dim=1)
        return (am1 + 2 * a + ap1 + 2) >> 2

    corner_f = (left[:, 1:2] + 2 * corner + top[:, 1:2] + 2) >> 2
    lf = torch.where(idx == 0, corner_f, smooth121(left))
    tf = torch.where(idx == 0, corner_f, smooth121(top))
    lf = torch.where(idx >= n2, left, lf)  # last sample unfiltered
    tf = torch.where(idx >= n2, top, tf)

    mid = (idx >= 1) & (idx <= 63)
    tb = torch.where(mid, ((64 - idx) * corner + idx * top[:, 64:65] + 32) >> 6, top)
    lb = torch.where(mid, ((64 - idx) * corner + idx * left[:, 64:65] + 32) >> 6, left)
    tb = torch.where(idx == 0, corner, tb)
    lb = torch.where(idx == 0, corner, lb)

    use = (filt != 0)[:, None]
    return (
        torch.where(use, torch.where(bi, lb, lf), left),
        torch.where(use, torch.where(bi, tb, tf), top),
    )


def predict_block(left, top, size, mode, is_luma: bool, bd: int,
                  tables: ReconTables) -> torch.Tensor:
    """Intra prediction (§8.4.4.2.4-6) of [N] blocks at padded 32x32.

    left/top: [N, 65] int32 (index 0 = corner). Direct spec formulas:
    planar, DC (with luma boundary smoothing), angular with iIdx/iFact
    over the main reference and the inverse-angle side extension, plus
    the luma mode 10/26 edge compensation. Samples outside the TU are
    don't-care (the caller masks by size). Returns [N, 32, 32] int32.
    """
    dev = left.device
    n = left.shape[0]
    s = size[:, None, None]
    log2 = _log2_of(size)[:, None, None]
    r32 = torch.arange(MAX_S, dtype=I32, device=dev)
    yy = r32[None, :, None]
    xx = r32[None, None, :]
    lcol = left[:, 1 : MAX_S + 1]  # p[-1][y]
    trow = top[:, 1 : MAX_S + 1]  # p[x][-1]
    sp1 = (size + 1).clamp(max=REF_LEN - 1).to(torch.int64)[:, None]

    # planar
    top_n = top.gather(1, sp1)[:, :, None]  # p[nTbS][-1]
    left_n = left.gather(1, sp1)[:, :, None]  # p[-1][nTbS]
    planar = (
        (s - 1 - xx) * lcol[:, :, None] + (xx + 1) * top_n
        + (s - 1 - yy) * trow[:, None, :] + (yy + 1) * left_n + s
    ) >> (log2 + 1)

    # DC
    i65 = torch.arange(REF_LEN, dtype=I32, device=dev)[None]
    msk = (i65 >= 1) & (i65 <= size[:, None])
    dc = ((torch.where(msk, left + top, 0).sum(1).to(I32) + size)
          >> (_log2_of(size) + 1))[:, None, None]

    # angular: d = distance to the main edge (row for vertical modes,
    # column for horizontal), p = position along it
    angle = torch.cat([torch.zeros(2, dtype=I32, device=dev),
                       tables.intra_pred_angle])[mode]  # [N]
    vertical = (mode >= 18)[:, None]
    main = torch.where(vertical, top, left)
    side = torch.where(vertical, left, top)
    # ref_full[32 + k] = ref[k]: k >= 0 from main, k < 0 from the side
    # through the inverse-angle index (ref[-1-j] = side[inv_idx[mode, j]])
    inv = tables.inv_idx[mode].flip(1).to(torch.int64)  # [N, 32], k = -32..-1
    ref_full = torch.cat([side.gather(1, inv), main], dim=1)  # [N, 97]
    pos = (r32[None, :] + 1) * angle[:, None]  # [N, 32 (d)]
    iidx = (pos >> 5)[:, :, None]
    ifact = (pos & 31)[:, :, None]
    k1 = (xx + iidx + 1 + MAX_S).clamp(0, 3 * MAX_S).to(torch.int64)  # [N,d,p]
    k2 = (k1 + 1).clamp(max=3 * MAX_S)
    flat1 = ref_full.gather(1, k1.reshape(n, -1)).reshape(n, MAX_S, MAX_S)
    flat2 = ref_full.gather(1, k2.reshape(n, -1)).reshape(n, MAX_S, MAX_S)
    ang = ((32 - ifact) * flat1 + ifact * flat2 + 16) >> 5  # [N, d, p]
    ang = torch.where(vertical[:, :, None], ang, ang.transpose(1, 2))

    m = mode[:, None, None]
    pred = torch.where(m == 0, planar, torch.where(m == 1, dc, ang))

    if is_luma:
        small = s < 32
        dc_smooth = small & (m == 1)
        top_row = (trow[:, None, :] + 3 * dc + 2) >> 2
        left_col = (lcol[:, :, None] + 3 * dc + 2) >> 2
        corner_v = (left[:, 1, None, None] + 2 * dc + top[:, 1, None, None] + 2) >> 2
        pred = torch.where(dc_smooth & (yy == 0), top_row, pred)
        pred = torch.where(dc_smooth & (xx == 0) & (yy > 0), left_col, pred)
        pred = torch.where(dc_smooth & (yy == 0) & (xx == 0), corner_v, pred)
        mxv = (1 << bd) - 1
        delta_v = (top[:, 1:2] + ((lcol - left[:, :1]) >> 1)).clamp(0, mxv)
        delta_h = (left[:, 1:2] + ((trow - top[:, :1]) >> 1)).clamp(0, mxv)
        pred = torch.where(small & (m == 26) & (xx == 0), delta_v[:, :, None], pred)
        pred = torch.where(small & (m == 10) & (yy == 0), delta_h[:, None, :], pred)
    return pred


def intra_scan_component(plane, res, pcm, steps, src, counts, *,
                         is_luma: bool, strong_smoothing: bool, bd: int,
                         tables: ReconTables) -> torch.Tensor:
    """Plain intra walk over the TU worklists of N tiles, in place.

    plane: [N, 1+h+SPAD, 1+w+SPAD] int32 (sample (r, c) at [r+1, c+1]),
    updated in place and returned. res / pcm: [N, h+PAD, w+PAD] int32
    (pcm may be None: PCM steps then take 0, as the zero PCM plane of the
    reference does). steps: [N, S, 6] int32 (x, y, size, mode, filter,
    pcm); src: [N, S, 2, 65] uint8 from ref_sources; counts: [N] real TU
    counts. Step k reconstructs the k-th TU of every tile at once (the
    reference vmaps a lax.scan over tiles: jax_recon.intra_scan_component).
    """
    n, hp, wp = plane.shape
    wr = res.shape[2]
    dev = plane.device
    mxv = (1 << bd) - 1
    pflat = plane.view(n, hp * wp)
    rflat = res.reshape(n, -1)
    cflat = None if pcm is None else pcm.reshape(n, -1)
    r65 = torch.arange(REF_LEN, dtype=torch.int64, device=dev)[None]
    r32 = torch.arange(MAX_S, dtype=torch.int64, device=dev)
    blk_p = r32[:, None] * wp + r32[None, :]  # [32, 32] plane offsets
    blk_r = r32[:, None] * wr + r32[None, :]
    steps = steps.to(torch.int64)
    src = src.reshape(n, src.shape[1], N_REF).to(torch.int64)
    n_steps = int(counts.max()) if n else 0
    for k in range(n_steps):
        tx, ty, size, mode, filt, is_pcm = steps[:, k].unbind(1)
        base = ty * wp + tx  # plane index of abs (ty-1, tx-1)
        left = pflat.gather(1, base[:, None] + r65 * wp)
        top = pflat.gather(1, base[:, None] + r65)
        local = torch.cat([left, top], dim=1)  # [N, 130]
        sk = src[:, k]
        refs = torch.where(sk >= N_REF, 1 << (bd - 1),
                           local.gather(1, sk.clamp(max=N_REF - 1)))
        lref, tref = refs[:, :REF_LEN], refs[:, REF_LEN:]
        size32 = size.to(I32)
        if is_luma:
            lref, tref = filter_refs(lref, tref, size32, filt,
                                     strong_smoothing, bd)
        pred = predict_block(lref, tref, size32, mode, is_luma, bd, tables)
        ridx = (ty * wr + tx)[:, None, None] + blk_r
        new = (pred + rflat.gather(1, ridx.reshape(n, -1)).reshape(n, MAX_S, MAX_S))
        new = new.clamp(0, mxv)
        pcm_v = (torch.zeros_like(new) if cflat is None else
                 cflat.gather(1, ridx.reshape(n, -1)).reshape(n, MAX_S, MAX_S))
        new = torch.where((is_pcm != 0)[:, None, None], pcm_v, new)
        pidx = (base + wp + 1)[:, None, None] + blk_p
        pidx = pidx.reshape(n, -1)
        cur = pflat.gather(1, pidx).reshape(n, MAX_S, MAX_S)
        inside = (r32[None, :, None] < size[:, None, None]) & (
            r32[None, None, :] < size[:, None, None])
        pflat.scatter_(1, pidx, torch.where(inside, new, cur).reshape(n, -1))
    return plane


# ==========================================================================
# Stage 3: deblocking
# ==========================================================================


def deblock_luma_pass(plane, edge_present, qp_p, qp_q, nf_p, nf_q,
                      beta_off: int, tc_off: int, bd: int,
                      tables: ReconTables) -> torch.Tensor:
    """One direction of luma deblocking over [N, h, w] planes (w % 8 == 0):
    filters the w//8 - 1 internal vertical edges. edge_present / qp / nf:
    [N, h//4, w//8-1] per (segment, edge). Port of
    jax_recon._deblock_luma_pass with the batch axis in front."""
    n, h, w = plane.shape
    ne = w // 8 - 1
    seg = plane[:, :, 4 : 4 + ne * 8].reshape(n, h // 4, 4, ne, 8).permute(0, 1, 3, 2, 4)
    p3, p2, p1, p0 = seg[..., 0], seg[..., 1], seg[..., 2], seg[..., 3]
    q0, q1, q2, q3 = seg[..., 4], seg[..., 5], seg[..., 6], seg[..., 7]

    qp_avg = (qp_p + qp_q + 1) >> 1
    beta = tables.beta[(qp_avg + beta_off).clamp(0, 51).long()] << (bd - 8)
    tc = tables.tc[(qp_avg + 2 + tc_off).clamp(0, 53).long()] << (bd - 8)

    def dd(i):
        dp = (p2[..., i] - 2 * p1[..., i] + p0[..., i]).abs()
        dq = (q2[..., i] - 2 * q1[..., i] + q0[..., i]).abs()
        return dp, dq

    dp0, dq0 = dd(0)
    dp3, dq3 = dd(3)
    d = dp0 + dq0 + dp3 + dq3
    filt = edge_present & (d < beta) & ((beta > 0) | (tc > 0))

    def strong_line(i, dpq):
        return (
            (2 * dpq < (beta >> 2))
            & ((p3[..., i] - p0[..., i]).abs() + (q0[..., i] - q3[..., i]).abs()
               < (beta >> 3))
            & ((p0[..., i] - q0[..., i]).abs() < ((5 * tc + 1) >> 1))
        )

    strong = strong_line(0, dp0 + dq0) & strong_line(3, dp3 + dq3)
    dep = (dp0 + dp3) < ((beta + (beta >> 1)) >> 3)
    deq = (dq0 + dq3) < ((beta + (beta >> 1)) >> 3)

    tcb = tc[..., None]
    tc2 = 2 * tcb

    def clip3(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    sp0 = clip3((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0 - tc2, p0 + tc2)
    sp1 = clip3((p2 + p1 + p0 + q0 + 2) >> 2, p1 - tc2, p1 + tc2)
    sp2 = clip3((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2 - tc2, p2 + tc2)
    sq0 = clip3((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3, q0 - tc2, q0 + tc2)
    sq1 = clip3((q2 + q1 + q0 + p0 + 2) >> 2, q1 - tc2, q1 + tc2)
    sq2 = clip3((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2 - tc2, q2 + tc2)
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wmask = delta.abs() < tcb * 10
    dl = clip3(delta, -tcb, tcb)
    mxv = (1 << bd) - 1
    wp0 = torch.where(wmask, (p0 + dl).clamp(0, mxv), p0)
    wq0 = torch.where(wmask, (q0 - dl).clamp(0, mxv), q0)
    tch = (tc >> 1)[..., None]
    dpv = clip3((((p2 + p0 + 1) >> 1) - p1 + dl) >> 1, -tch, tch)
    wp1 = torch.where(wmask & dep[..., None], (p1 + dpv).clamp(0, mxv), p1)
    dqv = clip3((((q2 + q0 + 1) >> 1) - q1 - dl) >> 1, -tch, tch)
    wq1 = torch.where(wmask & deq[..., None], (q1 + dqv).clamp(0, mxv), q1)

    sm = strong[..., None]
    fm = filt[..., None]
    fp = fm & ~nf_p[..., None]
    fq = fm & ~nf_q[..., None]
    np0 = torch.where(fp, torch.where(sm, sp0, wp0), p0)
    np1 = torch.where(fp & sm, sp1, torch.where(fp & ~sm, wp1, p1))
    np2 = torch.where(fp & sm, sp2, p2)
    nq0 = torch.where(fq, torch.where(sm, sq0, wq0), q0)
    nq1 = torch.where(fq & sm, sq1, torch.where(fq & ~sm, wq1, q1))
    nq2 = torch.where(fq & sm, sq2, q2)

    out = torch.stack([p3, np2, np1, np0, nq0, nq1, nq2, q3], dim=-1)
    out = out.permute(0, 1, 3, 2, 4).reshape(n, h, ne * 8)
    plane = plane.clone()
    plane[:, :, 4 : 4 + ne * 8] = out
    return plane


def deblock_chroma_pass(plane, edge_present, qpc, nf_p, nf_q, tc_off: int,
                        bd: int, tables: ReconTables) -> torch.Tensor:
    """One direction of chroma deblocking in 2-line units over [N, hc, wc]
    planes; edges every 8 chroma columns. edge_present / qpc / nf:
    [N, hc//2, wc//8-1]. Port of jax_recon._deblock_chroma_pass."""
    n, h, w = plane.shape
    ne = w // 8 - 1
    seg = plane[:, :, 6 : 6 + ne * 8].reshape(n, h // 2, 2, ne, 8).permute(0, 1, 3, 2, 4)
    p1, p0, q0, q1 = seg[..., 0], seg[..., 1], seg[..., 2], seg[..., 3]
    tc = tables.tc[(qpc + 2 + tc_off).clamp(0, 53).long()] << (bd - 8)
    mxv = (1 << bd) - 1
    tcb = tc[..., None]
    delta = torch.minimum(torch.maximum((((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tcb), tcb)
    fm = (edge_present & (tc > 0))[..., None]
    np0 = torch.where(fm & ~nf_p[..., None], (p0 + delta).clamp(0, mxv), p0)
    nq0 = torch.where(fm & ~nf_q[..., None], (q0 - delta).clamp(0, mxv), q0)
    out = torch.stack(
        [p1, np0, nq0, q1, seg[..., 4], seg[..., 5], seg[..., 6], seg[..., 7]],
        dim=-1,
    )
    out = out.permute(0, 1, 3, 2, 4).reshape(n, h, ne * 8)
    plane = plane.clone()
    plane[:, :, 6 : 6 + ne * 8] = out
    return plane


# ==========================================================================
# Stage 4: SAO
# ==========================================================================

_EO = (((-1, 0), (1, 0)), ((0, -1), (0, 1)), ((-1, -1), (1, 1)), ((1, -1), (-1, 1)))


def sao_component(plane, sao_type, sao_class, offs, nf_pix, bd: int):
    """SAO over [N, h, w] planes with per-pixel parameters (already
    upsampled per CTB): sao_type / sao_class [N, h, w], offs [N, h, w, 4],
    nf_pix [N, h, w] bool (bypass: sample untouched). Port of
    jax_recon.sao_component."""
    n, h, w = plane.shape
    dev = plane.device
    offs = offs * (1 << (bd - min(bd, 10)))  # SaoOffsetVal scale
    band = plane >> (bd - 5)
    bdelta = torch.zeros_like(plane)
    for i in range(4):
        bdelta = bdelta + torch.where(band == ((sao_class + i) & 31), offs[..., i], 0)
    # edge-replicated neighbours by clamped indices
    ry = torch.arange(-1, h + 1, device=dev).clamp(0, h - 1)
    rx = torch.arange(-1, w + 1, device=dev).clamp(0, w - 1)
    padded = plane[:, ry][:, :, rx]
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    edelta = torch.zeros_like(plane)
    for cls, ((dx0, dy0), (dx1, dy1)) in enumerate(_EO):
        n0 = padded[:, 1 + dy0 : 1 + h + dy0, 1 + dx0 : 1 + w + dx0]
        n1 = padded[:, 1 + dy1 : 1 + h + dy1, 1 + dx1 : 1 + w + dx1]
        sgn = torch.sign(plane - n0) + torch.sign(plane - n1)
        dlt = (
            torch.where(sgn == -2, offs[..., 0], 0)
            + torch.where(sgn == -1, offs[..., 1], 0)
            + torch.where(sgn == 1, offs[..., 2], 0)
            + torch.where(sgn == 2, offs[..., 3], 0)
        )
        valid = (
            (xx + dx0 >= 0) & (xx + dx0 < w) & (yy + dy0 >= 0) & (yy + dy0 < h)
            & (xx + dx1 >= 0) & (xx + dx1 < w) & (yy + dy1 >= 0) & (yy + dy1 < h)
        )
        dlt = torch.where(valid, dlt, 0)
        edelta = torch.where(sao_class == cls, dlt, edelta)
    mxv = (1 << bd) - 1
    res = torch.where(
        sao_type == 1,
        (plane + bdelta).clamp(0, mxv),
        torch.where(sao_type == 2, (plane + edelta).clamp(0, mxv), plane),
    )
    return torch.where(nf_pix, plane, res)
