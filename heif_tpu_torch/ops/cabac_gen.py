"""CABAC engine with the device-side residual request generator: host
packers, the plain PyTorch generator and the CUDA kernel wrapper.

Port of heif_tpu/ops/pallas_cabac_gen.py. That module imports JAX at
module level, so this one carries its own copy of the numpy half
(`pack_gen_batch`, `scatter_events`, `pack_gen_batches`);
tests/test_torch_cabac_gen.py holds the copy against the original.

Each lane consumes an ENVELOPE tape (cabac/envelope.py): the non-residual
bins plus one KIND_TU marker per transform block. At a marker the lane
enters a 13-phase residual_coding() state machine (last_sig prefix and
suffix, coded_sub_block_flag, sig_coeff_flag, greater1, greater2, signs
with sign hiding, coeff_abs_level_remaining with Rice adaptation, and a
flush that emits one coefficient per step) that derives every request
itself. One bin or one flush per lane per step; the outputs are dense
[steps, 128] planes:

- events: a coefficient is bit 31 | n<<26 | subblock<<20 | level & 0xFFFFF,
  a TU start is bit 30 | the low 8 bits of the TU sequence number;
- dbg: request kind | slot<<3 | bin<<12 | phase<<16 (on request).

`gen` takes words [B, W, 128], tape [B, S_env, 128], c0 [B, 136, 128]
and a step count S, and returns events [B, S, 128], dbg [B, S, 128] or
None, and the final context state [B, 136, 128]. On a CUDA tensor it
launches csrc/cabac_gen.cu and raises if the launch fails; on a CPU
tensor it runs `gen_plain`, a lane-vectorised transcription of the
Pallas step (every phase computed, the phase selects) that is also the
kernel's oracle on the card. LAUNCHES counts kernel launches only.
"""

from __future__ import annotations

import numpy as np
import torch

from heif_tpu_torch.cabac import engine as E
from heif_tpu_torch.cabac.envelope import KIND_TU
from heif_tpu_torch.cabac.trace import KIND_BYPASS, KIND_CTX, KIND_PAD
from heif_tpu_torch.device import resolve_device
from heif_tpu_torch.hevc.scans import scan_order
from heif_tpu_torch.ops.cabac import (
    LANES,
    N_CTX,
    Engine,
    _be_words,
    _ctx0,
    _n_words,
    as_tensor,
    check,
    ctx_read,
    cuda_ms,
    fetch,
    from_lanes,
    raise_on,
    shl,
    srl,
    stack_batches,
    stream_bytes,
    table_row,
    to_lanes,
)
from heif_tpu_torch.tables import cabac_tables_on

# ctx slot bases (dense layout of cabac.engine)
_B_LASTX = E.CTX_OFFSET["last_x"]
_B_LASTY = E.CTX_OFFSET["last_y"]
_B_CSBF = E.CTX_OFFSET["csbf"]
_B_SIG = E.CTX_OFFSET["sig"]
_B_G1 = E.CTX_OFFSET["g1"]
_B_G2 = E.CTX_OFFSET["g2"]

# phases
P_TAPE, P_LXP, P_LYP, P_LXS, P_LYS, P_CSBF, P_SIG, P_G1, P_G2, \
    P_SIGN, P_REMP, P_REMS, P_FLUSH = range(13)

# lane registers (as in the Pallas kernel's register file)
# 0..5 engine: rng off wi biw cur nxt
# 6 tptr  7 phase  8 desc  9 cnt  10 acc  11 lastx  12 lasty
# 13 sbi  14 lastsb  15 csl  16 csh  17 sbxy  18 posn  19 sig
# 20 infer  21 lastpos  22 ctxset  23 g1ctx  24 ng1  25 lastg1
# 26 prevg1  27 g2  28 g1bits  29 g1cov  30 signbits  31 hidden
# 32 firstsig  33 rice  34 sumabs  35 rembase  36 remmask
# 37 rempfx  38 tuseq
NREG = 39

LAUNCHES = {"gen": 0}


def reset_launches() -> None:
    LAUNCHES["gen"] = 0


# --------------------------------------------------------------------------
# host half: numpy copies of heif_tpu.ops.pallas_cabac_gen's packers
# --------------------------------------------------------------------------


def pack_gen_batch(entries):
    """Pack up to 128 (rbsp, TraceSegment, env_tape, n_steps) lane tuples.

    Returns dict with words/tape/c0 arrays plus S_env/S_steps/W.
    """
    n = len(entries)
    if n > LANES:
        raise ValueError(f"{n} streams > {LANES} lanes")
    W = _n_words(max(s.byte_end - s.byte_start for _, s, _, _ in entries))
    by = np.zeros((W * 4, LANES), np.uint8)
    S_env = max(t.size for _, _, t, _ in entries) + 1
    S_env = -(-S_env // 8) * 8
    S_steps = max(ns for _, _, _, ns in entries)
    tape = np.full((S_env, LANES), KIND_PAD, np.int32)
    c0 = np.zeros((N_CTX, LANES), np.int32)
    for i, (rbsp, s, t, _) in enumerate(entries):
        chunk = np.frombuffer(rbsp[s.byte_start : s.byte_end], np.uint8)
        by[: chunk.size, i] = chunk
        tape[: t.size, i] = t
        c0[:, i] = _ctx0(s)
    return {
        "words": _be_words(by), "tape": tape, "c0": c0,
        "W": W, "S_env": S_env, "S_steps": S_steps,
    }


def pack_gen_batches(entries):
    """Sort (rbsp, seg, tape, n_steps, spans) tuples into 128-lane
    batches by step count (keeps each batch's lockstep padding low).
    Returns a list of (lane_entries, entry_idx) pairs."""
    order = sorted(range(len(entries)), key=lambda i: entries[i][3])
    return [
        ([entries[i] for i in order[lo : lo + LANES]],
         order[lo : lo + LANES])
        for lo in range(0, len(order), LANES)
    ]


def envelope_entries(sps, pps, ps):
    """The host envelope trace of one parsed slice, as generator input.

    Returns (entries, syntax): one (rbsp, TraceSegment, envelope_tape,
    n_steps, spans) tuple per substream, its spans in decode order, and
    the host decoder's SyntaxTensors (whose coeffs are the golden
    coefficient planes)."""
    from heif_tpu_torch.cabac.envelope import build_envelope_tape, envelope_trace

    tr = envelope_trace(sps, pps, ps)
    rbsp = bytes(ps.rbsp)
    entries = []
    for si, seg in enumerate(tr.segments):
        tape, n_steps = build_envelope_tape(tr, si)
        spans = sorted((sp for sp in tr.spans if sp.seg == si),
                       key=lambda sp: sp.b0)
        entries.append((rbsp, seg, tape, n_steps, spans))
    return entries, tr.syntax


_SCANS = {}


def _scan_xy(side: int, scan: int) -> np.ndarray:
    """scan_order(side, scan) as an int64 [side*side, 2] array (cached)."""
    key = (side, scan)
    if key not in _SCANS:
        _SCANS[key] = np.asarray(scan_order(side, scan), np.int64)
    return _SCANS[key]


def scatter_events(events_lane: np.ndarray, spans: list, planes: list):
    """Scatter one lane's event stream into coefficient planes.

    events_lane: [S] int32 event words; spans: this segment's
    ResidualSpans in decode order; planes: [y, cb, cr] int32 arrays
    (mutated). Pure bookkeeping, vectorised over the events; raises
    ValueError where heif_tpu's loop asserts (TU sequence desync, TU
    count)."""
    ev = np.asarray(events_lane, np.int64) & 0xFFFFFFFF
    ev = ev[ev != 0]
    is_coef = (ev >> 31) & 1 == 1
    is_tu = ~is_coef & ((ev >> 30) & 1 == 1)
    tu_idx = np.cumsum(is_tu) - 1  # TU each event belongs to
    n_tu = int(is_tu.sum())
    if n_tu != len(spans):
        raise ValueError(f"saw {n_tu} TUs, expected {len(spans)}")
    seq = np.arange(n_tu)
    if np.any((ev[is_tu] & 0xFF) != (seq & 0xFF)):
        raise ValueError("TU sequence desync")
    w = ev[is_coef]
    owner = tu_idx[is_coef]
    if np.any(owner < 0):
        raise ValueError("coefficient event before the first TU start")
    n = (w >> 26) & 15
    sbi = (w >> 20) & 63
    val = w & 0xFFFFF
    val = np.where(val & (1 << 19), val - (1 << 20), val)
    for ti in np.unique(owner):
        sp = spans[ti]
        m = owner == ti
        sb = _scan_xy((1 << sp.log2) >> 2, sp.scan_idx)
        co = _scan_xy(4, sp.scan_idx)
        s_i, n_i = sbi[m], n[m]
        if np.any(s_i >= sb.shape[0]):
            raise ValueError(f"TU {ti}: subblock index out of range")
        y = sp.y0 + (sb[s_i, 1] << 2) + co[n_i, 1]
        x = sp.x0 + (sb[s_i, 0] << 2) + co[n_i, 0]
        planes[sp.c_idx][y, x] = val[m]


# --------------------------------------------------------------------------
# plain generator: lane-vectorised transcription of the Pallas step
# --------------------------------------------------------------------------


def _i32(cond: torch.Tensor) -> torch.Tensor:
    return cond.to(torch.int32)


def _wh(cond, a, b) -> torch.Tensor:
    """torch.where kept in int32 (two scalar branches give int64)."""
    return torch.where(cond, a, b).to(torch.int32)


def _msb16(x: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of x (16-bit values); -1 when x <= 0.

    The Pallas kernel's 4-step binary search gives min(msb(x), 15) for
    any x > 0; so does frexp of x clamped to 16 bits (exact in float32)."""
    e = torch.frexp(x.clamp(1, 0xFFFF).to(torch.float32)).exponent
    return torch.where(x > 0, e - 1, -1)


def _popcount16(x: torch.Tensor) -> torch.Tensor:
    x = x - (srl(x, 1) & 0x5555)
    x = (x & 0x3333) + (srl(x, 2) & 0x3333)
    x = (x + srl(x, 4)) & 0x0F0F
    return (x + srl(x, 8)) & 0x1F


def _lut(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tab[idx], 0 outside the table."""
    n = tab.shape[0]
    v = tab[idx.clamp(0, n - 1).to(torch.int64)]
    return torch.where((idx >= 0) & (idx < n), v, 0)


def gen_plain(words, tape, c0, n_steps: int, debug: bool = False,
              tables=None):
    """Plain PyTorch generator on any device; same contract as `gen`."""
    B = words.shape[0]
    T = tables or cabac_tables_on(words.device)
    w, tp, ctx = to_lanes(words), to_lanes(tape), to_lanes(c0).clone()
    L = w.shape[1]
    s_env = tp.shape[0]
    lane = torch.arange(L, device=w.device)
    zero = torch.zeros(L, dtype=torch.int32, device=w.device)
    one = zero + 1
    sig4_lo, sig4_hi = zero + T.sig4[0], zero + T.sig4[1]
    eng = Engine(w, zero)
    r = [zero] * NREG
    levels = torch.zeros((16, L), dtype=torch.int32, device=w.device)
    events = torch.empty((n_steps, L), dtype=torch.int32, device=w.device)
    dbgs = torch.empty_like(events) if debug else None

    for t in range(n_steps):
        phase, desc = r[7], r[8]
        cidx = desc & 3
        log2m2 = srl(desc, 2) & 3
        scan = srl(desc, 4) & 3
        shide = srl(desc, 6) & 1
        sb_side = one << log2m2
        sb_base = scan * 256 + log2m2 * 64
        xs = r[17] & 255
        ys = srl(r[17], 8) & 255
        sb_raster = ys * sb_side + xs

        def csbf_bit(idx, valid):
            wd = torch.where(idx >= 32, r[16], r[15])
            return torch.where(valid, srl(wd, idx & 31) & 1, 0)

        cs_right = csbf_bit(sb_raster + 1, xs + 1 < sb_side)
        cs_below = csbf_bit(sb_raster + sb_side, ys + 1 < sb_side)

        # ---------- request resolution ----------
        entry = fetch(tp, r[6])
        e_kind = entry & 7
        e_pay = srl(entry, 3)
        is_tu = e_kind == KIND_TU
        in_tape = phase == P_TAPE
        tu_now = in_tape & is_tu
        desc_n = torch.where(tu_now, e_pay & 127, desc)
        cidx_n = desc_n & 3
        log2m2_n = srl(desc_n, 2) & 3
        phase_rq = torch.where(tu_now, P_LXP, phase)
        cnt_rq = torch.where(tu_now, 0, r[9])

        ctx_off = torch.where(cidx_n == 0,
                              3 * log2m2_n + srl(log2m2_n + 1, 2), 15)
        ctx_shift = torch.where(cidx_n == 0, srl(log2m2_n + 3, 2), log2m2_n)
        lx_slot = _B_LASTX + ctx_off + srl(cnt_rq, ctx_shift)
        ly_slot = _B_LASTY + ctx_off + srl(cnt_rq, ctx_shift)

        n_cur = r[18].clamp(min=0)
        xy = _lut(T.co_fwd, scan * 16 + n_cur)
        xp = xy & 255
        yp = srl(xy, 8) & 255
        xc = (xs << 2) + xp
        yc = (ys << 2) + yp
        s4i = (yp << 2) + xp
        sig4 = torch.where(s4i < 8, srl(sig4_lo, 4 * s4i) & 15,
                           srl(sig4_hi, 4 * (s4i - 8)) & 15)
        prev_csbf = cs_right + 2 * cs_below
        sums = xp + yp
        s0 = torch.where(sums == 0, 2, _i32(sums < 3))
        s1 = torch.where(yp == 0, 2, _i32(yp == 1))
        s2 = torch.where(xp == 0, 2, _i32(xp == 1))
        sig_ctx = torch.where(prev_csbf == 0, s0, torch.where(
            prev_csbf == 1, s1, torch.where(prev_csbf == 2, s2, 2)))
        add_l = torch.where(
            cidx == 0,
            _wh(xs + ys > 0, 3, 0) + torch.where(
                log2m2 == 1, _wh(scan == 0, 9, 15), 21),
            _wh(log2m2 == 1, 9, 12))
        sig_ctx = sig_ctx + add_l
        sig_ctx = torch.where(log2m2 == 0, sig4, sig_ctx)
        sig_ctx = torch.where((xc + yc == 0) & (log2m2 > 0), 0, sig_ctx)
        sig_slot = _B_SIG + sig_ctx + _wh(cidx > 0, 27, 0)
        csbf_slot = (_B_CSBF + (cs_right + cs_below).clamp(max=1)
                     + _wh(cidx > 0, 2, 0))
        g1_slot = (_B_G1 + r[22] * 4 + r[23].clamp(max=3)
                   + _wh(cidx > 0, 16, 0))
        g2_slot = _B_G2 + r[22] + _wh(cidx > 0, 4, 0)

        kind = zero + KIND_PAD
        slot = zero
        for ph, kk, ss in (
            (P_LXP, KIND_CTX, lx_slot), (P_LYP, KIND_CTX, ly_slot),
            (P_LXS, KIND_BYPASS, 0), (P_LYS, KIND_BYPASS, 0),
            (P_CSBF, KIND_CTX, csbf_slot), (P_SIG, KIND_CTX, sig_slot),
            (P_G1, KIND_CTX, g1_slot), (P_G2, KIND_CTX, g2_slot),
            (P_SIGN, KIND_BYPASS, 0), (P_REMP, KIND_BYPASS, 0),
            (P_REMS, KIND_BYPASS, 0),
        ):
            c = phase_rq == ph
            kind = torch.where(c, kk, kind)
            slot = torch.where(c, ss, slot)
        tape_bin = in_tape & ~is_tu
        kind = torch.where(tape_bin, e_kind, kind)
        slot = torch.where(tape_bin, e_pay, slot)
        # P_FLUSH and exhausted-tape lanes keep KIND_PAD

        c, row, ok = ctx_read(ctx, slot, lane)
        b, c_new, is_ctx = eng.decode(w, kind, c, *table_row(T.tbl, c, eng.rng))
        ctx[row, lane] = torch.where(is_ctx & ok, c_new, ctx[row, lane])

        # ---------- state update ----------
        nr = list(r)
        adv = in_tape & (e_kind != KIND_PAD)
        nr[6] = (r[6] + _i32(adv)).clamp(max=s_env - 1)
        nr[8] = desc_n
        phase_u = phase_rq
        cnt = cnt_rq
        ev = torch.where(tu_now, (1 << 30) | (r[38] & 0xFF), 0)
        nr[38] = r[38] + _i32(tu_now)

        # last_sig phases (x-prefix, y-prefix, x-suffix, y-suffix)
        cmax = ((log2m2_n + 2) << 1) - 1
        in_lxp = phase_u == P_LXP
        in_lyp = phase_u == P_LYP
        in_lpre = in_lxp | in_lyp
        pre_more = (b > 0) & (cnt + 1 < cmax)
        prefix = torch.where(b > 0, cnt + 1, cnt)
        pre_done = in_lpre & ~pre_more
        in_lxs = phase_u == P_LXS
        in_lys = phase_u == P_LYS
        acc2 = (r[10] << 1) | b
        suf_done = (in_lxs | in_lys) & (r[9] == 1)
        pfx_store = r[11] * _i32(in_lxs) + r[12] * _i32(in_lys)
        suf_val = shl(2 + (pfx_store & 1), srl(pfx_store, 1) - 1) + acc2
        nr[11] = torch.where(in_lxp & pre_done, prefix, r[11])
        nr[12] = torch.where(in_lyp & pre_done, prefix, r[12])
        nr[11] = torch.where(in_lxs & suf_done, suf_val, nr[11])
        nr[12] = torch.where(in_lys & suf_done, suf_val, nr[12])
        sufx = nr[11] > 3
        sufy = nr[12] > 3
        nbits_x = srl(nr[11], 1) - 1
        nbits_y = srl(nr[12], 1) - 1
        phase_u = torch.where(in_lxp & pre_done, P_LYP, phase_u)
        cnt = torch.where(in_lxp & pre_done, 0, cnt)
        yp_done = in_lyp & pre_done
        phase_u = torch.where(yp_done, torch.where(
            sufx, P_LXS, torch.where(sufy, P_LYS, phase_u)), phase_u)
        cnt = torch.where(yp_done, torch.where(sufx, nbits_x, nbits_y), cnt)
        nr[10] = torch.where(yp_done, 0, acc2)
        xs_done = in_lxs & suf_done
        phase_u = torch.where(xs_done & sufy, P_LYS, phase_u)
        cnt = torch.where(xs_done & sufy, nbits_y, cnt)
        nr[10] = torch.where(xs_done, 0, nr[10])
        cnt = torch.where((in_lxs | in_lys) & ~suf_done, r[9] - 1, cnt)
        cnt = torch.where(in_lpre & pre_more, cnt_rq + 1, cnt)
        tu_body = ((yp_done & ~sufx & ~sufy) | (xs_done & ~sufy)
                   | (in_lys & suf_done))

        # TU body entry: last subblock / position, enter the first subblock
        sw = scan == 2
        lx_f = torch.where(sw, nr[12], nr[11])
        ly_f = torch.where(sw, nr[11], nr[12])
        nr[11] = torch.where(tu_body, lx_f, nr[11])
        nr[12] = torch.where(tu_body, ly_f, nr[12])
        last_sb = _lut(T.sb_inv, sb_base + (srl(ly_f, 2) << 3) + srl(lx_f, 2))
        last_pos = _lut(T.co_inv, scan * 16 + ((ly_f & 3) << 2) + (lx_f & 3))
        nr[14] = torch.where(tu_body, last_sb, r[14])
        nr[21] = torch.where(tu_body, last_pos, r[21])
        nr[15] = torch.where(tu_body, 0, r[15])
        nr[16] = torch.where(tu_body, 0, r[16])
        nr[26] = torch.where(tu_body, -1, r[26])  # prev_g1_ctx = None

        def enter_sb(i, take, phase_u):
            """ENTER_SB(i), gated by `take`: mutates nr, returns
            (phase_u, sig_empty)."""
            fxy = _lut(T.sb_fwd, sb_base + i.clamp(min=0))
            exs = fxy & 255
            eys = srl(fxy, 8) & 255
            raster = eys * sb_side + exs
            is_last = i == nr[14]
            is_first = i == 0
            decode_csbf = ~is_last & ~is_first
            setbit = take & (is_last | is_first)
            bit = one << (raster & 31)
            nr[15] = torch.where(setbit & (raster < 32), nr[15] | bit, nr[15])
            nr[16] = torch.where(setbit & (raster >= 32), nr[16] | bit, nr[16])
            nr[17] = torch.where(take, exs | (eys << 8), nr[17])
            nr[13] = torch.where(take, i, nr[13])
            sig0 = torch.where(is_last, shl(one, nr[21].clamp(min=0)), 0)
            start_n = torch.where(is_last, nr[21] - 1, 15)
            nr[19] = torch.where(take & ~decode_csbf, sig0, nr[19])
            nr[20] = torch.where(take, 0, nr[20])
            nr[18] = torch.where(take, start_n, nr[18])
            sig_empty = is_last & (nr[21] == 0)
            ph2 = torch.where(decode_csbf, P_CSBF, _wh(sig_empty, P_G1, P_SIG))
            return torch.where(take, ph2, phase_u), sig_empty

        phase_u, tu_sig_empty = enter_sb(nr[14], tu_body, phase_u)

        # CSBF
        in_csbf = (phase == P_CSBF) & ~tu_now
        bit = one << (sb_raster & 31)
        coded = in_csbf & (b > 0)
        nr[15] = torch.where(coded & (sb_raster < 32), nr[15] | bit, nr[15])
        nr[16] = torch.where(coded & (sb_raster >= 32), nr[16] | bit, nr[16])
        nr[19] = torch.where(coded, 0, nr[19])
        nr[20] = torch.where(coded, 1, nr[20])
        nr[18] = torch.where(coded, 15, nr[18])
        phase_u = torch.where(coded, P_SIG, phase_u)
        csbf_skip = in_csbf & (b == 0)

        # SIG
        in_sig = (phase == P_SIG) & ~tu_now
        nbit = shl(one, r[18].clamp(min=0))
        nr[19] = torch.where(in_sig & (b > 0), nr[19] | nbit, nr[19])
        nr[20] = torch.where(in_sig & (b > 0), 0, nr[20])
        nxt_n = r[18] - 1
        dc_inf = (nxt_n == 0) & (nr[20] > 0)
        sig_end = in_sig & ((r[18] == 0) | dc_inf)
        nr[19] = torch.where(in_sig & dc_inf, nr[19] | 1, nr[19])
        nr[18] = torch.where(in_sig & ~sig_end, nxt_n, nr[18])

        # G1 entry
        g1_entry = sig_end | (tu_body & tu_sig_empty)
        sig_now = nr[19]
        sig_empty_now = sig_now == 0
        g1_go = g1_entry & ~sig_empty_now
        cset = _wh((nr[13] == 0) | (cidx > 0), 0, 2) + _i32(nr[26] == 0)
        nr[22] = torch.where(g1_go, cset, nr[22])
        nr[23] = torch.where(g1_go, 1, nr[23])
        nr[24] = torch.where(g1_go, 0, nr[24])
        nr[25] = torch.where(g1_go, -1, nr[25])
        nr[28] = torch.where(g1_go, 0, nr[28])
        nr[29] = torch.where(g1_go, 0, nr[29])
        nr[18] = torch.where(g1_go, _msb16(sig_now), nr[18])
        phase_u = torch.where(g1_go, P_G1, phase_u)

        # G1
        in_g1 = (phase == P_G1) & ~tu_now
        nmask = shl(one, r[18].clamp(min=0))
        nr[29] = torch.where(in_g1, nr[29] | nmask, nr[29])
        nr[28] = torch.where(in_g1 & (b > 0), nr[28] | nmask, nr[28])
        nr[25] = torch.where(in_g1 & (b > 0) & (r[25] < 0), r[18], nr[25])
        nr[23] = torch.where(in_g1, torch.where(b > 0, 0, torch.where(
            r[23] > 0, (r[23] + 1).clamp(max=15), r[23])), nr[23])
        nr[24] = torch.where(in_g1, r[24] + 1, nr[24])
        below = _msb16(nr[19] & (nmask - 1))
        g1_more = in_g1 & (below >= 0) & (nr[24] < 8)
        nr[18] = torch.where(g1_more, below, nr[18])
        g1_end = in_g1 & ~g1_more
        nr[26] = torch.where(g1_end, nr[23], nr[26])
        phase_u = torch.where(g1_end & (nr[25] >= 0), P_G2, phase_u)
        sign_entry = g1_end & (nr[25] < 0)

        # G2
        in_g2 = (phase == P_G2) & ~tu_now
        nr[27] = torch.where(in_g2, b, nr[27])
        sign_entry = sign_entry | in_g2

        # SIGN entry
        fs = _msb16(nr[19] & -nr[19])  # lowest set bit
        ls = _msb16(nr[19])
        hid = shide * _i32((ls - fs) > 3)
        nr[31] = torch.where(sign_entry, hid, nr[31])
        nr[32] = torch.where(sign_entry, fs, nr[32])
        nr[30] = torch.where(sign_entry, 0, nr[30])
        nr[18] = torch.where(sign_entry, ls, nr[18])
        phase_u = torch.where(sign_entry, P_SIGN, phase_u)

        # SIGN
        in_sgn = (phase == P_SIGN) & ~tu_now
        nmask2 = shl(one, r[18].clamp(min=0))
        nr[30] = torch.where(in_sgn & (b > 0), nr[30] | nmask2, nr[30])
        below2 = _msb16(nr[19] & (nmask2 - 1))
        below2 = torch.where((below2 == nr[32]) & (nr[31] > 0), -1, below2)
        sgn_more = in_sgn & (below2 >= 0)
        nr[18] = torch.where(sgn_more, below2, nr[18])
        rem_entry = in_sgn & ~sgn_more

        # REM entry: remaining mask, base sum, first coefficient
        lastg1_bit = torch.where(nr[25] >= 0,
                                 shl(one, nr[25].clamp(min=0)), 0)
        remmask = ((nr[19] & ~nr[29]) | (nr[28] & ~lastg1_bit)
                   | (lastg1_bit * nr[27]))
        base_sum = (_popcount16(nr[19] & ~remmask)
                    + _popcount16(nr[28] & ~remmask))
        nr[36] = torch.where(rem_entry, remmask, nr[36])
        nr[34] = torch.where(rem_entry, base_sum, nr[34])
        nr[33] = torch.where(rem_entry, 0, nr[33])
        rem_first = _msb16(remmask)
        has_rem = rem_entry & (rem_first >= 0)

        def coeff_base(n):
            g1b = srl(nr[28], n.clamp(min=0)) & 1
            isl = _i32(n == nr[25]) * _i32(nr[25] >= 0)
            return 1 + g1b + isl * nr[27]

        nr[18] = torch.where(has_rem, rem_first, nr[18])
        nr[35] = torch.where(has_rem, coeff_base(rem_first), nr[35])
        cnt = torch.where(has_rem, 0, cnt)
        phase_u = torch.where(has_rem, P_REMP, phase_u)
        flush_entry = rem_entry & (rem_first < 0)

        # REM prefix. The prefix has no 31-bin cap here, as in the Pallas
        # kernel; a longer one makes the shifts give 0 (XLA's rule). The
        # host envelope decode rejects such a stream first.
        in_rp = (phase == P_REMP) & ~tu_now
        cnt = torch.where(in_rp & (b > 0), r[9] + 1, cnt)
        rp_done = in_rp & (b == 0)
        pfx, rice = r[9], nr[33]
        nsuf = torch.where(pfx < 3, rice, pfx - 3 + rice)
        rem_imm = torch.where(
            pfx < 3, shl(pfx, rice),
            shl(shl(one, (pfx - 3).clamp(min=0)) + 2, rice))
        goes_suf = rp_done & (nsuf > 0)
        nr[37] = torch.where(rp_done, pfx, nr[37])
        phase_u = torch.where(goes_suf, P_REMS, phase_u)
        cnt = torch.where(goes_suf, nsuf, cnt)
        nr[10] = torch.where(goes_suf, 0, nr[10])
        coeff_done_p = rp_done & (nsuf == 0)

        # REM suffix
        in_rs = (phase == P_REMS) & ~tu_now
        acc3 = (r[10] << 1) | b
        nr[10] = torch.where(in_rs, acc3, nr[10])
        rs_done = in_rs & (r[9] == 1)
        cnt = torch.where(in_rs & ~rs_done, r[9] - 1, cnt)
        pfx2, rice2 = nr[37], nr[33]
        rem_val_s = torch.where(
            pfx2 < 3, shl(pfx2, rice2) + acc3,
            shl(shl(one, (pfx2 - 3).clamp(min=0)) + 2, rice2) + acc3)

        coeff_done = coeff_done_p | rs_done
        level = nr[35] + torch.where(rs_done, rem_val_s, rem_imm)
        # Rice adaptation
        nr[33] = torch.where(coeff_done, torch.where(
            level > shl(one * 3, nr[33]), (nr[33] + 1).clamp(max=4), nr[33]),
            nr[33])
        nr[34] = torch.where(coeff_done, nr[34] + level, nr[34])
        lrow = r[18].clamp(0, 15).to(torch.int64)
        lv_w = coeff_done & (r[18].clamp(min=0) < 16)
        levels[lrow, lane] = torch.where(lv_w, level, levels[lrow, lane])
        below3 = _msb16(nr[36] & (shl(one, r[18].clamp(min=0)) - 1))
        rem_more = coeff_done & (below3 >= 0)
        nr[18] = torch.where(rem_more, below3, nr[18])
        nr[35] = torch.where(rem_more, coeff_base(below3), nr[35])
        cnt = torch.where(rem_more, 0, cnt)
        phase_u = torch.where(rem_more, P_REMP, phase_u)
        flush_entry = flush_entry | (coeff_done & ~rem_more)

        # FLUSH entry
        nr[18] = torch.where(flush_entry, _msb16(nr[19]), nr[18])
        phase_u = torch.where(flush_entry, P_FLUSH, phase_u)

        # FLUSH: one coefficient event
        in_fl = (phase == P_FLUSH) & ~tu_now
        n_f = r[18].clamp(min=0)
        is_rem = srl(nr[36], n_f) & 1
        lv_stored = torch.where(
            n_f < 16, levels[n_f.clamp(max=15).to(torch.int64), lane], 0)
        lv = torch.where(is_rem > 0, lv_stored, coeff_base(n_f))
        sgn = torch.where((nr[31] > 0) & (n_f == nr[32]), nr[34] & 1,
                          srl(nr[30], n_f) & 1)
        val = torch.where(sgn > 0, -lv, lv)
        ev = torch.where(
            in_fl,
            -(1 << 31) | (n_f << 26) | (nr[13] << 20) | (val & 0xFFFFF), ev)
        below4 = _msb16(nr[19] & (shl(one, n_f) - 1))
        fl_more = in_fl & (below4 >= 0)
        nr[18] = torch.where(fl_more, below4, nr[18])
        sb_end = in_fl & ~fl_more

        # next subblock / TU end
        next_sb = csbf_skip | sb_end | (g1_entry & sig_empty_now)
        nexti = nr[13] - 1
        tu_end = next_sb & (nexti < 0)
        phase_u, _ = enter_sb(nexti, next_sb & (nexti >= 0), phase_u)
        phase_u = torch.where(tu_end, P_TAPE, phase_u)

        nr[7] = phase_u
        nr[9] = cnt
        r = nr
        events[t] = ev
        if debug:
            dbgs[t] = kind | (slot << 3) | (b << 12) | (phase << 16)

    return (from_lanes(events, B),
            from_lanes(dbgs, B) if debug else None,
            from_lanes(ctx, B))


# --------------------------------------------------------------------------
# kernel wrapper
# --------------------------------------------------------------------------


def gen(words, tape, c0, n_steps: int, debug: bool = False):
    """Run the generator for n_steps lockstep steps over B x 128 streams
    (see the module docstring). Context values are 7-bit (p | mps<<6).
    Returns (events [B, S, 128], dbg [B, S, 128] or None,
    state [B, 136, 128]) int32."""
    B, W = words.shape[0], words.shape[1]
    s_env = tape.shape[1]
    dev = words.device
    check("words", words, (B, W, LANES), dev)
    check("tape", tape, (B, s_env, LANES), dev)
    check("c0", c0, (B, N_CTX, LANES), dev)
    if s_env < 1 or n_steps < 0:
        raise ValueError(f"bad sizes: S_env {s_env}, n_steps {n_steps}")
    if dev.type == "cpu":
        return gen_plain(words, tape, c0, n_steps, debug=debug)
    from heif_tpu_torch.ops import _build

    T = cabac_tables_on(dev)
    events = torch.empty((B, n_steps, LANES), dtype=torch.int32, device=dev)
    dbg = torch.empty_like(events) if debug else None
    state = torch.empty_like(c0)
    rc = _build.load().heif_cabac_gen(
        events.data_ptr(), None if dbg is None else dbg.data_ptr(),
        state.data_ptr(), words.data_ptr(), tape.data_ptr(), c0.data_ptr(),
        T.tbl.data_ptr(), T.sb_fwd.data_ptr(), T.sb_inv.data_ptr(),
        T.co_fwd.data_ptr(), T.co_inv.data_ptr(), T.sig4.data_ptr(),
        B, W, s_env, n_steps, torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(rc, "heif_cabac_gen")
    LAUNCHES["gen"] += 1
    return events, dbg, state


# --------------------------------------------------------------------------
# numpy entry points, as heif_tpu.ops.pallas_cabac_gen's (device: "cuda",
# the default, or "cpu"; without a card a call that names no device raises)
# --------------------------------------------------------------------------


def run_gen_batch(entries, blk: int = 128, device=None, debug: bool = False):
    """Run the generator on <=128 streams.

    entries: (rbsp, TraceSegment, envelope_tape, n_steps) per lane. The
    step count is padded to a multiple of blk, as the Pallas grid pads it.
    Returns numpy (events [S_steps, 128], ctx_final [N_CTX, 128]), and
    the per-step debug plane [S_steps, 128] as a third element when
    debug is set."""
    device = resolve_device(device)
    p = pack_gen_batch(entries)
    S = -(-p["S_steps"] // blk) * blk
    ev, dbg, state = gen(as_tensor(p["words"][None], device),
                         as_tensor(p["tape"][None], device),
                         as_tensor(p["c0"][None], device), S, debug=debug)
    out = (ev.cpu().numpy()[0], state.cpu().numpy()[0])
    if debug:
        return out + (dbg.cpu().numpy()[0],)
    return out


def image_inputs(entries, blk: int = 512, device=None):
    """Pack every stream of an image into one launch: length-sorted
    128-lane batches stacked on the batch axis (one CUDA block each).
    Zero words past a batch's end read like the kernel's past-the-end
    fetch, and KIND_PAD tape rows never advance a lane, so every batch
    gives what its own launch would. Returns (tensors, n_steps, batches)
    with tensors = (words, tape, c0)."""
    device = resolve_device(device)
    batches = pack_gen_batches(entries)
    packed = [pack_gen_batch([e[:4] for e in batch]) for batch, _ in batches]
    words, tape, c0 = stack_batches(packed, ("words", "tape", "c0"),
                                    (0, KIND_PAD, 0))
    S = max(-(-p["S_steps"] // blk) * blk for p in packed)
    return tuple(as_tensor(a, device) for a in (words, tape, c0)), S, batches


def gen_image(entries, blk: int = 512, device=None):
    """Run the generator over every stream of an image in one launch.

    entries: (rbsp, TraceSegment, envelope_tape, n_steps, spans) per
    stream. Returns per-entry (events_col, p_final, mps_final) in input
    order."""
    device = resolve_device(device)
    args, S, batches = image_inputs(entries, blk, device)
    ev, _, state = gen(*args, S)
    ev, state = ev.cpu().numpy(), state.cpu().numpy()
    results = [None] * len(entries)
    for bi, (_, idx) in enumerate(batches):
        for lane, ei in enumerate(idx):
            results[ei] = (
                ev[bi, :, lane],
                (state[bi, :, lane] & 63).astype(np.uint8),
                ((state[bi, :, lane] >> 6) & 1).astype(np.uint8),
            )
    return results


def longest_lane(entries) -> int:
    """Steps of the longest lane of a generator run over (rbsp, seg,
    tape, n_steps, ...) entries: its n_steps. The kernel's time is that
    lane's chain; the lane has finished after it."""
    return max((e[3] for e in entries), default=0)


def gen_bytes(entries, debug: bool = False) -> int:
    """The bytes a generator run of whole lanes must move, padding not
    counted: per lane its n_steps event words (and debug words), its
    context state read and written once, the envelope tape rows it reads
    (every entry and the KIND_PAD row after them) and the stream bytes its
    bins consume."""
    per_step = 8 if debug else 4
    return sum(per_step * ns + 2 * 4 * N_CTX + 4 * (tape.size + 1)
               + stream_bytes(seg, seg.n_bins)
               for _, seg, tape, ns, *_ in entries)


def bench_gen_image(entries, blk: int = 512, reps: int = 3, device="cuda"):
    """Kernel-only generator throughput over every stream of an image:
    inputs staged on the card once, one launch timed with CUDA events.
    Returns (real_mbins_per_s, steps_per_s, seconds)."""
    args, S, batches = image_inputs(entries, blk, device)
    s = cuda_ms(lambda: gen(*args, S), reps, device) / 1e3
    total_bins = sum(e[1].n_bins for e in entries)
    return total_bins / s / 1e6, S * len(batches) / s, s
