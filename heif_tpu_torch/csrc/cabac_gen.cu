// CABAC engine with the residual_coding() request generator, for Hopper:
// one substream per thread.
//
// Replaces the TPU Pallas kernel heif_tpu/ops/pallas_cabac_gen.py
// `_kernel` (launched by `_gen_call` / `run_gen_batch` / `gen_image`).
// Each lane replays an envelope tape (non-residual bins plus one KIND_TU
// marker per transform block) and, at each marker, runs the 13-phase
// residual_coding() state machine (§7.3.8.11) that derives every request
// itself: last_sig prefix / suffix, coded_sub_block_flag, sig_coeff_flag
// (§9.3.4.2.5), greater1 / greater2, signs with sign-data hiding, and
// coeff_abs_level_remaining with Rice adaptation; a flush emits one
// coefficient event per step. One bin or one flush per lane per step, so
// the event plane [step, lane] and the debug plane equal the Pallas
// kernel's and the plain version's (heif_tpu_torch/ops/cabac_gen.py)
// step for step.
//
// Design: the Pallas kernel computes every phase each step and selects,
// over 128 lanes, with mask reductions for every per-lane lookup. Here a
// thread is a lane and runs only its own phase: a switch on the phase
// does that phase's update, then the entries it chains into (TU body ->
// subblock entry -> greater1 -> sign -> remaining -> flush -> next
// subblock) run in the Pallas kernel's order. The registers keep the
// Pallas register map (pallas_cabac_gen.py:217-224; `r[i]` below).
// Context bytes, the arithmetic decoder and the 256-entry table are
// cabac_engine.cuh's; the scan tables are in constant memory; the levels
// of the current subblock are a [16][128] shared-memory plane.
//
// What bounds it: latency, as for the replay (cabac.cu): each step is a
// dependent chain of a bin decode plus a few dozen integer operations,
// the flagship image gives 6 blocks of 128 lanes for 132 SMs, and the
// lanes of a warp sit in different phases (divergence) and read different
// table rows.

#include "cabac_engine.cuh"

namespace {

constexpr int KIND_TU = 4;  // heif_tpu.cabac.envelope.KIND_TU
enum {
  P_TAPE, P_LXP, P_LYP, P_LXS, P_LYS, P_CSBF, P_SIG, P_G1, P_G2,
  P_SIGN, P_REMP, P_REMS, P_FLUSH
};
// context slot bases, heif_tpu.cabac.engine.CTX_OFFSET (a CPU test holds
// these lines against it)
constexpr int B_LASTX = 22;
constexpr int B_LASTY = 40;
constexpr int B_CSBF = 58;
constexpr int B_SIG = 62;
constexpr int B_G1 = 106;
constexpr int B_G2 = 130;

// subblock scans [scan*256 + (log2-2)*64 + key]: fwd = xs | ys<<8 by scan
// index, inv = scan index by ys*8+xs; 4x4 scans [scan*16 + key] likewise;
// the 4x4 sig ctxIdxMap 4 bits an entry (entries 0-7, 8-15)
__constant__ int32_t c_sb_fwd[768];
__constant__ int32_t c_sb_inv[768];
__constant__ int32_t c_co_fwd[48];
__constant__ int32_t c_co_inv[48];
__constant__ int32_t c_sig4[2];

// table[idx], 0 outside [0, n) (the Pallas masked lookup)
__device__ __forceinline__ int32_t lut(const int32_t* tab, int n, int idx) {
  return (unsigned)idx < (unsigned)n ? tab[idx] : 0;
}

// index of the highest set bit of x (16-bit values); -1 when x <= 0
__device__ __forceinline__ int msb16(int32_t x) {
  int r = 0;
  int32_t cur = x;
  for (int b = 8; b > 0; b >>= 1) {
    const int32_t hi = srl(cur, b);
    if (hi > 0) {
      r += b;
      cur = hi;
    }
  }
  return x > 0 ? r : -1;
}

__device__ __forceinline__ int32_t popcount16(int32_t v) {
  uint32_t x = (uint32_t)v;
  x = x - ((x >> 1) & 0x5555u);
  x = (x & 0x3333u) + ((x >> 2) & 0x3333u);
  x = (x + (x >> 4)) & 0x0F0Fu;
  return (int32_t)((x + (x >> 8)) & 0x1Fu);
}

// (1 << n) - 1 for n >= 0, wrapping (all ones for n >= 32)
__device__ __forceinline__ int32_t below_mask(int n) {
  return (int32_t)((uint32_t)shl(1, n < 0 ? 0 : n) - 1u);
}

struct Lane {
  Engine e;                        // r0..r5
  int tptr, phase, desc, cnt;      // r6..r9
  int32_t acc;                     // r10 suffix accumulator
  int lastx, lasty, sbi, lastsb;   // r11..r14
  int32_t csl, csh;                // r15, r16 csbf bits of subblocks 0-31, 32-63
  int sbxy, posn;                  // r17, r18
  int32_t sig;                     // r19 sig mask of the subblock
  int infer, lastpos, ctxset;      // r20..r22
  int g1ctx, ng1, lastg1, prevg1;  // r23..r26
  int g2;                          // r27
  int32_t g1bits, g1cov, signbits; // r28..r30
  int hidden, firstsig, rice;      // r31..r33
  int32_t sumabs, rembase;         // r34, r35
  int32_t remmask;                 // r36
  int rempfx, tuseq;               // r37, r38
};

struct Desc {
  int cidx, log2m2, scan, shide, sb_side, sb_base;
};

__device__ __forceinline__ Desc unpack_desc(int d) {
  Desc x;
  x.cidx = d & 3;
  x.log2m2 = (d >> 2) & 3;
  x.scan = (d >> 4) & 3;
  x.shide = (d >> 6) & 1;
  x.sb_side = 1 << x.log2m2;
  x.sb_base = x.scan * 256 + x.log2m2 * 64;
  return x;
}

__device__ __forceinline__ int csbf_bit(const Lane& g, int idx) {
  return srl(idx >= 32 ? g.csh : g.csl, idx & 31) & 1;
}

// coded_sub_block_flag of the right and below neighbours of the current
// subblock
__device__ __forceinline__ void csbf_neighbours(const Lane& g, const Desc& d,
                                                int& right, int& below) {
  const int xs = g.sbxy & 255, ys = (g.sbxy >> 8) & 255;
  const int raster = ys * d.sb_side + xs;
  right = xs + 1 < d.sb_side ? csbf_bit(g, raster + 1) : 0;
  below = ys + 1 < d.sb_side ? csbf_bit(g, raster + d.sb_side) : 0;
}

// sig_coeff_flag context slot (§9.3.4.2.5) for position r18
__device__ __forceinline__ int sig_slot(const Lane& g, const Desc& d) {
  const int xs = g.sbxy & 255, ys = (g.sbxy >> 8) & 255;
  const int32_t xy = lut(c_co_fwd, 48, d.scan * 16 + max(g.posn, 0));
  const int xp = xy & 255, yp = srl(xy, 8) & 255;
  const int xc = (xs << 2) + xp, yc = (ys << 2) + yp;
  const int s4i = (yp << 2) + xp;
  const int sig4 = s4i < 8 ? srl(c_sig4[0], 4 * s4i) & 15
                           : srl(c_sig4[1], 4 * (s4i - 8)) & 15;
  int right, below;
  csbf_neighbours(g, d, right, below);
  const int sums = xp + yp;
  int sc;
  switch (right + 2 * below) {
    case 0: sc = sums == 0 ? 2 : (sums < 3 ? 1 : 0); break;
    case 1: sc = yp == 0 ? 2 : (yp == 1 ? 1 : 0); break;
    case 2: sc = xp == 0 ? 2 : (xp == 1 ? 1 : 0); break;
    default: sc = 2;
  }
  sc += d.cidx == 0
            ? (xs + ys > 0 ? 3 : 0) +
                  (d.log2m2 == 1 ? (d.scan == 0 ? 9 : 15) : 21)
            : (d.log2m2 == 1 ? 9 : 12);
  if (d.log2m2 == 0) sc = sig4;
  if (xc + yc == 0 && d.log2m2 > 0) sc = 0;
  return B_SIG + sc + (d.cidx > 0 ? 27 : 0);
}

// ENTER_SB(i): subblock i becomes current; returns sig_empty (the last
// subblock with last_pos 0 has an empty sig loop and goes to greater1)
__device__ __forceinline__ bool enter_sb(Lane& g, const Desc& d, int i,
                                         int& phase) {
  const int32_t fxy = lut(c_sb_fwd, 768, d.sb_base + max(i, 0));
  const int exs = fxy & 255, eys = srl(fxy, 8) & 255;
  const int raster = eys * d.sb_side + exs;
  const bool is_last = i == g.lastsb, is_first = i == 0;
  const bool decode_csbf = !is_last && !is_first;
  if (!decode_csbf) {  // the first and last subblocks are inferred coded
    if (raster < 32)
      g.csl |= shl(1, raster & 31);
    else
      g.csh |= shl(1, raster & 31);
    g.sig = is_last ? shl(1, max(g.lastpos, 0)) : 0;
  }
  g.sbxy = exs | (eys << 8);
  g.sbi = i;
  g.infer = 0;
  g.posn = is_last ? g.lastpos - 1 : 15;
  const bool sig_empty = is_last && g.lastpos == 0;
  phase = decode_csbf ? P_CSBF : (sig_empty ? P_G1 : P_SIG);
  return sig_empty;
}

// base level of coefficient n: 1 + greater1 + greater2 (on the first
// greater1 coefficient)
__device__ __forceinline__ int32_t coeff_base(const Lane& g, int n) {
  const int g1b = srl(g.g1bits, max(n, 0)) & 1;
  const int isl = (n == g.lastg1 && g.lastg1 >= 0) ? 1 : 0;
  return 1 + g1b + isl * g.g2;
}

// coeff_abs_level_remaining without its suffix bits. The prefix has no
// 31-bin cap (as in the Pallas kernel): a longer one gives 0 here through
// shl's defined out-of-range result. The host envelope decode rejects
// such a stream first, so conformant streams never reach it.
__device__ __forceinline__ int32_t rem_prefix_value(int pfx, int rice) {
  return pfx < 3 ? shl(pfx, rice)
                 : shl(wadd(shl(1, max(pfx - 3, 0)), 2), rice);
}

// One lockstep step: request -> bin -> state update. Returns the event
// word; *dbg gets kind | slot<<3 | bin<<12 | phase<<16.
__device__ __forceinline__ int32_t gen_step(Lane& g, uint8_t* ctx,
                                            int32_t* lv,
                                            const uint32_t* col, int W,
                                            const int32_t* tape_col, int s_env,
                                            int32_t* dbg) {
  const int phase = g.phase;
  int desc = g.desc;
  int cnt = g.cnt;
  int phase_rq = phase;
  int kind = KIND_PAD, slot = 0, e_kind = KIND_PAD;
  bool tu_now = false;

  // ---------- request resolution ----------
  if (phase == P_TAPE) {
    const int32_t entry =
        (unsigned)g.tptr < (unsigned)s_env ? tape_col[(size_t)g.tptr * LANES]
                                           : 0;
    e_kind = entry & 7;
    const int32_t e_pay = srl(entry, 3);
    if (e_kind == KIND_TU) {  // consumed here; last_x bin 0 issues now
      tu_now = true;
      desc = e_pay & 127;
      phase_rq = P_LXP;
      cnt = 0;
    } else {
      kind = e_kind;
      slot = e_pay;
    }
  }
  const Desc d = unpack_desc(desc);
  switch (phase_rq) {
    case P_LXP:
    case P_LYP: {  // §9.3.4.2.3
      const int off = d.cidx == 0 ? 3 * d.log2m2 + ((d.log2m2 + 1) >> 2) : 15;
      const int sh = d.cidx == 0 ? (d.log2m2 + 3) >> 2 : d.log2m2;
      kind = KIND_CTX;
      slot = (phase_rq == P_LXP ? B_LASTX : B_LASTY) + off + srl(cnt, sh);
      break;
    }
    case P_LXS:
    case P_LYS:
    case P_SIGN:
    case P_REMP:
    case P_REMS:
      kind = KIND_BYPASS;
      slot = 0;
      break;
    case P_CSBF: {
      int right, below;
      csbf_neighbours(g, d, right, below);
      kind = KIND_CTX;
      slot = B_CSBF + min(right + below, 1) + (d.cidx > 0 ? 2 : 0);
      break;
    }
    case P_SIG:
      kind = KIND_CTX;
      slot = sig_slot(g, d);
      break;
    case P_G1:
      kind = KIND_CTX;
      slot = B_G1 + g.ctxset * 4 + min(g.g1ctx, 3) + (d.cidx > 0 ? 16 : 0);
      break;
    case P_G2:
      kind = KIND_CTX;
      slot = B_G2 + g.ctxset + (d.cidx > 0 ? 4 : 0);
      break;
    default:  // P_TAPE (kind from the tape) and P_FLUSH (no bin)
      break;
  }

  const int b = decode_bin(g.e, kind, slot, ctx, col, W);
  if (dbg) *dbg = kind | shl(slot, 3) | (b << 12) | (phase << 16);

  // ---------- state update ----------
  int32_t ev = 0;
  if (phase == P_TAPE && e_kind != KIND_PAD) g.tptr = min(g.tptr + 1, s_env - 1);
  g.desc = desc;
  if (tu_now) {
    ev = (1 << 30) | (g.tuseq & 0xFF);
    g.tuseq += 1;
  }
  int ph = phase_rq;
  bool tu_body = false, g1_entry = false, sign_entry = false;
  bool rem_entry = false, coeff_done = false, next_sb = false;
  int32_t rem_val = 0;

  switch (phase_rq) {
    case P_LXP:
    case P_LYP: {
      const int cmax = ((d.log2m2 + 2) << 1) - 1;
      if (b && cnt + 1 < cmax) {
        cnt += 1;
      } else if (phase_rq == P_LXP) {
        g.lastx = b ? cnt + 1 : cnt;  // parked x prefix
        ph = P_LYP;
        cnt = 0;
      } else {
        g.lasty = b ? cnt + 1 : cnt;
        g.acc = 0;
        if (g.lastx > 3) {
          ph = P_LXS;
          cnt = srl(g.lastx, 1) - 1;
        } else if (g.lasty > 3) {
          ph = P_LYS;
          cnt = srl(g.lasty, 1) - 1;
        } else {
          tu_body = true;
        }
      }
      break;
    }
    case P_LXS:
    case P_LYS: {
      const int32_t acc2 = shl(g.acc, 1) | b;
      if (g.cnt == 1) {  // last suffix bit: resolve the position
        const int pfx = phase_rq == P_LXS ? g.lastx : g.lasty;
        const int32_t val =
            wadd(shl(2 + (pfx & 1), srl(pfx, 1) - 1), acc2);
        if (phase_rq == P_LXS) {
          g.lastx = val;
          g.acc = 0;
          if (g.lasty > 3) {
            ph = P_LYS;
            cnt = srl(g.lasty, 1) - 1;
          } else {
            tu_body = true;
          }
        } else {
          g.lasty = val;
          tu_body = true;
        }
      } else {
        g.acc = acc2;
        cnt = g.cnt - 1;
      }
      break;
    }
    case P_CSBF:
      if (b) {
        const int raster = ((g.sbxy >> 8) & 255) * d.sb_side + (g.sbxy & 255);
        if (raster < 32)
          g.csl |= shl(1, raster & 31);
        else
          g.csh |= shl(1, raster & 31);
        g.sig = 0;
        g.infer = 1;  // DC inference armed
        g.posn = 15;
        ph = P_SIG;
      } else {
        next_sb = true;
      }
      break;
    case P_SIG: {
      const int n = g.posn;
      if (b) {
        g.sig |= shl(1, max(n, 0));
        g.infer = 0;
      }
      const bool dc_inf = n - 1 == 0 && g.infer > 0;
      if (dc_inf) g.sig |= 1;
      if (n == 0 || dc_inf)
        g1_entry = true;
      else
        g.posn = n - 1;
      break;
    }
    case P_G1: {
      const int n = g.posn;
      const int32_t nmask = shl(1, max(n, 0));
      g.g1cov |= nmask;
      if (b) {
        g.g1bits |= nmask;
        if (g.lastg1 < 0) g.lastg1 = n;
      }
      g.g1ctx = b ? 0 : (g.g1ctx > 0 ? min(g.g1ctx + 1, 15) : g.g1ctx);
      g.ng1 += 1;
      const int below = msb16(g.sig & below_mask(n));
      if (below >= 0 && g.ng1 < 8) {
        g.posn = below;
      } else {
        g.prevg1 = g.g1ctx;
        if (g.lastg1 >= 0)
          ph = P_G2;
        else
          sign_entry = true;
      }
      break;
    }
    case P_G2:
      g.g2 = b;
      sign_entry = true;
      break;
    case P_SIGN: {
      const int n = g.posn;
      if (b) g.signbits |= shl(1, max(n, 0));
      int below = msb16(g.sig & below_mask(n));
      if (below == g.firstsig && g.hidden > 0) below = -1;
      if (below >= 0)
        g.posn = below;
      else
        rem_entry = true;
      break;
    }
    case P_REMP:
      if (b) {
        cnt = g.cnt + 1;
      } else {
        const int pfx = g.cnt;
        const int nsuf = pfx < 3 ? g.rice : pfx - 3 + g.rice;
        g.rempfx = pfx;
        if (nsuf > 0) {
          ph = P_REMS;
          cnt = nsuf;
          g.acc = 0;
        } else {
          coeff_done = true;
          rem_val = rem_prefix_value(pfx, g.rice);
        }
      }
      break;
    case P_REMS: {
      const int32_t acc3 = shl(g.acc, 1) | b;
      g.acc = acc3;
      if (g.cnt == 1) {
        coeff_done = true;
        rem_val = wadd(rem_prefix_value(g.rempfx, g.rice), acc3);
      } else {
        cnt = g.cnt - 1;
      }
      break;
    }
    case P_FLUSH: {  // emit one coefficient event
      const int n = max(g.posn, 0);
      const int32_t stored = n < 16 ? lv[n * LANES] : 0;
      const int32_t level = (srl(g.remmask, n) & 1) ? stored : coeff_base(g, n);
      const int sgn = (g.hidden > 0 && n == g.firstsig)
                          ? (g.sumabs & 1)
                          : (srl(g.signbits, n) & 1);
      const int32_t val = sgn ? (int32_t)(0u - (uint32_t)level) : level;
      ev = (int32_t)0x80000000u | shl(n, 26) | shl(g.sbi, 20) | (val & 0xFFFFF);
      const int below = msb16(g.sig & below_mask(n));
      if (below >= 0)
        g.posn = below;
      else
        next_sb = true;
      break;
    }
    default:
      break;
  }

  // ---------- chained entries, in the Pallas kernel's order ----------
  if (tu_body) {  // last position -> last subblock, enter it
    int lx = g.lastx, ly = g.lasty;
    if (d.scan == 2) {  // vertical scan: swap
      lx = g.lasty;
      ly = g.lastx;
    }
    g.lastx = lx;
    g.lasty = ly;
    g.lastsb = lut(c_sb_inv, 768,
                   wadd(d.sb_base, wadd(shl(srl(ly, 2), 3), srl(lx, 2))));
    g.lastpos = lut(c_co_inv, 48, d.scan * 16 + ((ly & 3) << 2) + (lx & 3));
    g.csl = g.csh = 0;
    g.prevg1 = -1;
    if (enter_sb(g, d, g.lastsb, ph)) g1_entry = true;
  }
  if (g1_entry) {
    if (g.sig == 0) {
      next_sb = true;
    } else {
      g.ctxset = ((g.sbi == 0 || d.cidx > 0) ? 0 : 2) + (g.prevg1 == 0);
      g.g1ctx = 1;
      g.ng1 = 0;
      g.lastg1 = -1;
      g.g1bits = 0;
      g.g1cov = 0;
      g.posn = msb16(g.sig);
      ph = P_G1;
    }
  }
  if (sign_entry) {
    const int fs = msb16(g.sig & (int32_t)(0u - (uint32_t)g.sig));
    const int ls = msb16(g.sig);
    g.hidden = d.shide && (ls - fs) > 3;
    g.firstsig = fs;
    g.signbits = 0;
    g.posn = ls;
    ph = P_SIGN;
  }
  bool flush_entry = false;
  if (rem_entry) {
    const int32_t lastg1_bit = g.lastg1 >= 0 ? shl(1, g.lastg1) : 0;
    const int32_t rm = (g.sig & ~g.g1cov) | (g.g1bits & ~lastg1_bit) |
                       (int32_t)((uint32_t)lastg1_bit * (uint32_t)g.g2);
    g.remmask = rm;
    g.sumabs = popcount16(g.sig & ~rm) + popcount16(g.g1bits & ~rm);
    g.rice = 0;
    const int first = msb16(rm);
    if (first >= 0) {
      g.posn = first;
      g.rembase = coeff_base(g, first);
      cnt = 0;
      ph = P_REMP;
    } else {
      flush_entry = true;
    }
  }
  if (coeff_done) {
    const int32_t level = wadd(g.rembase, rem_val);
    if (level > shl(3, g.rice)) g.rice = min(g.rice + 1, 4);  // Rice update
    g.sumabs = wadd(g.sumabs, level);
    const int n = max(g.posn, 0);
    if (n < 16) lv[n * LANES] = level;
    const int below = msb16(g.remmask & below_mask(g.posn));
    if (below >= 0) {
      g.posn = below;
      g.rembase = coeff_base(g, below);
      cnt = 0;
      ph = P_REMP;
    } else {
      flush_entry = true;
    }
  }
  if (flush_entry) {
    g.posn = msb16(g.sig);
    ph = P_FLUSH;
  }
  if (next_sb) {
    const int nexti = g.sbi - 1;
    if (nexti < 0)
      ph = P_TAPE;  // TU done: back to the envelope tape
    else
      enter_sb(g, d, nexti, ph);
  }
  g.phase = ph;
  g.cnt = cnt;
  return ev;
}

__global__ void __launch_bounds__(LANES)
gen_kernel(int32_t* __restrict__ events, int32_t* __restrict__ dbg,
           int32_t* __restrict__ state, const uint32_t* __restrict__ words,
           const int32_t* __restrict__ tape, const int32_t* __restrict__ c0,
           int W, int s_env, int S) {
  __shared__ uint8_t ctx_plane[N_CTX * LANES];
  __shared__ int32_t lv_plane[16 * LANES];
  const int lane = threadIdx.x;
  const size_t b = blockIdx.x;
  uint8_t* ctx = ctx_plane + lane;
  const int32_t* c0b = c0 + b * N_CTX * LANES + lane;
  for (int s = 0; s < N_CTX; ++s) ctx[s * LANES] = (uint8_t)c0b[s * LANES];

  const uint32_t* col = words + b * (size_t)W * LANES + lane;
  const int32_t* tape_col = tape + b * (size_t)s_env * LANES + lane;
  Lane g = {};
  engine_start(g.e, col, W, 0);
  g.phase = P_TAPE;
  const size_t base = b * (size_t)S * LANES + lane;
  for (int t = 0; t < S; ++t) {
    const size_t i = base + (size_t)t * LANES;
    events[i] = gen_step(g, ctx, lv_plane + lane, col, W, tape_col, s_env,
                         dbg ? dbg + i : nullptr);
  }
  int32_t* out = state + b * N_CTX * LANES + lane;
  for (int s = 0; s < N_CTX; ++s) out[s * LANES] = ctx[s * LANES];
}

}  // namespace

extern "C" {

// events / dbg [B,S,128] (dbg may be null), state [B,136,128] <-
// words [B,W,128], tape [B,S_env,128], c0 [B,136,128]; the tables are
// the CabacTables buffers on the device
int heif_cabac_gen(int32_t* events, int32_t* dbg, int32_t* state,
                   const int32_t* words, const int32_t* tape,
                   const int32_t* c0, const int32_t* tbl,
                   const int32_t* sb_fwd, const int32_t* sb_inv,
                   const int32_t* co_fwd, const int32_t* co_inv,
                   const int32_t* sig4, int B, int W, int s_env, int S,
                   cudaStream_t stream) {
  const cudaMemcpyKind d2d = cudaMemcpyDeviceToDevice;
  cudaError_t err = upload_tbl(tbl, stream);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(c_sb_fwd, sb_fwd, sizeof(c_sb_fwd), 0, d2d,
                                  stream);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(c_sb_inv, sb_inv, sizeof(c_sb_inv), 0, d2d,
                                  stream);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(c_co_fwd, co_fwd, sizeof(c_co_fwd), 0, d2d,
                                  stream);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(c_co_inv, co_inv, sizeof(c_co_inv), 0, d2d,
                                  stream);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(c_sig4, sig4, sizeof(c_sig4), 0, d2d,
                                  stream);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    gen_kernel<<<B, LANES, 0, stream>>>(
        events, dbg, state, reinterpret_cast<const uint32_t*>(words), tape,
        c0, W, s_env, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
