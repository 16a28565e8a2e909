// CABAC engine with the residual_coding() request generator, for Hopper.
//
// Replaces the TPU Pallas kernel heif_tpu/ops/pallas_cabac_gen.py:171
// `_kernel` (launched by `_gen_call`, :864, from `run_gen_batch` /
// `gen_image`). Each lane replays an envelope tape (non-residual bins plus
// one KIND_TU marker per transform block) and, at each marker, runs the
// 13-phase residual_coding() state machine (§7.3.8.11) that derives every
// request itself: last_sig prefix / suffix, coded_sub_block_flag,
// sig_coeff_flag (§9.3.4.2.5), greater1 / greater2, signs with sign-data
// hiding, and coeff_abs_level_remaining with Rice adaptation; a flush
// emits one coefficient event per step. One bin or one flush per lane per
// step, so the event plane [step, lane] and the debug plane equal the
// Pallas kernel's and the plain version's (heif_tpu_torch/ops/cabac_gen.py)
// step for step. The registers keep the Pallas register map
// (pallas_cabac_gen.py:217-224; `r[i]` below).
//
// What bounds it: the longest lane's chain of steps. A step is a bin
// (cabac_engine.cuh), then the phase's state update and the next
// request's derivation, each needing the bin before; the bytes moved are
// tiny. A lane's warp issues every instruction of its step in order,
// nearly alone on its scheduler, so the step's length counts too.
//
// What the design does about that:
// - A warp carries one substream and all its threads run the same step,
//   so the phase switch and the chained entries (TU body -> subblock
//   entry -> greater1 -> sign -> remaining -> flush -> next subblock, in
//   the Pallas kernel's order) never diverge; the 768 substreams of a
//   48-tile image are 768 one-warp blocks over all SMs, the longest
//   first.
// - Every lookup on the chain is in shared memory: the spec table (int4
//   rows), the subblock and 4x4 scans, the lane's contexts and the levels
//   of its current subblock; sig4 is two registers. Each table has a 0
//   row where an out-of-range index lands, so no lookup branches.
// - No load on the chain: steps run in blocks of 32, and before a block
//   the warp slides its shared-memory rings of stream words and envelope
//   tape (cabac_engine.cuh); the tape entry after the current one is held
//   before it is needed; the block's event and debug words are stored
//   after it, 32 in one instruction each.
// - A finished lane stops: at a KIND_PAD envelope entry in P_TAPE nothing
//   moves any more, so the lane writes the constant rest of its planes
//   (event 0, the same debug word) in a store loop and ends.

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
// index, inv = scan index by ys*8+xs; 4x4 scans [scan*16 + key] likewise
// (in shared memory, each followed by a 0 entry); the 4x4 sig ctxIdxMap 4
// bits an entry (entries 0-7, 8-15)
constexpr int N_SB = 768, N_CO = 48;
constexpr int SB_FWD = 0, SB_INV = N_SB + 1, CO_FWD = 2 * (N_SB + 1);
constexpr int CO_INV = CO_FWD + N_CO + 1, SCAN_WORDS = CO_INV + N_CO + 1;
struct Scans {
  const int32_t *sb_fwd, *sb_inv, *co_fwd, *co_inv;
  int32_t sig4_lo, sig4_hi;
};
// a lane's levels of its current subblock: 16, a row that stays 0 (read
// for a position past 15) and a scratch row (written for one)
constexpr int LV_ZERO = 16, LV_SCRATCH = 17, LV_ROWS = 18;

// table[idx] of an n-entry table followed by a 0 entry: 0 outside [0, n)
// (the Pallas masked lookup)
__device__ __forceinline__ int32_t lut(const int32_t* tab, int n, int idx) {
  return tab[min((unsigned)idx, (unsigned)n)];
}

// index of the highest set bit of x (16-bit values); -1 when x <= 0
__device__ __forceinline__ int msb16(int32_t x) {
  return x > 0 ? 31 - __clz(min(x, 0xFFFF)) : -1;
}

__device__ __forceinline__ int32_t popcount16(int32_t v) {
  return __popc((uint32_t)v & 0xFFFFu);
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
__device__ __forceinline__ int sig_slot(const Lane& g, const Desc& d,
                                        const Scans& T) {
  const int xs = g.sbxy & 255, ys = (g.sbxy >> 8) & 255;
  const int32_t xy = lut(T.co_fwd, N_CO, d.scan * 16 + max(g.posn, 0));
  const int xp = xy & 255, yp = srl(xy, 8) & 255;
  const int xc = (xs << 2) + xp, yc = (ys << 2) + yp;
  const int s4i = (yp << 2) + xp;
  const int sig4 = s4i < 8 ? srl(T.sig4_lo, 4 * s4i) & 15
                           : srl(T.sig4_hi, 4 * (s4i - 8)) & 15;
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
__device__ __forceinline__ bool enter_sb(Lane& g, const Desc& d,
                                         const Scans& T, int i, int& phase) {
  const int32_t fxy = lut(T.sb_fwd, N_SB, d.sb_base + max(i, 0));
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

// One lockstep step: request -> bin -> state update. entry is the
// envelope tape's row g.tptr. Returns the event word; dbg gets
// kind | slot<<3 | bin<<12 | phase<<16.
template <class Ctx, class Lv, class Col>
__device__ __forceinline__ int32_t gen_step(Lane& g, const Ctx& ctx,
                                            const Lv& lv, const int4* tbl4,
                                            const Scans& T, Col& words,
                                            int32_t entry, int s_env,
                                            int32_t& dbg) {
  const int phase = g.phase;
  int desc = g.desc;
  int cnt = g.cnt;
  int phase_rq = phase;
  int kind = KIND_PAD, slot = 0, e_kind = KIND_PAD;
  bool tu_now = false;

  // ---------- request resolution ----------
  if (phase == P_TAPE) {
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
      slot = sig_slot(g, d, T);
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

  int c_new;
  const int b = decode_bin(g.e, kind, ctx_read(ctx, slot), tbl4, words, c_new);
  ctx_write(ctx, kind, slot, c_new);
  dbg = kind | shl(slot, 3) | (b << 12) | (phase << 16);

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
      const int32_t stored = lv.get(min(n, LV_ZERO));
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
    g.lastsb = lut(T.sb_inv, N_SB,
                   wadd(d.sb_base, wadd(shl(srl(ly, 2), 3), srl(lx, 2))));
    g.lastpos = lut(T.co_inv, N_CO, d.scan * 16 + ((ly & 3) << 2) + (lx & 3));
    g.csl = g.csh = 0;
    g.prevg1 = -1;
    if (enter_sb(g, d, T, g.lastsb, ph)) g1_entry = true;
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
    lv.set(n < 16 ? n : LV_SCRATCH, level);
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
      enter_sb(g, d, T, nexti, ph);
  }
  g.phase = ph;
  g.cnt = cnt;
  return ev;
}

// DEBUG: write the debug plane (the decode runs without it)
template <bool DEBUG>
__global__ void __launch_bounds__(32)
gen_kernel(int32_t* __restrict__ events, int32_t* __restrict__ dbg,
           int32_t* __restrict__ state, const int32_t* __restrict__ words,
           const int32_t* __restrict__ tape, const int32_t* __restrict__ c0,
           const int32_t* __restrict__ tbl,
           const int32_t* __restrict__ sb_fwd,
           const int32_t* __restrict__ sb_inv,
           const int32_t* __restrict__ co_fwd,
           const int32_t* __restrict__ co_inv,
           const int32_t* __restrict__ sig4, int n_lanes, int W, int s_env,
           int S) {
  __shared__ int4 tbl4[64];
  __shared__ int32_t scans[SCAN_WORDS];
  __shared__ int32_t ctx_s[CTX_ROWS];
  __shared__ int32_t lv_s[LV_ROWS];
  // the warp's rings: stream words, envelope tape, events, debug words
  __shared__ int32_t rings[2 * RING + 2 * BLOCK];
  block_copy(reinterpret_cast<int32_t*>(tbl4), tbl, 256);
  block_copy(scans + SB_FWD, sb_fwd, N_SB);
  block_copy(scans + SB_INV, sb_inv, N_SB);
  block_copy(scans + CO_FWD, co_fwd, N_CO);
  block_copy(scans + CO_INV, co_inv, N_CO);
  if (threadIdx.x == 0)
    scans[SB_INV - 1] = scans[CO_FWD - 1] = scans[CO_INV - 1] =
        scans[SCAN_WORDS - 1] = 0;
  __syncthreads();
  const int lane = threadIdx.x;
  const Scans T = {scans + SB_FWD, scans + SB_INV, scans + CO_FWD,
                   scans + CO_INV, __ldg(sig4), __ldg(sig4 + 1)};
  // warps take the lanes from the last (the batches are sorted by length)
  const int gl = n_lanes - 1 - blockIdx.x;
  const size_t b = gl / LANES;
  const int col = gl % LANES;
  const WarpCtx ctx{ctx_s}, lv{lv_s};
  for (int s = lane; s < LV_ROWS; s += 32) lv.set_own(s, 0);
  load_contexts(ctx, c0 + b * N_CTX * LANES + col, lane);

  WarpRing wc, env;
  wc.init(words + b * (size_t)W * LANES + col, W, lane, rings);
  env.init(tape + b * (size_t)s_env * LANES + col, s_env, lane, rings + RING);
  const size_t base = b * (size_t)S * LANES + col;
  WarpOut ev_out, dbg_out;
  ev_out.init(events + base, lane, rings + 2 * RING);
  dbg_out.init(dbg ? dbg + base : nullptr, lane, rings + 2 * RING + BLOCK);
  Lane g = {};
  engine_start(g.e, wc, 0);
  g.phase = P_TAPE;
  int32_t entry = env.get(0), entry_next = env.get(1);  // rows tptr, tptr+1
  int t = 0;
  bool finished = false;
  for (int t0 = 0; t0 < S && !finished; t0 += BLOCK) {
    const int m = min(BLOCK, S - t0);
    // a step moves tptr by at most 1
    env.advance(g.tptr + 1 + BLOCK);
    wc.advance(block_last_word(g.e.wi));
    for (; t < t0 + m; ++t) {
      finished = g.phase == P_TAPE && (entry & 7) == KIND_PAD;
      if (finished) break;
      const int tptr = g.tptr;
      int32_t d;
      ev_out.put(t, gen_step(g, ctx, lv, tbl4, T, wc, entry, s_env, d));
      if (DEBUG) dbg_out.put(t, d);
      if (g.tptr != tptr) {
        entry = entry_next;
        entry_next = env.get(g.tptr + 1);
      }
    }
    ev_out.store(t0, t - t0);
    dbg_out.store(t0, t - t0);
  }
  // a finished lane's every later step: no move, event 0, the PAD
  // request's debug word (bin = the terminate comparison)
  const int bin = g.e.off >= wsub(g.e.rng, 2);
  ev_out.fill(t, S, 0);
  dbg_out.fill(t, S, KIND_PAD | shl(srl(entry, 3), 3) | (bin << 12) |
                         (P_TAPE << 16));
  store_contexts(ctx, state + b * N_CTX * LANES + col, lane);
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
  auto kernel = dbg ? gen_kernel<true> : gen_kernel<false>;
  if (B > 0)
    kernel<<<B * LANES, 32, 0, stream>>>(
        events, dbg, state, words, tape, c0, tbl, sb_fwd, sb_inv, co_fwd,
        co_inv, sig4, B * LANES, W, s_env, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
