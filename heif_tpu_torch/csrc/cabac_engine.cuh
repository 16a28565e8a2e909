// CABAC arithmetic decoder (H.265 §9.3.4.3) and the per-lane memory
// access that the replay, windowed-replay and residual-generator kernels
// (cabac.cu, cabac_gen.cu) share.
//
// The bin step is that of the TPU Pallas kernels
// heif_tpu/ops/pallas_cabac.py `_kernel` / `_kernel_windowed` and
// heif_tpu/ops/pallas_cabac_gen.py `_kernel`, bit for bit. Like theirs it
// is branch-free: the context, bypass and terminate paths are all
// computed and the request kind selects, so lanes a warp carries side by
// side never diverge on it. A kernel's time is its longest lane's chain
// of such steps, so what a step reads sits off that chain:
// - the caller reads the request slot's context value and writes the new
//   one, so a kernel that knows the next slot can read it a step early;
// - the spec table is 64 int4 rows in shared memory (p -> the four q
//   entries), loaded as soon as p is known, before the range is;
// - the bit reader is a three-word funnel (cur, nxt, nx2) read with
//   funnel shifts. Crossing a word boundary shifts it and takes word
//   wi+2, which is read only 32 bits later, so no bin waits on a fetch;
// - a lane's contexts have two more rows: CTX_ZERO stays 0 and a slot
//   outside [0, N_CTX) reads it; a step that writes no slot writes its
//   value to CTX_SCRATCH. So no context access branches.
//
// Where a lane's values come from and go to (WarpRing, WarpOut, WarpCtx):
// a warp carries the lane, every thread running the same chain. Steps run
// in blocks of BLOCK. Before a block the warp slides each input's 64-row
// shared-memory ring by 32 rows if the block may need them, storing the
// rows it loaded at the slide before and loading the next 32, one a
// thread; so a row is loaded a block or more before it is read, and a
// step reads it with one shared-memory load. Outputs go to a 32-row ring
// that the warp stores after the block. No step branches on either. The
// lane's contexts are a shared-memory column the warp's threads load and
// store together (load_contexts, store_contexts).
//
// Contract points the Pallas kernels fix and this code keeps:
// - words are big-endian bytes packed 4 to an int32, read with logical
//   shifts (uint32 here);
// - a word fetched past the end of the lane's words reads 0, as the
//   masked fetch does;
// - a context slot outside [0, N_CTX) reads 0 and is not written;
// - a KIND_PAD step (or any other kind) moves nothing and outputs
//   bin = (off >= rng - 2), the terminate comparison;
// - arithmetic wraps at 32 bits and comparisons are signed int32, as in
//   XLA; a shift past 31 gives 0.
//
// Context values are p | mps<<6 (7 bits), as the host packers build them.
// The windowed replay's packed bytes carry an 8th bit that no step reads
// or writes: the kernel keeps it aside (cabac.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int N_CTX = 136;
constexpr int CTX_ZERO = N_CTX;         // stays 0: read for a bad slot
constexpr int CTX_SCRATCH = N_CTX + 1;  // written by a step that writes none
constexpr int CTX_ROWS = N_CTX + 2;
constexpr int KIND_CTX = 0;
constexpr int KIND_BYPASS = 1;
constexpr int KIND_TERMINATE = 2;
constexpr int KIND_PAD = 3;
constexpr int RING = 64;  // rows of a warp's input ring

// x << n and logical x >> n, 0 for a shift outside [0, 32) (XLA's rule;
// C++ leaves it undefined)
__device__ __forceinline__ int32_t shl(int32_t x, int n) {
  return (unsigned)n < 32u ? (int32_t)((uint32_t)x << n) : 0;
}
__device__ __forceinline__ int32_t srl(int32_t x, int n) {
  return (unsigned)n < 32u ? (int32_t)((uint32_t)x >> n) : 0;
}
__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

// the context row slot s reads: s, or CTX_ZERO outside [0, N_CTX)
__device__ __forceinline__ int ctx_row(int s) {
  return (int)min((unsigned)s, (unsigned)CTX_ZERO);
}
// the row a step of `kind` on context row `row` writes its new value to
__device__ __forceinline__ int ctx_wrow(int kind, int row) {
  return kind == KIND_CTX && row != CTX_ZERO ? row : CTX_SCRATCH;
}

// rows of a lane's column (stride LANES) past n read 0
__device__ __forceinline__ int32_t load_row(const int32_t* col, int n, int k) {
  return (unsigned)k < (unsigned)n ? __ldg(col + (size_t)k * LANES) : 0;
}

// Steps run in blocks of BLOCK: a warp's rings are refilled, and its
// outputs stored, once a block, so no step branches on them.
constexpr int BLOCK = 32;
// the last stream word a block of steps may read: a step reads at most 9
// bits, and the funnel holds words wi..wi+2
__device__ __forceinline__ int block_last_word(int wi) {
  return wi + 2 + (BLOCK * 9 + 31) / 32;
}

// One lane's column read by the warp that carries it, through a RING-row
// ring in the warp's shared memory holding rows [base, base + RING).
// advance(kmax), before a block, slides the ring until it holds kmax; the
// block then reads rows above kmax - BLOCK only, every thread the same.
struct WarpRing {
  int32_t* ring;
  const int32_t* col;
  int n, lane, base;
  int32_t staged;  // row base + RING + lane, loaded for the next slide
  __device__ void init(const int32_t* c, int rows, int ln, int32_t* r) {
    col = c;
    n = rows;
    lane = ln;
    ring = r;
    base = 0;
    ring[lane] = load_row(col, n, lane);
    ring[32 + lane] = load_row(col, n, 32 + lane);
    staged = load_row(col, n, RING + lane);
    __syncwarp();
  }
  __device__ void advance(int kmax) {
    while (kmax >= base + RING) {
      // rows [base, base + 32) are done: their half takes the staged rows
      ring[(base + lane) & (RING - 1)] = staged;
      __syncwarp();
      staged = load_row(col, n, base + RING + 32 + lane);
      base += 32;
    }
  }
  __device__ int32_t get(int k) const { return ring[k & (RING - 1)]; }
};

// One lane's column of an int32 [steps][LANES] output plane, written once
// a step in order (a null plane is not written) by the warp that carries
// the lane: step t of a block goes to row t % BLOCK of the warp's ring,
// and the warp stores the block, one row a thread, in one instruction.
struct WarpOut {
  int32_t* ring;
  int32_t* col;
  int lane;
  __device__ void init(int32_t* c, int ln, int32_t* r) {
    col = c;
    lane = ln;
    ring = r;
  }
  __device__ void put(int t, int32_t v) { ring[t & (BLOCK - 1)] = v; }
  // store steps [t0, t0 + m) of a block (t0 need not be a multiple of
  // BLOCK: the windowed replay's blocks start at its windows' starts)
  __device__ void store(int t0, int m) {
    if (!col) return;
    __syncwarp();
    const int t = t0 + lane;
    if (lane < m) col[(size_t)t * LANES] = ring[t & (BLOCK - 1)];
    __syncwarp();
  }
  // steps [t, n) all equal v
  __device__ void fill(int t, int n, int32_t v) {
    if (col)
      for (int k = t + lane; k < n; k += 32) col[(size_t)k * LANES] = v;
  }
};

// A lane's context rows in the shared memory of the warp that carries it,
// every thread reading and writing the same word; a write first waits for
// the warp, so no thread overwrites a word another has yet to read.
struct WarpCtx {
  int32_t* p;
  __device__ int get(int s) const { return p[s]; }
  __device__ void set(int s, int v) const {
    __syncwarp();
    p[s] = v;
  }
  // a write of a row that this thread alone writes (no wait)
  __device__ void set_own(int s, int v) const { p[s] = v; }
};

// a warp's lane's context rows from its c0 column (stride LANES): the
// N_CTX slots, CTX_ZERO = 0, a row a thread
__device__ __forceinline__ void load_contexts(const WarpCtx& ctx,
                                              const int32_t* c0c, int lane) {
  for (int s = lane; s <= CTX_ZERO; s += 32)
    ctx.set_own(s, s < N_CTX ? c0c[s * LANES] : 0);
  __syncwarp();
}

// the lane's N_CTX final contexts into its state column (stride LANES)
__device__ __forceinline__ void store_contexts(const WarpCtx& ctx,
                                               int32_t* outc, int lane) {
  __syncwarp();
  for (int s = lane; s < N_CTX; s += 32) outc[s * LANES] = ctx.get(s);
}

// copy n int32 from device memory into shared memory, the whole block
__device__ __forceinline__ void block_copy(int32_t* dst, const int32_t* src,
                                           int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
}

struct Engine {
  int32_t rng, off;        // ivlCurrRange, ivlOffset
  int wi, biw;             // word index, bit within word (0..31)
  uint32_t cur, nxt, nx2;  // the funnel: words wi, wi+1, wi+2
};

// consume n (0..9) bits MSB-first from the funnel
__device__ __forceinline__ int32_t read_bits(Engine& e, WarpRing& words,
                                             int n) {
  // the 32 bits from the read position, then their first n (0 for n = 0)
  const uint32_t top = __funnelshift_l(e.nxt, e.cur, e.biw);
  const int32_t v = (int32_t)__funnelshift_l(top, 0u, n);
  e.biw += n;
  if (e.biw >= 32) {
    e.biw -= 32;
    e.wi += 1;
    e.cur = e.nxt;
    e.nxt = e.nx2;
    e.nx2 = (uint32_t)words.get(e.wi + 2);
  }
  return v;
}

// anchor the bit reader at bit biw of word 0 of a (new) word column
__device__ __forceinline__ void rebase(Engine& e, WarpRing& words, int biw) {
  e.wi = 0;
  e.biw = biw;
  e.cur = (uint32_t)words.get(0);
  e.nxt = (uint32_t)words.get(1);
  e.nx2 = (uint32_t)words.get(2);
}

// engine start (§9.3.4.3.1): range 510, offset = the first 9 bits
__device__ __forceinline__ void engine_start(Engine& e, WarpRing& words,
                                             int biw) {
  rebase(e, words, biw);
  e.rng = 510;
  e.off = read_bits(e, words, 9);
}

// renormalisation shift of a range: (r < 256) + (r < 128) + ... + (r < 4)
__device__ __forceinline__ int renorm_shift(int32_t r) {
  return min(max(__clz(max(r, 0)) - 23, 0), 7);
}

// The context value of slot s (0 outside [0, N_CTX)) and the write of
// a step's new value (to CTX_SCRATCH unless a KIND_CTX step on a slot
// inside [0, N_CTX)).
__device__ __forceinline__ int ctx_read(const WarpCtx& ctx, int s) {
  return ctx.get(ctx_row(s));
}
__device__ __forceinline__ void ctx_write(const WarpCtx& ctx, int kind, int s,
                                          int v) {
  ctx.set(ctx_wrow(kind, ctx_row(s)), v);
}

// Decode one bin of request `kind` on context value c (the request
// slot's value, 0 for a slot outside [0, N_CTX)). Returns the bin; c_new
// is the slot's next value, which counts only for a KIND_CTX request on
// a slot inside [0, N_CTX) (ctx_write).
__device__ __forceinline__ int decode_bin(Engine& e, int kind, int c,
                                          const int4* tbl4, WarpRing& words,
                                          int& c_new) {
  const int p = c & 63, mps = srl(c, 6);
  // context path (§9.3.4.3.2)
  const int4 row = tbl4[p];
  const int q = (e.rng >> 6) & 3;
  const int32_t packed = q < 2 ? (q ? row.y : row.x) : (q == 2 ? row.z : row.w);
  const int32_t lps = (packed >> 16) & 255;
  const int32_t rng2 = wsub(e.rng, lps);
  const bool is_lps = e.off >= rng2;
  const int bin_ctx = is_lps ? 1 - mps : mps;
  const int32_t off_ctx = is_lps ? wsub(e.off, rng2) : e.off;
  const int32_t rng_ctx = is_lps ? lps : rng2;
  c_new = (is_lps ? (packed >> 8) & 255 : packed & 255) |
          ((is_lps && p == 0 ? 1 - mps : mps) << 6);
  // terminate path (§9.3.4.3.5): bin 1 does not renormalise
  const int32_t rng_t = wsub(e.rng, 2);
  const int bin_t = e.off >= rng_t;
  const bool is_ctx = kind == KIND_CTX, is_byp = kind == KIND_BYPASS;
  const bool is_trm = kind == KIND_TERMINATE;
  const int32_t offb = is_ctx ? off_ctx : e.off;
  const int32_t rngf = is_ctx ? rng_ctx : (is_trm ? rng_t : e.rng);
  const int sh = renorm_shift(rngf);
  // bypass reads 1 bit; any other kind (KIND_PAD) reads none and, with
  // n = 0, leaves off and rng as they were. n <= 9, so the shifts below
  // stay inside [0, 32).
  const int n = is_byp ? 1 : (is_trm ? (bin_t ? 0 : sh) : (is_ctx ? sh : 0));
  const int32_t off_sh = (int32_t)((uint32_t)offb << n) | read_bits(e, words, n);
  // bypass (§9.3.4.3.4) compares after the shift-in
  const int bin_b = off_sh >= e.rng;
  const int32_t rng_in = e.rng;
  e.off = is_byp && bin_b ? wsub(off_sh, rng_in) : off_sh;
  e.rng = is_byp ? rng_in : (int32_t)((uint32_t)rngf << n);
  return is_ctx ? bin_ctx : (is_byp ? bin_b : bin_t);
}

}  // namespace
