// CABAC tape replay for Hopper.
//
// Replaces the TPU Pallas kernels heif_tpu/ops/pallas_cabac.py:82
// `_kernel` (launched by `_replay_call`, :223) and :377 `_kernel_windowed`
// (launched by `_windowed_call`, :556). Each decodes, per lane, the bins
// of a host-traced (kind, ctx-slot) request tape from the lane's raw bytes
// and initial context state, and returns the bins and the final context
// state (plain PyTorch oracle: heif_tpu_torch/ops/cabac.py).
//
// What bounds both: the longest lane's chain of steps, one bin a step
// (context value -> table row -> range compare -> renormalise -> bit read
// -> the next step's range and context). The bytes moved are tiny (two
// int32 tape reads and one bin write a step), far below the card's rate.
// A lane's warp is nearly alone on its scheduler, so a step costs its
// dependent chain plus every instruction the warp issues for it, in
// order: both are kept short.
//
// What replay_kernel's design does about that (cabac_engine.cuh):
// - a warp carries one substream, so the 768 substreams of a 48-tile
//   image run as 768 one-warp blocks over all SMs, the longest first;
//   every thread runs the same chain, so nothing diverges, and the warp's
//   threads share the loads and stores;
// - the step is branch-free, its table is in shared memory as int4 rows,
//   and the lane's contexts are a shared-memory column whose zero and
//   scratch rows keep every access unconditional;
// - nothing in a step waits on device memory or branches on its inputs:
//   steps run in blocks of 32; before a block the warp slides its
//   shared-memory rings of stream words and tape codes (each tape row is
//   packed into one code, kind and context row, as it enters the ring),
//   and after it stores the block's 32 bins in one instruction; the next
//   step's code and context value are read before this step's write (the
//   value forwarded when the row repeats).
//
// windowed_kernel is the same design over per-window word columns: the
// bit reader re-anchors at each window's start (biw0), and the contexts
// come packed 4 to a word. While a warp runs window k, window k + 1's
// first ring rows and its biw0 come into a second shared-memory buffer by
// asynchronous copies (cp.async), so no bin waits on device memory at a
// window's start; a 32-step block never crosses a window's end. The packed words are unpacked into
// the context rows at entry and repacked at exit, each byte's bit 7 (which
// no step reads or writes) kept aside in a register, as the Pallas kernel
// keeps it in its word.

#include "cabac_engine.cuh"

namespace {

constexpr int N_CTXP = N_CTX / 4;

// a tape row as one code: the kind (KIND_PAD for any kind outside 0..2)
// and the context row its slot reads (ctx_row)
__device__ __forceinline__ int32_t tape_code(int32_t kind, int32_t slot) {
  return ((unsigned)kind < 3u ? kind : KIND_PAD) | (ctx_row(slot) << 2);
}

// A lane's tape read by the warp that carries it: codes through a
// RING-row shared-memory ring that advance slides as WarpRing's does (the
// raw kind and slot are loaded a slide ahead and packed when stored).
struct WarpTape {
  int32_t* ring;
  const int32_t *kc, *sc;
  int n, lane, base;
  int32_t sk, ss;  // kind and slot of row base + RING + lane
  __device__ void init(const int32_t* kinds, const int32_t* slots, int rows,
                       int ln, int32_t* r) {
    kc = kinds;
    sc = slots;
    n = rows;
    lane = ln;
    ring = r;
    base = 0;
    for (int k = lane; k < RING; k += 32)
      ring[k] = tape_code(load_row(kc, n, k), load_row(sc, n, k));
    sk = load_row(kc, n, RING + lane);
    ss = load_row(sc, n, RING + lane);
    __syncwarp();
  }
  __device__ void advance(int kmax) {
    while (kmax >= base + RING) {
      ring[(base + lane) & (RING - 1)] = tape_code(sk, ss);
      __syncwarp();
      sk = load_row(kc, n, base + RING + 32 + lane);
      ss = load_row(sc, n, base + RING + 32 + lane);
      base += 32;
    }
  }
  // the code of row k
  __device__ int32_t get(int k) const { return ring[k & (RING - 1)]; }
};

__global__ void __launch_bounds__(32)
replay_kernel(int32_t* __restrict__ bins, int32_t* __restrict__ state,
              const int32_t* __restrict__ words,
              const int32_t* __restrict__ c0,
              const int32_t* __restrict__ kinds,
              const int32_t* __restrict__ slots,
              const int32_t* __restrict__ tbl, int n_lanes, int W, int S) {
  __shared__ int4 tbl4[64];
  __shared__ int32_t ctx_s[CTX_ROWS];
  // the warp's rings: stream words, tape codes, bins
  __shared__ int32_t rings[2 * RING + BLOCK];
  block_copy(reinterpret_cast<int32_t*>(tbl4), tbl, 256);
  __syncthreads();
  const int lane = threadIdx.x;
  // warps take the lanes from the last (the batches are sorted by length)
  const int g = n_lanes - 1 - blockIdx.x;
  const size_t b = g / LANES;
  const int col = g % LANES;
  const WarpCtx ctx{ctx_s};
  load_contexts(ctx, c0 + b * N_CTX * LANES + col, lane);

  WarpRing wc;
  wc.init(words + b * (size_t)W * LANES + col, W, lane, rings);
  WarpTape tape;
  const size_t base = b * (size_t)S * LANES + col;
  tape.init(kinds + base, slots + base, S, lane, rings + RING);
  WarpOut out;
  out.init(bins + base, lane, rings + 2 * RING);
  Engine e;
  engine_start(e, wc, 0);

  int code = tape.get(0);
  int c = ctx.get(code >> 2);
  for (int t0 = 0; t0 < S; t0 += BLOCK) {
    const int m = min(BLOCK, S - t0);
    tape.advance(t0 + BLOCK);
    wc.advance(block_last_word(e.wi));
#pragma unroll 4
    for (int t = t0; t < t0 + m; ++t) {
      // the next request and its context value, read before this step
      // writes (row S reads 0 and is never used)
      const int ncode = tape.get(t + 1);
      const int kind = code & 3, nrow = ncode >> 2;
      const int nc = ctx.get(nrow);
      int c_new;
      out.put(t, decode_bin(e, kind, c, tbl4, wc, c_new));
      const int wrow = ctx_wrow(kind, code >> 2);
      ctx.set(wrow, c_new);
      code = ncode;
      c = nrow == wrow ? c_new : nc;
    }
    out.store(t0, m);
  }
  store_contexts(ctx, state + b * N_CTX * LANES + col, lane);
}

// Copy one int32 from device memory into shared memory asynchronously
// (cp.async: no register holds it, so nothing waits for it until
// async_wait). A row that is not valid is filled with 0 and src is not
// read.
__device__ __forceinline__ void copy_row_async(int32_t* dst, const int32_t* src,
                                               bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
// wait for this thread's asynchronous copies
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows of a window's buffer: the ring's RING, the next slide's 32, biw0
constexpr int WIN_BUF = RING + 32 + 1;

// A lane's word windows read by the warp that carries it. Window k is read
// through a WarpRing over its w_blk rows (rows past them read 0). Its
// first RING + 32 rows and its biw0 reached a spare shared-memory buffer
// through asynchronous copies started at window k - 1's start; next() swaps
// that buffer in and starts window k + 1's copies into the one it frees.
// So the bit reader re-anchors at a window's start from shared memory, and
// no bin waits on a device-memory load there.
struct WindowRing {
  WarpRing ring;
  int32_t* spare;           // WIN_BUF words: the next window's rows, biw0
  const int32_t *win, *bw;  // the lane's windows and biw0 (stride LANES)
  int nb, w_blk, k;         // k: the window in the ring
  // window 0 in the ring (its rows loaded now, into buf), window 1 on its
  // way to buf + WIN_BUF; returns window 0's biw0
  __device__ int init(const int32_t* windows, const int32_t* biw0, int n_win,
                      int rows, int lane, int32_t* buf) {
    win = windows;
    bw = biw0;
    nb = n_win;
    w_blk = rows;
    k = 0;
    ring.init(win, w_blk, lane, buf);
    spare = buf + WIN_BUF;
    fetch(1);
    return __ldg(bw);
  }
  // window j's first RING + 32 rows and its biw0 -> spare (none past the
  // last window)
  __device__ void fetch(int j) {
    if (j >= nb) return;
    const int32_t* c = win + (size_t)j * w_blk * LANES;
    for (int r = ring.lane; r < RING + 32; r += 32) {
      const bool v = r < w_blk;
      copy_row_async(spare + r, v ? c + (size_t)r * LANES : bw, v);
    }
    if (ring.lane == 0) copy_row_async(spare + RING + 32, bw + (size_t)j * LANES, true);
  }
  // window k + 1 into the ring, window k + 2 on its way; returns the new
  // window's biw0
  __device__ int next() {
    ++k;
    async_wait();
    __syncwarp();  // the copies are visible to every thread, and every
                   // thread is done with the old window's rows
    int32_t* buf = spare;
    spare = ring.ring;
    ring.ring = buf;
    ring.col = win + (size_t)k * w_blk * LANES;
    ring.base = 0;
    ring.staged = buf[RING + ring.lane];
    const int bk = buf[RING + 32];
    fetch(k + 1);
    return bk;
  }
};

__global__ void __launch_bounds__(32)
windowed_kernel(int32_t* __restrict__ bins, int32_t* __restrict__ state,
                const int32_t* __restrict__ windows,
                const int32_t* __restrict__ biw0,
                const int32_t* __restrict__ c0p,
                const int32_t* __restrict__ kinds,
                const int32_t* __restrict__ slots,
                const int32_t* __restrict__ tbl, int n_lanes, int nb,
                int w_blk, int blk) {
  __shared__ int4 tbl4[64];
  __shared__ int32_t ctx_s[CTX_ROWS];
  // the warp's rings: two window buffers (the window read, the next one
  // arriving), tape codes, bins
  __shared__ int32_t rings[2 * WIN_BUF + RING + BLOCK];
  block_copy(reinterpret_cast<int32_t*>(tbl4), tbl, 256);
  __syncthreads();
  const int lane = threadIdx.x;
  // warps take the lanes from the last (the batches are sorted by length)
  const int g = n_lanes - 1 - blockIdx.x;
  const size_t b = g / LANES;
  const int col = g % LANES;
  const WarpCtx ctx{ctx_s};
  // packed context word r (a thread a word) -> rows 4r..4r+3, 7 bits each;
  // bit 7 of its bytes, which no step reads or writes, stays in a register
  const int32_t* cp = c0p + b * N_CTXP * LANES + col;
  uint32_t hi[2];
  for (int i = 0; i < 2; ++i) {
    const int r = lane + 32 * i;
    const uint32_t w = r < N_CTXP ? (uint32_t)__ldg(cp + r * LANES) : 0u;
    hi[i] = w & 0x80808080u;
    if (r < N_CTXP)
      for (int j = 0; j < 4; ++j) ctx.set_own(4 * r + j, (w >> (8 * j)) & 127);
  }
  if (lane == 0) ctx.set_own(CTX_ZERO, 0);
  __syncwarp();

  const int S = nb * blk;
  WindowRing wr;
  const int bw0 = wr.init(windows + b * nb * (size_t)w_blk * LANES + col,
                          biw0 + b * nb * LANES + col, nb, w_blk, lane, rings);
  WarpTape tape;
  const size_t base = b * (size_t)S * LANES + col;
  tape.init(kinds + base, slots + base, S, lane, rings + 2 * WIN_BUF);
  WarpOut out;
  out.init(bins + base, lane, rings + 2 * WIN_BUF + RING);
  Engine e;
  engine_start(e, wr.ring, bw0);

  int code = tape.get(0);
  int c = ctx.get(code >> 2);
  for (int k = 0; k < nb; ++k) {
    if (k > 0) rebase(e, wr.ring, wr.next());  // range and offset carry over
    // blocks of at most BLOCK steps, none past the window's end
    const int t1 = (k + 1) * blk;
    for (int t0 = k * blk; t0 < t1; t0 += BLOCK) {
      const int m = min(BLOCK, t1 - t0);
      tape.advance(t0 + BLOCK);
      wr.ring.advance(block_last_word(e.wi));
#pragma unroll 4
      for (int t = t0; t < t0 + m; ++t) {
        // as in replay_kernel (row S reads 0 and is never used)
        const int ncode = tape.get(t + 1);
        const int kind = code & 3, nrow = ncode >> 2;
        const int nc = ctx.get(nrow);
        int c_new;
        out.put(t, decode_bin(e, kind, c, tbl4, wr.ring, c_new));
        const int wrow = ctx_wrow(kind, code >> 2);
        ctx.set(wrow, c_new);
        code = ncode;
        c = nrow == wrow ? c_new : nc;
      }
      out.store(t0, m);
    }
  }
  // rows 4r..4r+3 -> packed word r, with its bit 7s back
  __syncwarp();
  int32_t* sp = state + b * N_CTXP * LANES + col;
  for (int i = 0; i < 2; ++i) {
    const int r = lane + 32 * i;
    if (r < N_CTXP) {
      uint32_t w = hi[i];
      for (int j = 0; j < 4; ++j) w |= (uint32_t)ctx.get(4 * r + j) << (8 * j);
      sp[r * LANES] = (int32_t)w;
    }
  }
}

}  // namespace

extern "C" {

// bins [B,S,128], state [B,136,128] <- words [B,W,128], c0 [B,136,128],
// kinds / slots [B,S,128]; tbl: the 256-entry table on the device
int heif_cabac_replay(int32_t* bins, int32_t* state, const int32_t* words,
                      const int32_t* c0, const int32_t* kinds,
                      const int32_t* slots, const int32_t* tbl, int B, int W,
                      int S, cudaStream_t stream) {
  if (B > 0)
    replay_kernel<<<B * LANES, 32, 0, stream>>>(
        bins, state, words, c0, kinds, slots, tbl, B * LANES, W, S);
  return (int)cudaGetLastError();
}

// bins [B,nb*blk,128], state [B,34,128] <- windows [B,nb,w_blk,128],
// biw0 [B,nb,128], c0p [B,34,128], kinds / slots [B,nb*blk,128]
int heif_cabac_windowed(int32_t* bins, int32_t* state, const int32_t* windows,
                        const int32_t* biw0, const int32_t* c0p,
                        const int32_t* kinds, const int32_t* slots,
                        const int32_t* tbl, int B, int nb, int w_blk, int blk,
                        cudaStream_t stream) {
  if (B > 0)
    windowed_kernel<<<B * LANES, 32, 0, stream>>>(bins, state, windows, biw0,
                                                  c0p, kinds, slots, tbl,
                                                  B * LANES, nb, w_blk, blk);
  return (int)cudaGetLastError();
}

}  // extern "C"
