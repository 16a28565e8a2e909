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
// windowed_kernel carries a substream a thread: a 128-thread block is
// one lane batch, a thread's context bytes a column of a [CTX_ROWS][128]
// shared-memory plane; it reads its tape a step at a time and re-anchors
// the bit reader at every block boundary from biw0, unpacking and
// repacking the 4-per-word contexts at entry and exit. It shares the
// branch-free step, the shared-memory table, the context rows and the
// three-word funnel.

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

__global__ void __launch_bounds__(LANES)
windowed_kernel(int32_t* __restrict__ bins, int32_t* __restrict__ state,
                const int32_t* __restrict__ windows,
                const int32_t* __restrict__ biw0,
                const int32_t* __restrict__ c0p,
                const int32_t* __restrict__ kinds,
                const int32_t* __restrict__ slots,
                const int32_t* __restrict__ tbl, int nb, int w_blk,
                int blk) {
  __shared__ int4 tbl4[64];
  __shared__ uint8_t ctx_plane[CTX_ROWS * LANES];
  block_copy(reinterpret_cast<int32_t*>(tbl4), tbl, 256);
  const int lane = threadIdx.x;
  const size_t b = blockIdx.x;
  const SmemColumn<uint8_t, LANES> ctx{ctx_plane + lane};
  const int32_t* cp = c0p + b * N_CTXP * LANES + lane;
  for (int r = 0; r < N_CTXP; ++r) {
    const uint32_t w = (uint32_t)cp[r * LANES];
    for (int j = 0; j < 4; ++j) ctx.set(4 * r + j, (w >> (8 * j)) & 127);
  }
  ctx.set(CTX_ZERO, 0);
  __syncthreads();  // the table

  const size_t S = (size_t)nb * blk;
  Engine e;
  ThreadColumn wc;
  for (int k = 0; k < nb; ++k) {
    const size_t wk = b * nb + k;
    wc.init(windows + wk * w_blk * LANES + lane, w_blk);
    const int bw = biw0[wk * LANES + lane];
    if (k == 0)
      engine_start(e, wc, bw);
    else
      rebase(e, wc, bw);  // range and offset carry over
    for (int j = 0; j < blk; ++j) {
      const size_t i = (b * S + (size_t)k * blk + j) * LANES + lane;
      const int kind = kinds[i], slot = slots[i];
      int c_new;
      bins[i] = decode_bin(e, kind, ctx_read(ctx, slot), tbl4, wc, c_new);
      ctx_write(ctx, kind, slot, c_new);
    }
  }
  int32_t* out = state + b * N_CTXP * LANES + lane;
  for (int r = 0; r < N_CTXP; ++r) {
    uint32_t w = 0;
    for (int j = 0; j < 4; ++j) w |= (uint32_t)ctx.get(4 * r + j) << (8 * j);
    out[r * LANES] = (int32_t)w;
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
    windowed_kernel<<<B, LANES, 0, stream>>>(bins, state, windows, biw0, c0p,
                                             kinds, slots, tbl, nb, w_blk,
                                             blk);
  return (int)cudaGetLastError();
}

}  // extern "C"
