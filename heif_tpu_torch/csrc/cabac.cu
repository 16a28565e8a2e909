// CABAC tape replay for Hopper: one substream per thread.
//
// Replaces the TPU Pallas kernels heif_tpu/ops/pallas_cabac.py `_kernel`
// (launched by `_replay_call` / `cabac_replay_batches`) and
// `_kernel_windowed` (launched by `_windowed_call` /
// `replay_windowed_batch`). Each decodes, per lane, the bins of a
// host-traced (kind, ctx-slot) request tape from the lane's raw bytes and
// initial context state, and returns the bins and the final context
// state (plain PyTorch oracle: heif_tpu_torch/ops/cabac.py).
//
// Design: a 128-thread block is one JAX lane batch and the grid is the
// batch count, so thread = lane = substream. The lane's engine registers
// are thread locals and its 136 context bytes a column of a
// [136][128] shared-memory plane (17 KB a block); every thread touches
// only its own column, so no barrier is needed. The windowed variant is
// the same loop fed from per-block rebased word windows: it re-anchors
// the bit reader at every block boundary from biw0 and unpacks / repacks
// the 4-per-word contexts at entry and exit. (On the TPU the windows
// shrank the per-bin word fetch, an iota-mask reduction over all words;
// here a fetch is one load, so the variant buys nothing and is kept for
// its contract.)
//
// What bounds it: latency. Each bin is a dependent chain (context load ->
// table lookup -> compare -> renormalise -> maybe a word load) with no
// parallelism inside a lane, and the flagship image gives 768 lanes = 6
// blocks for 132 SMs. Bytes moved are tiny (two int32 tape reads and one
// bin write per step). Lanes of a warp read different table rows and
// context slots (constant-cache and bank serialisation) and run
// different tape lengths; more lanes per SM and warp-coherent layouts
// are later work.

#include "cabac_engine.cuh"

namespace {

constexpr int N_CTXP = N_CTX / 4;

__global__ void __launch_bounds__(LANES)
replay_kernel(int32_t* __restrict__ bins, int32_t* __restrict__ state,
              const uint32_t* __restrict__ words,
              const int32_t* __restrict__ c0,
              const int32_t* __restrict__ kinds,
              const int32_t* __restrict__ slots, int W, int S) {
  __shared__ uint8_t ctx_plane[N_CTX * LANES];
  const int lane = threadIdx.x;
  const size_t b = blockIdx.x;
  uint8_t* ctx = ctx_plane + lane;
  const int32_t* c0b = c0 + b * N_CTX * LANES + lane;
  for (int s = 0; s < N_CTX; ++s) ctx[s * LANES] = (uint8_t)c0b[s * LANES];

  const uint32_t* col = words + b * (size_t)W * LANES + lane;
  Engine e;
  engine_start(e, col, W, 0);
  const size_t base = b * (size_t)S * LANES + lane;
  for (int t = 0; t < S; ++t) {
    const size_t i = base + (size_t)t * LANES;
    bins[i] = decode_bin(e, kinds[i], slots[i], ctx, col, W);
  }
  int32_t* out = state + b * N_CTX * LANES + lane;
  for (int s = 0; s < N_CTX; ++s) out[s * LANES] = ctx[s * LANES];
}

__global__ void __launch_bounds__(LANES)
windowed_kernel(int32_t* __restrict__ bins, int32_t* __restrict__ state,
                const uint32_t* __restrict__ windows,
                const int32_t* __restrict__ biw0,
                const int32_t* __restrict__ c0p,
                const int32_t* __restrict__ kinds,
                const int32_t* __restrict__ slots, int nb, int w_blk,
                int blk) {
  __shared__ uint8_t ctx_plane[N_CTX * LANES];
  const int lane = threadIdx.x;
  const size_t b = blockIdx.x;
  uint8_t* ctx = ctx_plane + lane;
  const int32_t* cp = c0p + b * N_CTXP * LANES + lane;
  for (int r = 0; r < N_CTXP; ++r) {
    const uint32_t w = (uint32_t)cp[r * LANES];
    for (int j = 0; j < 4; ++j)
      ctx[(4 * r + j) * LANES] = (uint8_t)((w >> (8 * j)) & 127);
  }

  const size_t S = (size_t)nb * blk;
  Engine e;
  for (int k = 0; k < nb; ++k) {
    const size_t wk = b * nb + k;
    const uint32_t* col = windows + wk * w_blk * LANES + lane;
    const int bw = biw0[wk * LANES + lane];
    if (k == 0)
      engine_start(e, col, w_blk, bw);
    else
      rebase(e, col, w_blk, bw);  // range and offset carry over
    for (int j = 0; j < blk; ++j) {
      const size_t i = (b * S + (size_t)k * blk + j) * LANES + lane;
      bins[i] = decode_bin(e, kinds[i], slots[i], ctx, col, w_blk);
    }
  }
  int32_t* out = state + b * N_CTXP * LANES + lane;
  for (int r = 0; r < N_CTXP; ++r) {
    uint32_t w = 0;
    for (int j = 0; j < 4; ++j)
      w |= (uint32_t)ctx[(4 * r + j) * LANES] << (8 * j);
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
  cudaError_t err = upload_tbl(tbl, stream);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    replay_kernel<<<B, LANES, 0, stream>>>(
        bins, state, reinterpret_cast<const uint32_t*>(words), c0, kinds,
        slots, W, S);
  return (int)cudaGetLastError();
}

// bins [B,nb*blk,128], state [B,34,128] <- windows [B,nb,w_blk,128],
// biw0 [B,nb,128], c0p [B,34,128], kinds / slots [B,nb*blk,128]
int heif_cabac_windowed(int32_t* bins, int32_t* state, const int32_t* windows,
                        const int32_t* biw0, const int32_t* c0p,
                        const int32_t* kinds, const int32_t* slots,
                        const int32_t* tbl, int B, int nb, int w_blk, int blk,
                        cudaStream_t stream) {
  cudaError_t err = upload_tbl(tbl, stream);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    windowed_kernel<<<B, LANES, 0, stream>>>(
        bins, state, reinterpret_cast<const uint32_t*>(windows), biw0, c0p,
        kinds, slots, nb, w_blk, blk);
  return (int)cudaGetLastError();
}

}  // extern "C"
