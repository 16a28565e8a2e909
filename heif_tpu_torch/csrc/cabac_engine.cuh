// CABAC arithmetic decoder (H.265 §9.3.4.3) for one lane, shared by the
// replay, windowed-replay and residual-generator kernels (cabac.cu,
// cabac_gen.cu).
//
// It is the bin step of the TPU Pallas kernels heif_tpu/ops/pallas_cabac.py
// `_kernel` / `_kernel_windowed` and heif_tpu/ops/pallas_cabac_gen.py
// `_kernel`, bit for bit, but not their design. Those run 128 lanes
// branchless and reach per-lane data through iota-mask reductions (TPU
// vector memory has no per-lane gather). Here one thread is one lane:
// the engine registers are thread locals, the request kind picks one
// path with a switch, the lane's context bytes are a column of a
// [N_CTX][LANES] shared-memory plane (lane on the fast axis), the spec
// tables sit in constant memory, and stream words are read from global
// memory with the lane's own index.
//
// Contract points the Pallas kernels fix and this code keeps:
// - words are big-endian bytes packed 4 to an int32, read with logical
//   shifts (uint32 here);
// - a word fetched past the end of the lane's words reads 0, as the
//   masked fetch does (every step fetches word wi+1);
// - a context slot outside [0, N_CTX) reads 0 and is not written;
// - a KIND_PAD step (or any other kind) moves nothing and outputs
//   bin = (off >= rng - 2), the terminate comparison;
// - arithmetic wraps at 32 bits and comparisons are signed int32, as in
//   XLA.
//
// Context bytes hold p | mps<<6 (7 bits), as the host packers build them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int N_CTX = 136;
constexpr int KIND_CTX = 0;
constexpr int KIND_BYPASS = 1;
constexpr int KIND_TERMINATE = 2;
constexpr int KIND_PAD = 3;

// p*4+q -> transIdxMps | transIdxLps<<8 | rangeTabLps<<16 (Tables
// 9-52, 9-53), uploaded by each launcher from the CabacTables buffer
__constant__ int32_t c_tbl[256];

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

struct Engine {
  int32_t rng, off;  // ivlCurrRange, ivlOffset
  int wi, biw;       // word index, bit within word
  uint32_t cur, nxt; // the two-word funnel at wi, wi+1
};

// col[idx * LANES] for 0 <= idx < n, else 0
__device__ __forceinline__ uint32_t fetch(const uint32_t* col, int n,
                                          int idx) {
  return (unsigned)idx < (unsigned)n ? col[(size_t)idx * LANES] : 0u;
}

// consume L (0..9) bits MSB-first from the funnel
__device__ __forceinline__ int32_t read_bits(Engine& e, const uint32_t* col,
                                             int n, int L) {
  uint32_t top = (e.cur << e.biw) | (e.biw > 0 ? e.nxt >> (32 - e.biw) : 0u);
  int32_t v = L > 0 ? (int32_t)(top >> (32 - L)) : 0;
  e.biw += L;
  if (e.biw >= 32) {
    e.biw -= 32;
    e.wi += 1;
    e.cur = e.nxt;
    e.nxt = fetch(col, n, e.wi + 1);
  }
  return v;
}

// anchor the bit reader at bit biw of word 0 of a (new) word window
__device__ __forceinline__ void rebase(Engine& e, const uint32_t* col, int n,
                                       int biw) {
  e.wi = 0;
  e.biw = biw;
  e.cur = fetch(col, n, 0);
  e.nxt = fetch(col, n, 1);
}

// engine start (§9.3.4.3.1): range 510, offset = the first 9 bits
__device__ __forceinline__ void engine_start(Engine& e, const uint32_t* col,
                                             int n, int biw) {
  rebase(e, col, n, biw);
  e.rng = 510;
  e.off = read_bits(e, col, n, 9);
}

// renormalisation shift of a range (rng >= 2 gives 0..7)
__device__ __forceinline__ int renorm_shift(int32_t r) {
  return (r < 256) + (r < 128) + (r < 64) + (r < 32) + (r < 16) + (r < 8) +
         (r < 4);
}

// Decode one bin of request (kind, slot). ctx is this lane's column of
// the context plane (stride LANES).
__device__ __forceinline__ int decode_bin(Engine& e, int kind, int slot,
                                          uint8_t* ctx, const uint32_t* col,
                                          int n) {
  switch (kind) {
    case KIND_CTX: {  // §9.3.4.3.2
      const bool ok = (unsigned)slot < (unsigned)N_CTX;
      const int c = ok ? ctx[slot * LANES] : 0;
      const int p = c & 63, mps = c >> 6;
      const int32_t packed = c_tbl[p * 4 + ((e.rng >> 6) & 3)];
      const int32_t lps = (packed >> 16) & 255;
      const int32_t rng2 = e.rng - lps;
      const bool is_lps = e.off >= rng2;
      const int bin = is_lps ? 1 - mps : mps;
      const int32_t offb = is_lps ? e.off - rng2 : e.off;
      const int32_t rngf = is_lps ? lps : rng2;
      if (ok) {
        const int new_mps = (is_lps && p == 0) ? 1 - mps : mps;
        const int new_p = is_lps ? (packed >> 8) & 255 : packed & 255;
        ctx[slot * LANES] = (uint8_t)(new_p | (new_mps << 6));
      }
      const int L = renorm_shift(rngf);
      const int32_t v = read_bits(e, col, n, L);
      e.off = shl(offb, L) | v;
      e.rng = shl(rngf, L);
      return bin;
    }
    case KIND_BYPASS: {  // §9.3.4.3.4: compare after the shift-in
      const int32_t off_sh = shl(e.off, 1) | read_bits(e, col, n, 1);
      const int bin = off_sh >= e.rng;
      e.off = bin ? (int32_t)((uint32_t)off_sh - (uint32_t)e.rng) : off_sh;
      return bin;
    }
    case KIND_TERMINATE: {  // §9.3.4.3.5: bin 1 does not renormalise
      const int32_t rng_t = e.rng - 2;
      const int bin = e.off >= rng_t;
      const int L = bin ? 0 : renorm_shift(rng_t);
      const int32_t v = read_bits(e, col, n, L);
      e.off = shl(e.off, L) | v;
      e.rng = shl(rng_t, L);
      return bin;
    }
    default:  // KIND_PAD and any other kind: nothing moves
      return e.off >= e.rng - 2;
  }
}

// copy the lane's 256-entry table into constant memory (stream-ordered)
inline cudaError_t upload_tbl(const int32_t* tbl, cudaStream_t stream) {
  return cudaMemcpyToSymbolAsync(c_tbl, tbl, sizeof(c_tbl), 0,
                                 cudaMemcpyDeviceToDevice, stream);
}

}  // namespace
