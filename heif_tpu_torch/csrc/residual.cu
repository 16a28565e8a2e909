// HEVC residual stage (H.265 §8.6.2-§8.6.4) for Hopper: every transform
// class of a batch of tiles dequantised, inverse-transformed and written
// into the residual planes, in one launch.
//
// No Pallas kernel stands behind it. heif_tpu runs this stage as jnp code
// inside `_core` (heif_tpu/ops/batch.py:469-501: jax_recon.residual_class
// at jax_recon.py:173 per (component, size) class, then a row-scatter of
// whole blocks into the planes), which XLA compiles into a few fusions.
// The port ran it as about 600 eager torch ops a chunk (float64 batched
// matmuls); those ops stay, as ops/residual.py residual_plain, the
// oracle that this kernel equals bit for bit.
//
// What bounds it: bytes. A 16-tile flagship chunk writes 29.5 MB of
// int32 residual planes (every sample, the padding and the TUs without
// coefficients included) and reads a few MB of int16 levels; the two
// transform stages need at most 2 * 344 / 32 = 21.5 multiply-adds a
// sample of a coded TU in butterfly form, far below the card's integer
// rate (ops/residual.py:residual_bytes, residual_macs).
//
// Design, correctness first:
// - One launch for every class: the wrapper passes up to MAX_CLASSES
//   class descriptors by value (levels, qp, DST / skip / bypass flags,
//   flat origin, scaling matrix, destination plane and its row pitch),
//   and the launcher gives each class a run of blocks.
// - A block takes 1,024 samples of one class: one 32x32 TU, four 16x16,
//   sixteen 8x8 or sixty-four 4x4 TUs. Each of its 256 threads owns 4
//   samples (sample t, t + 256, ...; a TU's rows are contiguous). The
//   dequantised levels D and the column stage's result G live in shared
//   memory, as does the transform matrix of the class (and DST-4 beside
//   DCT-4), copied from the tables of tables.ReconTables: the transform
//   reads T[k][col] with col varying across a warp, which constant memory
//   would serialise.
// - Arithmetic as the spec and the plain version do it, in int32: the
//   dequant product and its left shift are taken in uint32 and cast back,
//   so saturated levels wrap exactly as the plain version's (and JAX's)
//   int32 does, where signed overflow in C++ would be undefined; `>>` on
//   a negative int is arithmetic in nvcc, the spec's `>>`. The transform
//   sums stay exact in int32: |sum| <= 32 * 32768 * 90 < 2^31.
// - Each block writes its TUs straight to their place in the padded
//   [n, h+PAD, w+PAD] plane of their component: the flat origin is that
//   plane's element index of the TU's top-left sample. Rows with a
//   negative origin (cap padding) and block slots past the class's count
//   read no field and write nothing. The planes are zero-filled before
//   the launch, so samples that no TU covers read 0.
// Tensor cores, TMA and coalesced row tiles are left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SAMPLES = 1024;  // samples a block: one 32x32 TU
constexpr int PER_THREAD = SAMPLES / THREADS;
constexpr int MAX_CLASSES = 12;

// One (component, size) class: k TUs of size x size levels.
struct ResClass {
  const int16_t* coeffs;   // [k, size, size]
  const int32_t* qp;       // [k] dequant qp (qP of §8.6.2)
  const uint8_t* dst;      // [k] bool: DST-4 (4x4 luma intra)
  const uint8_t* skip;     // [k] bool: transform skip
  const uint8_t* bypass;   // [k] bool: transquant bypass
  const int32_t* org;      // [k] flat origin in the padded planes, < 0: none
  const int32_t* scaling;  // [size, size] scaling factors m[x][y]
  int32_t* plane;          // [n, h+PAD, w+PAD] residual plane
  int k, size, bd, pitch;  // pitch: w + PAD, the plane's row length
};

struct ResArgs {
  ResClass c[MAX_CLASSES];
  int first_block[MAX_CLASSES + 1];  // class i takes blocks [fb[i], fb[i+1])
  int n_classes;
  const int32_t* level_scale;  // [6]
  const int32_t* dct[4];       // [4,4], [8,8], [16,16], [32,32]
  const int32_t* dst4;         // [4,4]
};

__device__ __forceinline__ int clip16(int v) {
  return min(max(v, -32768), 32767);
}

__device__ __forceinline__ int log2_of(int size) {
  return size == 4 ? 2 : size == 8 ? 3 : size == 16 ? 4 : 5;
}

__global__ void __launch_bounds__(THREADS) residual_kernel(ResArgs a) {
  __shared__ int32_t D[SAMPLES];  // dequantised levels, then rows R
  __shared__ int32_t G[SAMPLES];  // column stage
  __shared__ int32_t T[SAMPLES];  // the class's DCT matrix
  __shared__ int32_t S4[16];      // DST-4 (4x4 classes)
  __shared__ int32_t tu_of_slot[SAMPLES / 16];  // global TU, -1: none

  int ci = 0;
  while (ci + 1 < a.n_classes && (int)blockIdx.x >= a.first_block[ci + 1])
    ++ci;
  const ResClass& c = a.c[ci];
  const int s = c.size;
  const int ss = s * s;
  const int log2 = log2_of(s);
  const int tus = SAMPLES / ss;  // TUs in this block
  const int tu0 = ((int)blockIdx.x - a.first_block[ci]) * tus;

  const int32_t* dct = a.dct[log2 - 2];
  for (int i = threadIdx.x; i < ss; i += THREADS) T[i] = dct[i];
  if (s == 4 && threadIdx.x < 16) S4[threadIdx.x] = a.dst4[threadIdx.x];
  if (threadIdx.x < tus) {
    const int tu = tu0 + threadIdx.x;
    // a cap-padding row (org < 0) and a slot past the class are skipped
    // before any other field of theirs is read
    tu_of_slot[threadIdx.x] = (tu < c.k && c.org[tu] >= 0) ? tu : -1;
  }
  __syncthreads();

  // dequant (§8.6.2-§8.6.3): clip16((lvl * m * levelScale[qp % 6]
  // << (qp / 6)) >> bdShift), with the spec's rounding
  const int bd_shift = c.bd + log2 - 5;
  int lvl[PER_THREAD];
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) {
    const int idx = threadIdx.x + r * THREADS;
    const int slot = idx / ss;
    const int tu = tu_of_slot[slot];
    int d = 0;
    lvl[r] = 0;
    if (tu >= 0) {
      const int e_in = idx - slot * ss;
      lvl[r] = c.coeffs[(long long)tu * ss + e_in];
      const int qp = c.qp[tu];
      const int e = qp >= 0 ? qp / 6 : -((5 - qp) / 6);  // floor(qp / 6)
      const int m6 = qp - 6 * e;                         // qp mod 6, >= 0
      const uint32_t v = (uint32_t)lvl[r] * (uint32_t)c.scaling[e_in] *
                         (uint32_t)a.level_scale[m6];
      int lo;
      if (e < bd_shift)
        lo = ((int)v + (1 << (bd_shift - e - 1))) >> (bd_shift - e);
      else
        lo = (int)(v << (e - bd_shift));
      d = clip16(lo);
    }
    D[idx] = d;
  }
  __syncthreads();

  // column stage: G = T^T D, (x + 64) >> 7, clip16
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) {
    const int idx = threadIdx.x + r * THREADS;
    const int slot = idx / ss;
    const int e_in = idx - slot * ss;
    const int i = e_in / s, j = e_in - (e_in / s) * s;
    const int tu = tu_of_slot[slot];
    const int32_t* t = (s == 4 && tu >= 0 && c.dst[tu]) ? S4 : T;
    const int32_t* dcol = D + slot * ss + j;
    int acc = 0;
    for (int k = 0; k < s; ++k) acc += t[k * s + i] * dcol[k * s];
    G[idx] = clip16((acc + 64) >> 7);
  }
  __syncthreads();

  // row stage: R = G T, (x + (1 << (19 - bd))) >> (20 - bd), clip16;
  // transform skip and transquant bypass replace it; then the store
  const int rnd = 1 << (19 - c.bd);
  const int sh = 20 - c.bd;
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) {
    const int idx = threadIdx.x + r * THREADS;
    const int slot = idx / ss;
    const int tu = tu_of_slot[slot];
    if (tu < 0) continue;
    const int e_in = idx - slot * ss;
    const int i = e_in / s, j = e_in - (e_in / s) * s;
    int out;
    if (c.bypass[tu]) {
      out = lvl[r];
    } else if (c.skip[tu]) {
      out = clip16(((D[idx] << 7) + rnd) >> sh);
    } else {
      const int32_t* t = (s == 4 && c.dst[tu]) ? S4 : T;
      const int32_t* grow = G + slot * ss + i * s;
      int acc = 0;
      for (int k = 0; k < s; ++k) acc += grow[k] * t[k * s + j];
      out = clip16((acc + rnd) >> sh);
    }
    c.plane[(long long)c.org[tu] + (long long)i * c.pitch + j] = out;
  }
}

}  // namespace

extern "C" {

// The residual of every class into its plane, one launch on `stream`.
// classes: n_classes host descriptors (ResClass layout; ops/residual.py
// builds them with ctypes); level_scale, dct4..dct32, dst4: the int32
// tables of tables.ReconTables on the card. The planes must be zeroed.
// Returns -1 for a descriptor the kernel does not take (more than
// MAX_CLASSES, a size other than 4-32, a bit depth outside 8-16, a count
// below 0), else cudaGetLastError() after the launch.
int heif_residual(const void* classes, int n_classes, const void* level_scale,
                  const void* dct4, const void* dct8, const void* dct16,
                  const void* dct32, const void* dst4, void* stream) {
  if (n_classes < 0 || n_classes > MAX_CLASSES) return -1;
  ResArgs a;
  a.n_classes = n_classes;
  a.level_scale = static_cast<const int32_t*>(level_scale);
  a.dct[0] = static_cast<const int32_t*>(dct4);
  a.dct[1] = static_cast<const int32_t*>(dct8);
  a.dct[2] = static_cast<const int32_t*>(dct16);
  a.dct[3] = static_cast<const int32_t*>(dct32);
  a.dst4 = static_cast<const int32_t*>(dst4);
  const ResClass* in = static_cast<const ResClass*>(classes);
  long long blocks = 0;
  for (int i = 0; i < n_classes; ++i) {
    const ResClass& c = in[i];
    if ((c.size != 4 && c.size != 8 && c.size != 16 && c.size != 32) ||
        c.k < 0 || c.bd < 8 || c.bd > 16)
      return -1;
    a.c[i] = c;
    a.first_block[i] = (int)blocks;
    const int tus = SAMPLES / (c.size * c.size);
    blocks += (c.k + tus - 1) / tus;
  }
  a.first_block[n_classes] = (int)blocks;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffff) return -1;
  residual_kernel<<<(unsigned)blocks, THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
