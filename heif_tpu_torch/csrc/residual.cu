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
// coefficients included; the wrapper's zero fill writes them all, this
// kernel the samples of coded TUs) and reads a few MB of int16 levels.
// The two transform passes need at most 2 * 344 / 32 = 21.5
// multiply-adds a sample in butterfly form: 67 M a chunk, 0.004 ms at
// the card's int32 rate against 0.012 ms for the bytes
// (ops/residual.py:residual_bytes, residual_macs). So no tensor cores:
// the levels take 16 bits and the int32 lanes cover the arithmetic.
//
// Design:
// - One launch for every class. The launcher orders the classes by size,
//   32x32 first, and gives each a run of 256-thread blocks, so that the
//   heaviest blocks start first and the light 4x4 blocks fill the tail.
//   Descriptors reach the kernel as a __grid_constant__ parameter, read
//   where they lie (no per-thread copy).
// - The work of a class is a template on its size S (4, 8, 16, 32),
//   picked by a switch: divisions are shifts and every loop unrolls. A
//   block takes 256 / S TUs; thread (t, j) owns column j of TU t in the
//   first pass and row j in the second, S values in registers.
// - Once per TU (one thread each) the block reads the TU's qp (-> the
//   level scale and the shift of the dequant), its flags and its origin.
//   A cap-padding row (origin < 0) or a slot past the class reads no
//   other field and writes nothing.
// - The block's levels are one contiguous run: read in 16-byte loads,
//   dequantised (§8.6.3; the product and its left shift taken in uint32
//   and cast back, so saturated levels wrap exactly as the plain
//   version's int32 does, where signed overflow in C++ would be
//   undefined), and laid into shared memory as [t][row][S + 1]; the pad
//   word makes every column and row read free of bank conflicts.
// - Each 1-D pass is the even/odd partial butterfly of the HEVC DCT
//   matrix: T_S[2k][n] = T_{S/2}[k][n] and T_S[k][S-1-n] = (-1)^k
//   T_S[k][n], so out[n] = E[n] + O[n] and out[S-1-n] = E[n] - O[n],
//   with E the S/2-point transform of the even inputs and O the odd
//   inputs' products: 8 / 24 / 88 / 344 multiply-adds a column for S =
//   4-32 instead of S * S. Integer sums in any order give the same value,
//   and every partial sum is bounded by the direct sum's bound,
//   32 * 32768 * 90 < 2^31, so the result is the direct product's, bit
//   for bit. The matrix entries are HEVC's 32 distinct cosines
//   (kCos below, T_S[k][n] = +-kCos of k * (2n + 1) * 32 / S folded into
//   0-32), in constant memory; after unrolling every index is known, so
//   they are immediate operands. DST-4 stays a direct 4x4 product.
// - Zero rows and columns skipped, exactly: a warp finds the last row
//   and the last column that hold a nonzero dequantised level in any of
//   its TUs (two warp reductions). The first pass then takes only that
//   many leading inputs (S/4, S/2 or S: three instantiations, picked by a
//   branch that is uniform across the warp), and the second pass as
//   many, since a zero column of levels gives a zero column after the
//   first pass. At the flagship's qp most high-frequency levels are 0.
// - Transform skip and transquant bypass replace the passes (bypass
//   keeps the raw level, which the load stores in place of its dequant).
// - Each thread stores its row as 16-byte int4 runs straight into the
//   padded [n, h+PAD, w+PAD] plane: the flat origin is that plane's
//   element index of the TU's top-left sample, the pitch w + PAD and TU
//   x a multiple of 4 keep the runs aligned (where they are not, as for a
//   plane of a width that is not a multiple of 4, the stores are single
//   words). The planes are zero-filled before the launch (one fill in the
//   wrapper), so samples that no TU covers read 0.
// What it leaves: the fill writes every sample once more; a fill of only
// the samples no TU covers needs a sample-to-TU map from the packer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CLASSES = 12;
constexpr int MAX_TUS = THREADS / 4;  // TUs a block of 4x4 TUs
constexpr unsigned FULL = 0xffffffffu;

// 64 * sqrt(2) * cos(pi * m / 64) as HEVC rounds it (H.265 §8.6.4.2,
// transMatrix), m = 0..32: T_S[k][n] = cos_at(k * (2n + 1) * 32 / S).
__constant__ int32_t kCos[33] = {64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80,
                                 78, 75, 73, 70, 67, 64, 61, 57, 54, 50, 46,
                                 43, 38, 36, 31, 25, 22, 18, 13, 9,  4,  0};
// the DST-4 matrix (§8.6.4.2, transMatrix of 4x4 luma intra), [k][n]
__constant__ int32_t kDst4[16] = {29, 55, 74,  84, 74, 74,  0,  -74,
                                  84, -29, -74, 55, 55, -84, 74, -29};
__constant__ int32_t kLevelScale[6] = {40, 45, 51, 57, 64, 72};

// One (component, size) class: k TUs of size x size levels. The layout
// of ops/residual.py's ResClass.
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

struct ClassArgs {
  ResClass r;
  int vec_in;   // levels 16-byte aligned: 16-byte loads
  int vec_out;  // plane 16-byte aligned and pitch a multiple of 4
};

struct ResArgs {
  ClassArgs c[MAX_CLASSES];          // in launch order (largest size first)
  int first_block[MAX_CLASSES + 1];  // class i takes blocks [fb[i], fb[i+1])
  int n_classes;
};

enum Mode : int { DCT = 0, DST = 1, SKIP = 2, BYPASS = 3 };

__device__ __forceinline__ int clip16(int v) {
  return min(max(v, -32768), 32767);
}

__device__ __forceinline__ int cos_at(int m) {
  m &= 127;
  if (m > 64) m = 128 - m;
  return m <= 32 ? kCos[m] : -kCos[64 - m];
}

// T_N[k][n]: basis function k of the N-point HEVC DCT at sample n.
template <int N>
__device__ __forceinline__ int coef(int k, int n) {
  return cos_at((32 / N) * k * (2 * n + 1));
}

// out[n] = sum over k < KM of T_N[k][n] * in[k], n < N: the inverse
// N-point transform of inputs of which only the first KM can be nonzero,
// as a partial butterfly.
template <int N, int KM>
struct Idct {
  static __device__ __forceinline__ void run(const int (&in)[N],
                                             int (&out)[N]) {
    if constexpr (N == 1) {
      out[0] = KM > 0 ? 64 * in[0] : 0;
    } else {
      constexpr int H = N / 2;
      int ev[H], e[H];
#pragma unroll
      for (int k = 0; k < H; ++k) ev[k] = in[2 * k];
      Idct<H, (KM + 1) / 2>::run(ev, e);
#pragma unroll
      for (int n = 0; n < H; ++n) {
        int o = 0;
#pragma unroll
        for (int k = 1; k < KM; k += 2) o += coef<N>(k, n) * in[k];
        out[n] = e[n] + o;
        out[N - 1 - n] = e[n] - o;
      }
    }
  }
};

__device__ __forceinline__ void idst4(const int (&in)[4], int (&out)[4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    int acc = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc += kDst4[k * 4 + n] * in[k];
    out[n] = acc;
  }
}

// The transform of one column or row, its leading `used` inputs possibly
// nonzero (uniform across the warp): the smallest instantiation that
// covers them.
template <int S>
__device__ __forceinline__ void transform(int mode, int used,
                                          const int (&in)[S], int (&out)[S]) {
  if constexpr (S == 4) {
    if (mode == DST) {
      idst4(in, out);
      return;
    }
  }
  if (used <= S / 4)
    Idct<S, S / 4>::run(in, out);
  else if (used <= S / 2)
    Idct<S, S / 2>::run(in, out);
  else
    Idct<S, S>::run(in, out);
}

struct TuInfo {
  int org[MAX_TUS];    // flat origin, < 0: no TU in this slot
  int scale[MAX_TUS];  // levelScale[qp % 6]
  int shift[MAX_TUS];  // bdShift - qp / 6: > 0 rounding right shift
  int mode[MAX_TUS];
};

// The block's TUs [tu0, tu0 + 256 / S) of class c.
template <int S>
__device__ __forceinline__ void residual_tus(const ClassArgs& ca, int tu0,
                                             int32_t* D, TuInfo& ti) {
  constexpr int TPB = THREADS / S;  // TUs a block
  constexpr int P = S + 1;          // shared row pitch
  constexpr int LOG2 = S == 4 ? 2 : S == 8 ? 3 : S == 16 ? 4 : 5;
  const ResClass& c = ca.r;
  const int tid = threadIdx.x;

  // once per TU: origin, dequant scale and shift, mode
  if (tid < TPB) {
    const int tu = tu0 + tid;
    const int org = tu < c.k ? c.org[tu] : -1;
    ti.org[tid] = org;
    if (org >= 0) {
      const int qp = c.qp[tu];
      const int e = qp >= 0 ? qp / 6 : -((5 - qp) / 6);  // floor(qp / 6)
      ti.scale[tid] = kLevelScale[qp - 6 * e];
      ti.shift[tid] = c.bd + LOG2 - 5 - e;
      ti.mode[tid] = c.bypass[tu] ? BYPASS
                     : c.skip[tu] ? SKIP
                     : (S == 4 && c.dst[tu]) ? DST
                                             : DCT;
    }
  }
  __syncthreads();

  // the block's levels, 8 a thread and chunk, dequantised into D
  const int16_t* lv = c.coeffs + (long long)tu0 * S * S;
  for (int q = tid; q < TPB * S * S / 8; q += THREADS) {
    const int e0 = q * 8;
    const int t = e0 >> (2 * LOG2);
    const int org = ti.org[t];
    int32_t* row = D + t * S * P;
    int v[8];
    if (org < 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0;
    } else {
      int16_t l[8];
      if (ca.vec_in) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(lv + e0));
        const int16_t* p = reinterpret_cast<const int16_t*>(&w);
#pragma unroll
        for (int i = 0; i < 8; ++i) l[i] = p[i];
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) l[i] = lv[e0 + i];
      }
      const int mode = ti.mode[t];
      const uint32_t scale = (uint32_t)ti.scale[t];
      const int sh = ti.shift[t];
      const int in_tu = e0 & (S * S - 1);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (mode == BYPASS) {
          v[i] = l[i];
          continue;
        }
        // §8.6.3: clip16((lvl * m * levelScale << (qp / 6)) >> bdShift)
        const uint32_t p = (uint32_t)(int)l[i] *
                           (uint32_t)__ldg(c.scaling + in_tu + i) * scale;
        const int lo = sh > 0 ? (int)(p + (1u << (sh - 1))) >> sh
                              : (int)(p << -sh);
        v[i] = clip16(lo);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = (e0 + i) & (S * S - 1);
      row[(e >> LOG2) * P + (e & (S - 1))] = v[i];
    }
  }
  __syncthreads();

  // first pass: thread (t, j) transforms column j of TU t
  const int t = tid >> LOG2;
  const int j = tid & (S - 1);
  int32_t* Dt = D + t * S * P;
  const int org = ti.org[t];
  const int mode = org >= 0 ? ti.mode[t] : SKIP;
  int x[S];
  int rows = 0;  // 1 + the last nonzero row of this column
#pragma unroll
  for (int k = 0; k < S; ++k) {
    x[k] = Dt[k * P + j];
    if (x[k] != 0) rows = k + 1;
  }
  // over the warp's TUs: rows that hold a nonzero level, and columns
  const int used_rows = __reduce_max_sync(FULL, rows);
  const int used_cols = __reduce_max_sync(FULL, rows ? j + 1 : 0);
  if (org >= 0 && mode <= DST) {
    int y[S];
    transform<S>(mode, used_rows, x, y);
#pragma unroll
    for (int k = 0; k < S; ++k) Dt[k * P + j] = clip16((y[k] + 64) >> 7);
  }
  __syncthreads();

  // second pass: thread (t, i = j) takes row i, then stores it
  if (org < 0) return;
  const int bd = c.bd;
  const int rnd = 1 << (19 - bd), sh = 20 - bd;
  int g[S], r[S];
#pragma unroll
  for (int k = 0; k < S; ++k) g[k] = Dt[j * P + k];
  if (mode == BYPASS) {
#pragma unroll
    for (int k = 0; k < S; ++k) r[k] = g[k];
  } else if (mode == SKIP) {
#pragma unroll
    for (int k = 0; k < S; ++k) r[k] = clip16((g[k] * 128 + rnd) >> sh);
  } else {
    int y[S];
    transform<S>(mode, used_cols, g, y);
#pragma unroll
    for (int k = 0; k < S; ++k) r[k] = clip16((y[k] + rnd) >> sh);
  }
  int32_t* out = c.plane + (long long)org + (long long)j * c.pitch;
  if (ca.vec_out && (org & 3) == 0) {
#pragma unroll
    for (int k = 0; k < S; k += 4)
      *reinterpret_cast<int4*>(out + k) =
          make_int4(r[k], r[k + 1], r[k + 2], r[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < S; ++k) out[k] = r[k];
  }
}

__global__ void __launch_bounds__(THREADS)
    residual_kernel(const __grid_constant__ ResArgs a) {
  __shared__ int32_t D[THREADS * 33];  // [256 / S][S][S + 1]
  __shared__ TuInfo ti;

  int ci = 0;
  while (ci + 1 < a.n_classes && (int)blockIdx.x >= a.first_block[ci + 1])
    ++ci;
  const ClassArgs& ca = a.c[ci];
  const int b = (int)blockIdx.x - a.first_block[ci];
  switch (ca.r.size) {
    case 32: residual_tus<32>(ca, b * (THREADS / 32), D, ti); break;
    case 16: residual_tus<16>(ca, b * (THREADS / 16), D, ti); break;
    case 8: residual_tus<8>(ca, b * (THREADS / 8), D, ti); break;
    default: residual_tus<4>(ca, b * (THREADS / 4), D, ti); break;
  }
}

}  // namespace

extern "C" {

// The residual of every class into its plane, one launch on `stream`.
// classes: n_classes host descriptors (ResClass layout; ops/residual.py
// builds them with ctypes). The planes must be zeroed. Returns -1 for a
// descriptor the kernel does not take (more than MAX_CLASSES, a size
// other than 4-32, a bit depth outside 8-16, a count below 0), else
// cudaGetLastError() after the launch.
int heif_residual(const void* classes, int n_classes, void* stream) {
  if (n_classes < 0 || n_classes > MAX_CLASSES) return -1;
  const ResClass* in = static_cast<const ResClass*>(classes);
  for (int i = 0; i < n_classes; ++i) {
    const ResClass& c = in[i];
    if ((c.size != 4 && c.size != 8 && c.size != 16 && c.size != 32) ||
        c.k < 0 || c.bd < 8 || c.bd > 16)
      return -1;
  }
  ResArgs a;
  a.n_classes = n_classes;
  long long blocks = 0;
  int n = 0;
  for (int size = 32; size >= 4; size /= 2) {  // heaviest blocks first
    for (int i = 0; i < n_classes; ++i) {
      const ResClass& c = in[i];
      if (c.size != size) continue;
      ClassArgs& ca = a.c[n];
      ca.r = c;
      ca.vec_in = (reinterpret_cast<uintptr_t>(c.coeffs) & 15) == 0;
      ca.vec_out = (reinterpret_cast<uintptr_t>(c.plane) & 15) == 0 &&
                   (c.pitch & 3) == 0;
      a.first_block[n++] = (int)blocks;
      const int tus = THREADS / size;
      blocks += (c.k + tus - 1) / tus;
    }
  }
  a.first_block[n_classes] = (int)blocks;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffff) return -1;
  residual_kernel<<<(unsigned)blocks, THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
