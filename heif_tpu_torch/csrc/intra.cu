// Sequential HEVC intra-prediction walk (H.265 §8.4.4.2) for Hopper.
//
// Replaces the TPU Pallas kernels heif_tpu/ops/pallas_intra.py
// `_kernel_luma` (launched by `intra_scan_pallas`) and `_kernel_chroma`
// (launched by `intra_scan_pallas_chroma2`). It computes what they
// compute (bit for bit, see heif_tpu_torch/ops/recon.py for the plain
// PyTorch oracle), but is not carried over block by block:
//
// - Grid: one CUDA block per tile (luma), or per tile for its Cb+Cr pair
//   (chroma: HEVC signals one chroma mode per PU, so both planes share
//   one worklist). The block walks its tile's TU worklist in order, up to
//   counts[tile]; each TU reads reference samples written by earlier TUs
//   of the same block, so TUs are separated by __syncthreads().
// - Memory: the reconstruction plane lives in global memory in the
//   padded +1-origin layout [1+H+SPAD, 1+W+SPAD] (L2 holds the working
//   set; a 512x512 int32 plane is 1 MB, past the 227 KB a block may
//   use). Left reference columns are strided reads, so no transposed copy
//   is kept. Residual and PCM planes are separate inputs; nothing aliases.
//   Only the per-TU working set sits in shared memory: the substituted
//   and the filtered references (2 x 130 per plane).
// - Prediction uses the direct spec formulas (planar, DC, angular with
//   iIdx/iFact over the main reference and the inverse-angle side
//   extension). The TPU kernels used a bf16 weight matvec to reach the
//   MXU, which also limited them to 8-bit samples; here the bit depth,
//   strong intra smoothing and per-step PCM are plain inputs.
//
// What bounds it: latency, not bytes or FLOPs. The walk is one TU after
// another, three block barriers per TU (references -> filtered
// references -> samples), and the flagship grid gives only 48 luma and
// 48 chroma blocks for 132 SMs. Each step touches at most ~1.3 K samples,
// so the design keeps per-step work short (one pass per phase, no
// global-memory round trip for the references) and leaves overlapping
// independent tiles on one SM to later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_S = 32;
constexpr int REF_LEN = 2 * MAX_S + 1;  // 65: corner + 2N per side
constexpr int N_REF = 2 * REF_LEN;      // 130: left side ++ top side
constexpr int STEP_FIELDS = 6;          // x, y, size, mode, filter, pcm
constexpr int THREADS = 256;

// intraPredAngle by mode (modes 0, 1 unused), Table 8-4
__constant__ int c_angle[35] = {
    0,   0,   32,  26,  21,  17,  13,  9,   5,   2,   0,   -2,
    -5,  -9,  -13, -17, -21, -26, -32, -26, -21, -17, -13, -9,
    -5,  -2,  0,   2,   5,   9,   13,  17,  21,  26,  32};

__device__ __forceinline__ int inv_angle(int angle) {
  switch (angle) {  // Table 8-5
    case -2: return -4096;
    case -5: return -1638;
    case -9: return -910;
    case -13: return -630;
    case -17: return -482;
    case -21: return -390;
    case -26: return -315;
    default: return -256;  // -32
  }
}

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ref[k] of the angular reference array: the main side for k >= 0, the
// inverse-angle projection of the other side for k < 0.
__device__ __forceinline__ int ang_ref(const int* main, const int* side,
                                       int k, int angle) {
  if (k >= 0) return main[k];
  const int idx = ((-k) * -inv_angle(angle) + 128) >> 8;  // x = k < 0
  return side[min(max(idx, 0), 2 * MAX_S)];
}

struct PlaneSet {
  int32_t* out[2];        // [N, HP, WP] reconstruction, +1 origin
  const int32_t* res[2];  // [N, HR, WR] residual
  const int32_t* pcm[2];  // [N, HR, WR] PCM samples, or null
};

template <int NP, bool LUMA>
__global__ void __launch_bounds__(THREADS)
intra_walk(PlaneSet ps, const int32_t* __restrict__ steps,
           const uint8_t* __restrict__ src, const int32_t* __restrict__ counts,
           int S, int HP, int WP, int HR, int WR, int bd, int strong) {
  __shared__ int refs[NP][N_REF];
  __shared__ int fref[NP][N_REF];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t poff = (size_t)tile * HP * WP;
  const size_t roff = (size_t)tile * HR * WR;
  const int mxv = (1 << bd) - 1;
  const int count = min(counts[tile], S);

  for (int k = 0; k < count; ++k) {
    const int32_t* st = steps + ((size_t)tile * S + k) * STEP_FIELDS;
    const int tx = st[0], ty = st[1], size = st[2], mode = st[3];
    const int filt = st[4], is_pcm = st[5];
    if (size <= 0) continue;  // padding step; uniform across the block
    const uint8_t* sr = src + ((size_t)tile * S + k) * N_REF;

    // 1. gather + substitute the reference samples (§8.4.4.2.2): the
    //    local vector is the left strip (column tx-1, rows ty-1..) ++ the
    //    top strip (row ty-1, columns tx-1..); src picks from it.
    for (int j = tid; j < NP * N_REF; j += THREADS) {
      const int p = j / N_REF, jj = j - p * N_REF;
      const int s = sr[jj];
      int v;
      if (s >= N_REF) {
        v = 1 << (bd - 1);
      } else if (s < REF_LEN) {
        v = ps.out[p][poff + (size_t)(ty + s) * WP + tx];
      } else {
        v = ps.out[p][poff + (size_t)ty * WP + tx + (s - REF_LEN)];
      }
      refs[p][jj] = v;
    }
    __syncthreads();

    // 2. luma reference smoothing (§8.4.4.2.3): [1 2 1] or bilinear
    const int n2 = 2 * size;
    if (LUMA) {
      const int* L = refs[0];
      const int* T = refs[0] + REF_LEN;
      const int corner = L[0];
      const int thr = 1 << (bd - 5);
      const bool bi = strong && size == 32 &&
                      abs(corner + T[64] - 2 * T[32]) < thr &&
                      abs(corner + L[64] - 2 * L[32]) < thr;
      for (int j = tid; j < N_REF; j += THREADS) {
        const int side = j / REF_LEN, i = j - side * REF_LEN;
        const int* a = side ? T : L;
        int v = a[i];
        if (filt) {
          if (bi) {
            v = i == 0 ? corner
                       : (i <= 63 ? ((64 - i) * corner + i * a[64] + 32) >> 6
                                  : a[i]);
          } else if (i == 0) {
            v = (L[1] + 2 * corner + T[1] + 2) >> 2;
          } else if (i < n2) {
            v = (a[i - 1] + 2 * a[i] + a[i + 1] + 2) >> 2;
          }
        }
        fref[0][j] = v;
      }
      __syncthreads();
    }

    // 3. predict (§8.4.4.2.4-6), add the residual, clip, write back
    const int log2 = size == 4 ? 2 : size == 8 ? 3 : size == 16 ? 4 : 5;
    int dc[NP];
    if (mode == 1) {
      // every warp reduces the DC sum itself: no extra block barrier
      for (int p = 0; p < NP; ++p) {
        const int* L = LUMA ? fref[p] : refs[p];
        const int* T = L + REF_LEN;
        int v = lane < size ? L[1 + lane] + T[1 + lane] : 0;
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        dc[p] = (v + size) >> (log2 + 1);
      }
    }
    const int angle = c_angle[mode];
    const bool vertical = mode >= 18;
    for (int e = tid; e < NP * size * size; e += THREADS) {
      const int p = e / (size * size);
      const int r = e - p * size * size;
      const int y = r >> log2, x = r & (size - 1);
      const int* L = LUMA ? fref[p] : refs[p];
      const int* T = L + REF_LEN;
      int pred;
      if (mode == 0) {
        pred = ((size - 1 - x) * L[1 + y] + (x + 1) * T[size + 1] +
                (size - 1 - y) * T[1 + x] + (y + 1) * L[size + 1] + size) >>
               (log2 + 1);
      } else if (mode == 1) {
        const int d = dc[p];
        pred = d;
        if (LUMA && size < 32) {
          if (x == 0 && y == 0) pred = (L[1] + 2 * d + T[1] + 2) >> 2;
          else if (y == 0) pred = (T[1 + x] + 3 * d + 2) >> 2;
          else if (x == 0) pred = (L[1 + y] + 3 * d + 2) >> 2;
        }
      } else {
        const int dd = vertical ? y : x;  // distance to the main edge - 1
        const int pp = vertical ? x : y;  // position along it
        const int* mainr = vertical ? T : L;
        const int* sider = vertical ? L : T;
        const int pos = (dd + 1) * angle;
        const int iidx = pos >> 5, ifact = pos & 31;
        const int k1 = pp + iidx + 1;
        const int r1 = ang_ref(mainr, sider, k1, angle);
        const int r2 = ifact ? ang_ref(mainr, sider, k1 + 1, angle) : 0;
        pred = ((32 - ifact) * r1 + ifact * r2 + 16) >> 5;
        if (LUMA && size < 32) {
          if (mode == 26 && x == 0) pred = clip3(0, mxv, T[1] + ((L[1 + y] - L[0]) >> 1));
          if (mode == 10 && y == 0) pred = clip3(0, mxv, L[1] + ((T[1 + x] - T[0]) >> 1));
        }
      }
      const size_t ri = roff + (size_t)(ty + y) * WR + tx + x;
      int v = clip3(0, mxv, pred + ps.res[p][ri]);
      if (is_pcm) v = ps.pcm[p] ? ps.pcm[p][ri] : 0;
      ps.out[p][poff + (size_t)(ty + 1 + y) * WP + tx + 1 + x] = v;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Luma walk over n tiles. plane: [n, HP, WP] int32, zero-initialised by
// the caller; res / pcm: [n, HR, WR] int32 (pcm may be null); steps:
// [n, S, 6] int32; src: [n, S, 130] uint8; counts: [n] int32.
// Returns cudaGetLastError() after the launch on `stream`.
int heif_intra_luma(void* plane, const void* res, const void* pcm,
                    const void* steps, const void* src, const void* counts,
                    int n, int S, int HP, int WP, int HR, int WR, int bd,
                    int strong, void* stream) {
  if (n <= 0) return 0;
  PlaneSet ps = {};
  ps.out[0] = static_cast<int32_t*>(plane);
  ps.res[0] = static_cast<const int32_t*>(res);
  ps.pcm[0] = static_cast<const int32_t*>(pcm);
  intra_walk<1, true><<<n, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ps, static_cast<const int32_t*>(steps), static_cast<const uint8_t*>(src),
      static_cast<const int32_t*>(counts), S, HP, WP, HR, WR, bd, strong);
  return static_cast<int>(cudaGetLastError());
}

// Cb + Cr walk over n tiles sharing one worklist; shapes as above.
int heif_intra_chroma2(void* plane_cb, void* plane_cr, const void* res_cb,
                       const void* res_cr, const void* pcm_cb,
                       const void* pcm_cr, const void* steps, const void* src,
                       const void* counts, int n, int S, int HP, int WP,
                       int HR, int WR, int bd, void* stream) {
  if (n <= 0) return 0;
  PlaneSet ps = {};
  ps.out[0] = static_cast<int32_t*>(plane_cb);
  ps.out[1] = static_cast<int32_t*>(plane_cr);
  ps.res[0] = static_cast<const int32_t*>(res_cb);
  ps.res[1] = static_cast<const int32_t*>(res_cr);
  ps.pcm[0] = static_cast<const int32_t*>(pcm_cb);
  ps.pcm[1] = static_cast<const int32_t*>(pcm_cr);
  intra_walk<2, false><<<n, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ps, static_cast<const int32_t*>(steps), static_cast<const uint8_t*>(src),
      static_cast<const int32_t*>(counts), S, HP, WP, HR, WR, bd, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
