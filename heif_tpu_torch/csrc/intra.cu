// HEVC intra-prediction walk (H.265 §8.4.4.2) for Hopper, as a CTB-row
// wavefront.
//
// Replaces the TPU Pallas kernels heif_tpu/ops/pallas_intra.py:420
// `_kernel_luma` (launched by `intra_scan_pallas`) and :647
// `_kernel_chroma` (launched by `intra_scan_pallas_chroma2`). It computes
// what they compute, bit for bit (the plain PyTorch walk in
// heif_tpu_torch/ops/recon.py is the oracle), but is not carried over
// block by block.
//
// What bounds it: the dependency chain, not bytes or FLOPs. Each TU reads
// reference samples that earlier TUs wrote, so a tile is a chain of
// ~7,000 luma steps of at most ~1.3 K samples each; the bytes (residual,
// source table, plane: ~165 MB for the 48 flagship tiles) would take
// ~50 us at 3.35 TB/s. Walking the whole chain in decode order, as one
// block with block barriers between steps, took ~1.5 us a step.
//
// What the wavefront does about it: HEVC makes a reference sample
// available only when it lies earlier in z-order and in the same HEVC
// tile, and a TU's reference window reaches at most the left, above-left,
// above and above-right CTBs. So CTB rows can run concurrently: row r may
// walk CTB c once row r-1 has finished CTB c+1. A 512x512 tile at CTB 32
// then has 16 + 2*15 = 46 CTBs on its critical path instead of 256; on
// the flagship's heaviest tile that path holds ~2,100 of its 6,943 luma
// steps, so the time is that path's length times a warp's step latency.
// - Schedule: ops/intra.py:unit_table cuts each tile's worklist into
//   units (maximal runs of steps in one CTB row of one HEVC tile) with,
//   per unit, its step range, first and last CTB column, and the unit of
//   the row above that it waits on (-1: none). Units of different HEVC
//   tiles never wait on each other.
// - Grid: one block per tile (luma), or per tile for its Cb+Cr pair
//   (chroma: HEVC signals one chroma mode per PU, so both planes share one
//   worklist). Warp w of the block walks units w, w+WARPS, ... in order.
//   That cannot deadlock: a unit waits only on a unit of lower index, so
//   the lowest unfinished unit can always move.
// - Synchronisation: per unit one progress counter in shared memory, the
//   last CTB column it has finished. Before the first step of CTB column
//   c a warp spins until its wait unit has finished column
//   min(c + 1, that unit's last column). Publishing is a release (every
//   lane fences its plane writes, __syncwarp, lane 0 stores the counter);
//   waiting is an acquire (volatile reads of the counter, then a fence).
//   Within a warp, steps are separated by __syncwarp only: no block
//   barrier after the start.
// - Warps: 16 (512 threads). The flagship's luma and chroma both have 16
//   CTB rows (32-sample luma CTBs, 16-sample chroma CTBs), one unit a
//   warp; the critical path, not the warp count, then bounds the walk.
//   Taller pictures (a raw decode_hevc picture) have more rows than
//   warps: a warp takes its next unit when it finishes one, which is
//   about when that unit's wait allows it to start anyway.
// - Memory: the reconstruction plane lives in global memory (L2 and the
//   SM's L1, which all warps of the block share) in the padded +1-origin
//   layout [1+H+SPAD, 1+W+SPAD]: a 512x512 int32 plane is 1 MB, past the
//   227 KB a block may use. Each warp keeps its own reference strips
//   (2 x 130 per plane) in shared memory. The step fields and source
//   indices of the next step are prefetched into registers. The next
//   step's residual is not: a TU holds up to 1,024 samples a plane (32 a
//   lane), and the block already spills above 64 registers a thread. In
//   its place the first 64 residual (or PCM) samples of the step itself
//   (RES_REGS = 2 a lane) are loaded before its wait and its reference
//   gather, which they do not depend on, so their latency hides behind
//   both. Builds that held 4 or 8 samples a lane were slower on the H100.
// - Per step, a warp's work is a chain of dependent loads and short
//   loops, so it is kept short: only the corner and 2N samples of each
//   side are gathered, unfiltered luma steps predict from the gathered
//   strips without a copy, and each lane holds few residual samples at a
//   time (64 registers a thread were spilling; at most 2 samples a lane
//   and __launch_bounds__(THREADS, 1) spill none).
// - Prediction uses the direct spec formulas (planar, DC, angular with
//   iIdx/iFact over the main reference and the inverse-angle side
//   extension), so any bit depth, strong intra smoothing, per-step PCM,
//   padding steps (size 0) and counts < S take the one path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_S = 32;
constexpr int REF_LEN = 2 * MAX_S + 1;  // 65: corner + 2N per side
constexpr int N_REF = 2 * REF_LEN;      // 130: left side ++ top side
constexpr int STEP_FIELDS = 6;          // x, y, size, mode, filter, pcm
constexpr int UNIT_FIELDS = 5;          // k0, k1, first col, last col, wait
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int SRC_REGS = (N_REF + 31) / 32;  // 5 source indices a lane
constexpr int RES_REGS = 2;                  // residual samples a lane
constexpr int DONE = 0x7fffffff;             // a finished unit's progress
// returned when the unit table does not fit in a block's shared memory
constexpr int ERR_SMEM = -1;

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

struct Step {
  int x, y, size, mode, filt, pcm;
};

__device__ __forceinline__ Step load_step(const int32_t* st) {
  Step s;
  s.x = st[0];
  s.y = st[1];
  s.size = st[2];
  s.mode = st[3];
  s.filt = st[4];
  s.pcm = st[5];
  return s;
}

__device__ __forceinline__ void load_src(const uint8_t* sr, int lane,
                                         int (&s)[SRC_REGS]) {
#pragma unroll
  for (int i = 0; i < SRC_REGS; ++i) {
    const int j = lane + 32 * i;
    s[i] = j < N_REF ? sr[j] : N_REF;
  }
}

// residual (or PCM) samples e = base + lane + 32 i of a step's NP planes
template <int NP>
__device__ __forceinline__ void load_res(const PlaneSet& ps, size_t roff,
                                         int WR, const Step& st, int log2,
                                         int base, int lane,
                                         int (&r)[RES_REGS]) {
  const int area = st.size * st.size;
#pragma unroll
  for (int i = 0; i < RES_REGS; ++i) {
    const int e = base + lane + 32 * i;
    int v = 0;
    if (e < NP * area) {
      const int p = e >> (2 * log2);
      const int q = e & (area - 1);
      const size_t ri = roff + (size_t)(st.y + (q >> log2)) * WR + st.x +
                        (q & (st.size - 1));
      if (!st.pcm) v = ps.res[p][ri];
      else if (ps.pcm[p]) v = ps.pcm[p][ri];
    }
    r[i] = v;
  }
}

// release: this warp's plane writes happen before the counter moves
__device__ __forceinline__ void publish(volatile int* done, int unit,
                                        int value, int lane) {
  __threadfence_block();
  __syncwarp();
  if (lane == 0) done[unit] = value;
}

template <int NP, bool LUMA>
__global__ void __launch_bounds__(THREADS, 1)
intra_walk(PlaneSet ps, const int32_t* __restrict__ steps,
           const uint8_t* __restrict__ src, const int32_t* __restrict__ counts,
           const int32_t* __restrict__ units, int S, int U, int HP, int WP,
           int HR, int WR, int bd, int strong, int ctb_log2) {
  extern __shared__ int done_smem[];  // [U] last finished CTB column
  __shared__ int refs_smem[WARPS][NP][N_REF];
  __shared__ int fref_smem[WARPS][LUMA ? N_REF : 1];
  volatile int* done = done_smem;
  const int tile = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t poff = (size_t)tile * HP * WP;
  const size_t roff = (size_t)tile * HR * WR;
  const int mxv = (1 << bd) - 1;
  const int count = min(counts[tile], S);
  const int32_t* ut = units + (size_t)tile * U * UNIT_FIELDS;
  const int32_t* tsteps = steps + (size_t)tile * S * STEP_FIELDS;
  const uint8_t* tsrc = src + (size_t)tile * S * N_REF;
  int(*refs)[N_REF] = refs_smem[warp];
  int* fref = fref_smem[warp];

  for (int u = threadIdx.x; u < U; u += THREADS)
    done[u] = ut[u * UNIT_FIELDS + 2] - 1;
  __syncthreads();

  for (int u = warp; u < U; u += WARPS) {
    const int k0 = ut[u * UNIT_FIELDS + 0];
    const int k1 = min(ut[u * UNIT_FIELDS + 1], count);
    const int wait = ut[u * UNIT_FIELDS + 4];
    const int wait_last = wait >= 0 ? ut[wait * UNIT_FIELDS + 3] : 0;
    int col = -1;  // CTB column being walked (columns are >= 0)

    Step nx = {};
    int nsrc[SRC_REGS];
    if (k0 < k1) {
      nx = load_step(tsteps + (size_t)k0 * STEP_FIELDS);
      load_src(tsrc + (size_t)k0 * N_REF, lane, nsrc);
    }
    for (int k = k0; k < k1; ++k) {
      const Step st = nx;
      int sidx[SRC_REGS];
#pragma unroll
      for (int i = 0; i < SRC_REGS; ++i) sidx[i] = nsrc[i];
      if (k + 1 < k1) {  // prefetch: nothing of it depends on the walk
        nx = load_step(tsteps + (size_t)(k + 1) * STEP_FIELDS);
        load_src(tsrc + (size_t)(k + 1) * N_REF, lane, nsrc);
      }
      if (st.size <= 0) continue;  // padding step; uniform across the warp
      const int size = st.size;
      const int log2 = size == 4 ? 2 : size == 8 ? 3 : size == 16 ? 4 : 5;
      const int ne = NP * size * size;
      int rv[RES_REGS];
      load_res<NP>(ps, roff, WR, st, log2, 0, lane, rv);

      // a new CTB column: publish the columns before it, then wait until
      // the row above has finished the CTB up and to the right
      const int c = st.x >> ctb_log2;
      if (c != col) {
        if (col >= 0) publish(done, u, c - 1, lane);
        col = c;
        if (wait >= 0) {
          const int need = min(c + 1, wait_last);
          while (done[wait] < need) __nanosleep(32);
          __threadfence_block();  // acquire: plane reads after the counter
        }
      }

      // 1. gather + substitute the reference samples (§8.4.4.2.2): the
      //    local vector is the left strip (column tx-1, rows ty-1..) ++ the
      //    top strip (row ty-1, columns tx-1..); src picks from it. Only
      //    the corner and 2N samples of each side are ever read.
      const int n2 = 2 * size;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
#pragma unroll
        for (int i = 0; i < SRC_REGS; ++i) {
          const int jj = lane + 32 * i;
          if (jj < N_REF && (jj < REF_LEN ? jj : jj - REF_LEN) <= n2) {
            const int s = sidx[i];
            int v;
            if (s >= N_REF) {
              v = 1 << (bd - 1);
            } else if (s < REF_LEN) {
              v = ps.out[p][poff + (size_t)(st.y + s) * WP + st.x];
            } else {
              v = ps.out[p][poff + (size_t)st.y * WP + st.x + (s - REF_LEN)];
            }
            refs[p][jj] = v;
          }
        }
      }
      __syncwarp();

      // 2. luma reference smoothing (§8.4.4.2.3): [1 2 1] or bilinear,
      //    into fref; unfiltered steps predict from refs directly
      const bool filtered = LUMA && st.filt;
      if (filtered) {
        const int* L = refs[0];
        const int* T = refs[0] + REF_LEN;
        const int corner = L[0];
        const int thr = 1 << (bd - 5);
        const bool bi = strong && size == 32 &&
                        abs(corner + T[64] - 2 * T[32]) < thr &&
                        abs(corner + L[64] - 2 * L[32]) < thr;
        for (int j = lane; j < N_REF; j += 32) {
          const int side = j / REF_LEN, i = j - side * REF_LEN;
          if (i > n2) continue;
          const int* a = side ? T : L;
          int v = a[i];
          if (bi) {
            v = i == 0 ? corner
                       : (i <= 63 ? ((64 - i) * corner + i * a[64] + 32) >> 6
                                  : a[i]);
          } else if (i == 0) {
            v = (L[1] + 2 * corner + T[1] + 2) >> 2;
          } else if (i < n2) {
            v = (a[i - 1] + 2 * a[i] + a[i + 1] + 2) >> 2;
          }
          fref[j] = v;
        }
        __syncwarp();
      }

      // 3. predict (§8.4.4.2.4-6), add the residual, clip, write back
      int dc0 = 0, dc1 = 0;  // DC value of each plane
      if (st.mode == 1) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const int* L = filtered ? fref : refs[p];
          const int* T = L + REF_LEN;
          int v = lane < size ? L[1 + lane] + T[1 + lane] : 0;
          for (int o = 16; o > 0; o >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
          (p ? dc1 : dc0) = (v + size) >> (log2 + 1);
        }
      }
      const int mode = st.mode;
      const int angle = c_angle[mode];
      const bool vertical = mode >= 18;
      for (int base = 0; base < ne; base += 32 * RES_REGS) {
        if (base) load_res<NP>(ps, roff, WR, st, log2, base, lane, rv);
#pragma unroll
        for (int i = 0; i < RES_REGS; ++i) {
          const int e = base + lane + 32 * i;
          if (e >= ne) continue;
          const int p = e >> (2 * log2);
          const int q = e & (size * size - 1);
          const int y = q >> log2, x = q & (size - 1);
          const int* L = filtered ? fref : refs[p];
          const int* T = L + REF_LEN;
          int pred;
          if (mode == 0) {
            pred = ((size - 1 - x) * L[1 + y] + (x + 1) * T[size + 1] +
                    (size - 1 - y) * T[1 + x] + (y + 1) * L[size + 1] +
                    size) >> (log2 + 1);
          } else if (mode == 1) {
            const int d = p ? dc1 : dc0;
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
            const int k1r = pp + iidx + 1;
            const int r1 = ang_ref(mainr, sider, k1r, angle);
            const int r2 = ifact ? ang_ref(mainr, sider, k1r + 1, angle) : 0;
            pred = ((32 - ifact) * r1 + ifact * r2 + 16) >> 5;
            if (LUMA && size < 32) {
              if (mode == 26 && x == 0)
                pred = clip3(0, mxv, T[1] + ((L[1 + y] - L[0]) >> 1));
              if (mode == 10 && y == 0)
                pred = clip3(0, mxv, L[1] + ((T[1 + x] - T[0]) >> 1));
            }
          }
          const int v = st.pcm ? rv[i] : clip3(0, mxv, pred + rv[i]);
          ps.out[p][poff + (size_t)(st.y + 1 + y) * WP + st.x + 1 + x] = v;
        }
      }
      __syncwarp();  // this step's samples before the next step's gather
    }
    publish(done, u, DONE, lane);
  }
}

template <int NP, bool LUMA>
int launch(const PlaneSet& ps, const void* steps, const void* src,
           const void* counts, const void* units, int n, int S, int U, int HP,
           int WP, int HR, int WR, int bd, int strong, int ctb_log2,
           void* stream) {
  if (n <= 0) return 0;
  const size_t smem = (size_t)(U > 0 ? U : 1) * sizeof(int);
  auto kernel = intra_walk<NP, LUMA>;
  // the unit counters are dynamic shared memory beside the kernel's static
  // refs_smem / fref_smem: past 48 KB in all, the block must opt in, and
  // past the device's opt-in limit it cannot launch. The static size is a
  // property of the compiled kernel: read once per instance.
  struct StaticSmem {
    cudaError_t err;
    size_t bytes;
  };
  static const StaticSmem stat = [] {
    cudaFuncAttributes attr{};
    const cudaError_t err = cudaFuncGetAttributes(&attr, intra_walk<NP, LUMA>);
    return StaticSmem{err, attr.sharedSizeBytes};
  }();
  if (stat.err != cudaSuccess) return static_cast<int>(stat.err);
  const size_t total = stat.bytes + smem;
  if (total > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (total > (size_t)optin) return ERR_SMEM;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<n, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      ps, static_cast<const int32_t*>(steps), static_cast<const uint8_t*>(src),
      static_cast<const int32_t*>(counts), static_cast<const int32_t*>(units),
      S, U, HP, WP, HR, WR, bd, strong, ctb_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Luma walk over n tiles. plane: [n, HP, WP] int32, zero-initialised by
// the caller; res / pcm: [n, HR, WR] int32 (pcm may be null); steps:
// [n, S, 6] int32; src: [n, S, 130] uint8; counts: [n] int32; units:
// [n, U, 5] int32 (ops/intra.py:unit_table at ctb_log2, the luma CTB
// size). Returns cudaGetLastError() after the launch on `stream`, or -1
// (no launch) when the U unit counters and the kernel's static shared
// memory exceed what a block may use.
int heif_intra_luma(void* plane, const void* res, const void* pcm,
                    const void* steps, const void* src, const void* counts,
                    const void* units, int n, int S, int U, int HP, int WP,
                    int HR, int WR, int bd, int strong, int ctb_log2,
                    void* stream) {
  PlaneSet ps = {};
  ps.out[0] = static_cast<int32_t*>(plane);
  ps.res[0] = static_cast<const int32_t*>(res);
  ps.pcm[0] = static_cast<const int32_t*>(pcm);
  return launch<1, true>(ps, steps, src, counts, units, n, S, U, HP, WP, HR,
                         WR, bd, strong, ctb_log2, stream);
}

// Cb + Cr walk over n tiles sharing one worklist; shapes as above, at the
// chroma CTB size.
int heif_intra_chroma2(void* plane_cb, void* plane_cr, const void* res_cb,
                       const void* res_cr, const void* pcm_cb,
                       const void* pcm_cr, const void* steps, const void* src,
                       const void* counts, const void* units, int n, int S,
                       int U, int HP, int WP, int HR, int WR, int bd,
                       int ctb_log2, void* stream) {
  PlaneSet ps = {};
  ps.out[0] = static_cast<int32_t*>(plane_cb);
  ps.out[1] = static_cast<int32_t*>(plane_cr);
  ps.res[0] = static_cast<const int32_t*>(res_cb);
  ps.res[1] = static_cast<const int32_t*>(res_cr);
  ps.pcm[0] = static_cast<const int32_t*>(pcm_cb);
  ps.pcm[1] = static_cast<const int32_t*>(pcm_cr);
  return launch<2, false>(ps, steps, src, counts, units, n, S, U, HP, WP, HR,
                          WR, bd, 0, ctb_log2, stream);
}

}  // extern "C"
