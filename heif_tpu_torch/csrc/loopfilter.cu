// HEVC in-loop filters for Hopper: deblocking (H.265 §8.7.2) and sample
// adaptive offset (§8.7.3) over a batch of tiles.
//
// No Pallas kernel stands behind them. heif_tpu runs these stages as jnp
// code inside `_core` (heif_tpu/ops/batch.py:565 stage 3 and :631 stage 4,
// through jax_recon._deblock_luma_pass :530, _deblock_chroma_pass :611 and
// sao_component :646), which XLA compiles into a few fusions. The port
// ran the same stages as about 1,400 eager torch ops a batch; those ops
// stay, as ops/loopfilter.py deblock_plain and sao_plain, the oracle that
// these kernels equal bit for bit.
//
// What bounds them: bytes. A 16-tile chunk of 512x512 4:2:0 int32 planes
// is 25.2 MB; each sample takes a few dozen integer operations at most,
// far below the card's integer rate. Read once and written once, the
// planes take 15 us at 3.35 TB/s (ops/loopfilter.py:loopfilter_bytes).
// So each kernel reads every plane once and writes it once, in one
// launch, with its reuse in shared memory.
//
// Both kernels cut a tile into regions of RH x RW luma samples and the
// RH/2 x RW/2 chroma samples under them (4:2:0): one block a region of
// one tile, all three planes, grid (column, row, tile) with 32-bit
// offsets inside a tile. A block stages its region plus a halo in shared
// memory, clipped at the picture's border, works there and writes only
// its region, in 16-byte stores (the outputs are contiguous and W % 8 ==
// 0, so every output row starts 16-byte aligned).
//
// - deblock: the halo is 4 luma samples (what a luma edge reads) and 2
//   chroma samples on every side. The block stages the 4x4 maps (edge
//   flags of both directions, QpY, bypass) under region and halo and
//   the beta / tc / chroma QP tables, applies every vertical edge that
//   changes a sample of the region to all staged rows, the halo rows too
//   (a vertical edge touches only its own row, so that is exact), then,
//   after a barrier, every horizontal edge that changes a sample of the
//   region: those on the region's top and bottom rows read exactly the
//   vertically filtered samples that §8.7.2 orders before them. Two
//   blocks may filter the same edge on their shared border; each writes
//   only its own rows, and no block reads another block's output. A
//   thread takes one decision unit: a 4-line segment of one luma edge,
//   or a 2-line one of a chroma edge.
//   Shared memory is read and written in 16-byte row pieces (8 bytes for
//   chroma's horizontal edges), lanes laid out so that a quarter warp
//   hits 8 different banks (vertical edges: see load8).
//   The input planes are the intra walk's views at [1:, 1:] of padded
//   planes whose rows are 2,308 B (luma) and 1,284 B (chroma) apart, 4
//   mod 16, so most rows start off 16-byte alignment. TMA cannot take
//   them (its global strides are multiples of 16 B), and 16-byte loads
//   cannot either; the block stages them with 4-byte loads,
//   neighbouring threads on neighbouring samples of a row, each warp's
//   load one 128-byte span, every load of a thread issued before its
//   first store to shared memory.
// - SAO: the halo is one sample. The block stages the SAO parameters of
//   the CTBs under its region ([3, 6] each, at most 8 at CTB 16) and the
//   bypass bits under it, once; a thread takes 4 consecutive samples of
//   a row, reads them and their edge-offset neighbours from shared
//   memory and writes them in one 16-byte store. The input is staged in
//   16-byte loads where it is aligned (the deblocked planes), in 4-byte
//   loads where it is not (the intra view, when deblocking is off).
// Still untried: SAO in the deblocking launch (a halo of 4 + 1), SAO
// writing the uint8 / int16 output itself.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// a block's luma region (chroma: half of each), deblocking and SAO alike
constexpr int DB_RH = 32;
constexpr int DB_RW = 64;
constexpr int SAO_RH = 32;
constexpr int SAO_RW = 64;
// staged samples around a region: deblocking's luma and chroma rows
// and columns (what an edge reads), SAO's (an edge offset's neighbours)
constexpr int HALO_L = 4;
constexpr int HALO_C = 2;
constexpr int SAO_HALO = 1;
// the shared-memory column of a region's first sample: a region row
// starts 16-byte aligned there
constexpr int XO = 4;
static_assert(XO % 4 == 0 && XO >= HALO_L && XO >= HALO_C, "room for halos");

// deblocking's staged planes and maps
constexpr int LROWS = DB_RH + 2 * HALO_L;    // 40
constexpr int LCOLS = DB_RW + 2 * HALO_L;    // luma columns staged: 72
constexpr int LPITCH = DB_RW + 2 * XO;       // 72
constexpr int CRH = DB_RH / 2, CRW = DB_RW / 2;
constexpr int CROWS = CRH + 2 * HALO_C;      // 20
constexpr int CPITCH = CRW + 2 * XO;         // 40
constexpr int CLOAD = CRW + 2 * HALO_C;      // chroma columns staged: 36
constexpr int MROWS = DB_RH / 4 + 2;         // 4x4 rows y0/4 - 1 ...
constexpr int MCOLS = DB_RW / 4 + 2;         // 4x4 columns x0/4 - 1 ...
// decision units a block: vertical edges (segments x edges), then
// horizontal ones (edges x segments), luma then both chroma planes
constexpr int LV_SEGS = LROWS / 4, LV_EDGES = DB_RW / 8 + 1;     // 10, 9
constexpr int CV_SEGS = CROWS / 2, CV_EDGES = CRW / 8 + 1;       // 10, 5
constexpr int LH_EDGES = DB_RH / 8 + 1, LH_SEGS = DB_RW / 4;     // 5, 16
constexpr int CH_EDGES = CRH / 8 + 1, CH_SEGS = CRW / 2;         // 3, 16
// vertical edges in lanes of 8: 4 edges of 2 segments (see the kernel);
// chroma's last edge (CV_EDGES - 1) a lane each
constexpr int LV_GROUPS = (LV_EDGES + 3) / 4 * (LV_SEGS / 2);
constexpr int CV_GROUPS = (CV_EDGES - 1) / 4 * (CV_SEGS / 2);  // a plane's
constexpr int LV_LANES = 8 * LV_GROUPS;                 // 120
constexpr int CV_LANES = 2 * 8 * CV_GROUPS;             // 80
constexpr int V_LANES = LV_LANES + CV_LANES + 2 * CV_SEGS;  // 220
constexpr int H_UNITS = LH_EDGES * LH_SEGS + 2 * CH_EDGES * CH_SEGS;  // 176
static_assert(LV_SEGS % 2 == 0 && CV_SEGS == LV_SEGS && CV_EDGES % 4 == 1,
              "segments in pairs; chroma edges in fours, then the last");
static_assert(DB_RH % 8 == 0 && DB_RW % 64 == 0, "regions of whole edges");
static_assert(THREADS >= 64, "a table entry a thread");

// SAO's staged planes: one sample of halo, rows start 16-byte aligned
constexpr int SROWS = SAO_RH + 2 * SAO_HALO, SPITCH = SAO_RW + 2 * XO;
constexpr int SCROWS = SAO_RH / 2 + 2 * SAO_HALO;
constexpr int SCPITCH = SAO_RW / 2 + 2 * XO;
constexpr int SAO_FIELDS = 6;  // type, class, 4 offsets
constexpr int MAX_CTB_COLS = SAO_RW / 16;  // CTBs under a region, CTB 16
constexpr int MAX_CTBS = (SAO_RH / 16) * MAX_CTB_COLS;
constexpr int SAO_GROUPS = (SAO_RH * SAO_RW + SAO_RH * SAO_RW / 2) / 4;
static_assert(SAO_RH % 16 == 0 && SAO_RW % 16 == 0,
              "regions of whole CTBs of 16 (the smallest)");

// One plane of the batch: `in` is [n, h, w] with element strides sn, sh
// and unit column stride; `out` is [n, h, w] contiguous (null: skip).
// vec: `in` may be read in 16-byte vectors (base, sn and sh aligned).
struct PlaneIO {
  const int32_t* in;
  int32_t* out;
  long long sn;
  int sh, h, w, vec;
};

struct DeblockArgs {
  PlaneIO p[3];            // Y, Cb, Cr
  const uint8_t* vedges;   // [n, H4, W4] bool: vertical edges
  const uint8_t* hedges;   // [n, H4, W4] bool: horizontal edges
  const int32_t* qp;       // [n, H4, W4] QpY per 4x4 block
  const uint8_t* nf;       // [n, H4, W4] bool: samples left unfiltered
  const int32_t* beta;     // [52]
  const int32_t* tc;       // [54]
  const int32_t* cqp;      // [58] chroma QP from qPi
  int H4, W4;
  int beta_off, tc_off, c_off[2], bd_y, bd_c;
};

struct SaoArgs {
  PlaneIO p[3];
  const int32_t* sao;      // [n, R, C, 3, 6]: type, class, 4 offsets
  const uint8_t* nf;       // [n, H4, W4]
  int R, C, H4, W4, ctb_log2, bd[3];
};

__device__ __forceinline__ int clip3(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// The luma filter of one 4-line segment across an edge: s[i] holds line
// i's p3 p2 p1 p0 q0 q1 q2 q3. Decisions on lines 0 and 3 (§8.7.2.5.3),
// then the strong or weak filter on all 4 lines. Returns whether any
// sample may have changed.
__device__ __forceinline__ bool luma_edge(int (&s)[4][8], int beta, int tc,
                                          bool nf_p, bool nf_q, int bd) {
  const int dp0 = abs(s[0][1] - 2 * s[0][2] + s[0][3]);
  const int dq0 = abs(s[0][6] - 2 * s[0][5] + s[0][4]);
  const int dp3 = abs(s[3][1] - 2 * s[3][2] + s[3][3]);
  const int dq3 = abs(s[3][6] - 2 * s[3][5] + s[3][4]);
  if (!(dp0 + dq0 + dp3 + dq3 < beta && (beta > 0 || tc > 0))) return false;
  if (nf_p && nf_q) return false;
  const int tc5 = (5 * tc + 1) >> 1;
  const bool strong =
      2 * (dp0 + dq0) < (beta >> 2) &&
      abs(s[0][0] - s[0][3]) + abs(s[0][4] - s[0][7]) < (beta >> 3) &&
      abs(s[0][3] - s[0][4]) < tc5 &&
      2 * (dp3 + dq3) < (beta >> 2) &&
      abs(s[3][0] - s[3][3]) + abs(s[3][4] - s[3][7]) < (beta >> 3) &&
      abs(s[3][3] - s[3][4]) < tc5;
  const int side = (beta + (beta >> 1)) >> 3;
  const bool dep = dp0 + dp3 < side;
  const bool deq = dq0 + dq3 < side;
  const int mxv = (1 << bd) - 1;
  const int tc2 = 2 * tc;
  const int tch = tc >> 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p3 = s[i][0], p2 = s[i][1], p1 = s[i][2], p0 = s[i][3];
    const int q0 = s[i][4], q1 = s[i][5], q2 = s[i][6], q3 = s[i][7];
    int np0 = p0, np1 = p1, np2 = p2, nq0 = q0, nq1 = q1, nq2 = q2;
    if (strong) {
      np0 = clip3((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0 - tc2,
                  p0 + tc2);
      np1 = clip3((p2 + p1 + p0 + q0 + 2) >> 2, p1 - tc2, p1 + tc2);
      np2 = clip3((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2 - tc2,
                  p2 + tc2);
      nq0 = clip3((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3, q0 - tc2,
                  q0 + tc2);
      nq1 = clip3((q2 + q1 + q0 + p0 + 2) >> 2, q1 - tc2, q1 + tc2);
      nq2 = clip3((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2 - tc2,
                  q2 + tc2);
    } else {
      const int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
      if (abs(delta) < tc * 10) {
        const int dl = clip3(delta, -tc, tc);
        np0 = clip3(p0 + dl, 0, mxv);
        nq0 = clip3(q0 - dl, 0, mxv);
        if (dep)
          np1 = clip3(p1 + clip3((((p2 + p0 + 1) >> 1) - p1 + dl) >> 1, -tch,
                                 tch),
                      0, mxv);
        if (deq)
          nq1 = clip3(q1 + clip3((((q2 + q0 + 1) >> 1) - q1 - dl) >> 1, -tch,
                                 tch),
                      0, mxv);
      }
    }
    if (!nf_p) {
      s[i][1] = np2;
      s[i][2] = np1;
      s[i][3] = np0;
    }
    if (!nf_q) {
      s[i][4] = nq0;
      s[i][5] = nq1;
      s[i][6] = nq2;
    }
  }
  return true;
}

// The chroma filter of one 2-line segment (§8.7.2.5.5): s[i] holds line
// i's p1 p0 q0 q1. Returns whether any sample may have changed.
__device__ __forceinline__ bool chroma_edge(int (&s)[2][4], int tc, bool nf_p,
                                            bool nf_q, int bd) {
  if (!(tc > 0) || (nf_p && nf_q)) return false;
  const int mxv = (1 << bd) - 1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p1 = s[i][0], p0 = s[i][1], q0 = s[i][2], q1 = s[i][3];
    const int delta = clip3((((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tc, tc);
    if (!nf_p) s[i][1] = clip3(p0 + delta, 0, mxv);
    if (!nf_q) s[i][2] = clip3(q0 - delta, 0, mxv);
  }
  return true;
}

struct DeblockSmem {
  __align__(16) int32_t y[LROWS][LPITCH];     // luma rows y0 - HALO_L ...
  __align__(16) int32_t c[2][CROWS][CPITCH];  // rows y0/2 - HALO_C ...
  int32_t qp[MROWS][MCOLS];
  uint8_t flags[MROWS][MCOLS];  // 1: vertical edge, 2: horizontal, 4: bypass
  int32_t beta[52], tc[54], cqp[58];
};

// A plane's region plus halo on its way into shared memory: ROWS x COLS
// samples from (gy0, gx0), those that lie in the picture. load() issues
// a thread's loads into registers, store() puts them in shared memory;
// a kernel issues every load of a thread before its first store, so that
// all of them are in flight together. Neighbouring threads take
// neighbouring samples of a row.
template <int ROWS, int COLS>
struct Staged {
  static constexpr int N = ROWS * COLS;
  static constexpr int ITERS = (N + THREADS - 1) / THREADS;
  int v[ITERS];
  unsigned ok = 0;  // bit k: v[k] was loaded

  __device__ __forceinline__ void load(const int32_t* in, int sh, int h,
                                       int w, int gy0, int gx0) {
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      const int i = threadIdx.x + k * THREADS;
      const int y = gy0 + i / COLS, x = gx0 + i % COLS;
      if (i < N && y >= 0 && y < h && x >= 0 && x < w) {
        v[k] = __ldg(in + y * sh + x);
        ok |= 1u << k;
      }
    }
  }
  // sample (r, c) to dst[r * pitch + col0 + c]
  __device__ __forceinline__ void store(int32_t* dst, int pitch,
                                        int col0) const {
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      const int i = threadIdx.x + k * THREADS;
      if (ok >> k & 1) dst[i / COLS * pitch + col0 + i % COLS] = v[k];
    }
  }
};

// The same in 16-byte vectors: ROWS x 4 VECS samples from (gy0, gx0),
// gx0 and the input's row starts 16-byte aligned; the picture's width
// less gx0 is a multiple of 4.
template <int ROWS, int VECS>
struct StagedVec {
  static constexpr int N = ROWS * VECS;
  static constexpr int ITERS = (N + THREADS - 1) / THREADS;
  int4 v[ITERS];
  unsigned ok = 0;

  __device__ __forceinline__ void load(const int32_t* in, int sh, int h,
                                       int w, int gy0, int gx0) {
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      const int i = threadIdx.x + k * THREADS;
      const int y = gy0 + i / VECS, x = gx0 + 4 * (i % VECS);
      if (i < N && y >= 0 && y < h && x < w) {
        v[k] = __ldg(reinterpret_cast<const int4*>(in + y * sh + x));
        ok |= 1u << k;
      }
    }
  }
  __device__ __forceinline__ void store(int32_t* dst, int pitch,
                                        int col0) const {
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      const int i = threadIdx.x + k * THREADS;
      if (ok >> k & 1)
        *reinterpret_cast<int4*>(dst + i / VECS * pitch + col0 +
                                 4 * (i % VECS)) = v[k];
    }
  }
};

// 8 staged samples at `p` (16-byte aligned) as two 16-byte halves, the
// second half first where `flip` is set: lanes that differ in flip read
// the same pair of halves in other orders, and so other banks.
__device__ __forceinline__ void load8(const int32_t* p, bool flip,
                                      int (&d)[8]) {
  const int4 a = *reinterpret_cast<const int4*>(p + (flip ? 4 : 0));
  const int4 b = *reinterpret_cast<const int4*>(p + (flip ? 0 : 4));
  const int4 lo = flip ? b : a, hi = flip ? a : b;
  d[0] = lo.x, d[1] = lo.y, d[2] = lo.z, d[3] = lo.w;
  d[4] = hi.x, d[5] = hi.y, d[6] = hi.z, d[7] = hi.w;
}

__device__ __forceinline__ void store8(int32_t* p, bool flip,
                                       const int (&d)[8]) {
  const int4 lo = make_int4(d[0], d[1], d[2], d[3]);
  const int4 hi = make_int4(d[4], d[5], d[6], d[7]);
  *reinterpret_cast<int4*>(p + (flip ? 4 : 0)) = flip ? hi : lo;
  *reinterpret_cast<int4*>(p + (flip ? 0 : 4)) = flip ? lo : hi;
}

// 4 consecutive staged samples at `src` to the output, in 16 bytes
__device__ __forceinline__ void store4(int32_t* out, const int32_t* src) {
  *reinterpret_cast<int4*>(out) = *reinterpret_cast<const int4*>(src);
}

// Where a deblocking block works: its region's origin in luma (x0, y0)
// and chroma (xc0, yc0) samples, the plane sizes.
struct Region {
  int x0, y0, xc0, yc0, H, W, Hc, Wc;
};

__device__ __forceinline__ int luma_beta(const DeblockSmem& sm,
                                         const DeblockArgs& a, int qp_avg) {
  return sm.beta[clip3(qp_avg + a.beta_off, 0, 51)] << (a.bd_y - 8);
}

__device__ __forceinline__ int luma_tc(const DeblockSmem& sm,
                                       const DeblockArgs& a, int qp_avg) {
  return sm.tc[clip3(qp_avg + 2 + a.tc_off, 0, 53)] << (a.bd_y - 8);
}

__device__ __forceinline__ int chroma_tc(const DeblockSmem& sm,
                                         const DeblockArgs& a, int qp_avg,
                                         int k) {
  const int qpc = sm.cqp[clip3(qp_avg + a.c_off[k], 0, 57)];
  return sm.tc[clip3(qpc + 2 + a.tc_off, 0, 53)] << (a.bd_c - 8);
}

// Vertical edges. Luma segment `seg` covers staged rows 4 seg .. 4 seg +
// 3; its edge k lies at x0 + 8k and reads staged columns 8k .. 8k + 7.
// Chroma segments cover 2 rows; edge e at xc0 + 8e reads staged columns
// 8e + 2 .. 8e + 5 of the 16-byte-aligned 8e .. 8e + 7. Each line is
// read and written as two 16-byte halves in the order `f` gives (load8):
// the 8 lanes of a quarter warp take 4 edges (k mod 4) of 2 segments,
// one flipped, and so hit 8 different banks. The 4x4 map column of the
// edge (Q side) is q, the P side's q - 1.
__device__ __forceinline__ void luma_vertical(DeblockSmem& sm,
                                              const DeblockArgs& a,
                                              const Region& rg, int lane) {
  const int f = (lane >> 2) & 1, g = lane >> 3;
  const int seg = 2 * (g % (LV_SEGS / 2)) + f;
  const int k = 4 * (g / (LV_SEGS / 2)) + (lane & 3);
  const int gy = rg.y0 - HALO_L + 4 * seg, gx = rg.x0 + 8 * k;
  const int q = 2 * k + 1;
  if (k >= LV_EDGES || gy < 0 || gy >= rg.H || gx <= 0 || gx >= rg.W ||
      !(sm.flags[seg][q] & 1))
    return;
  const int qp_avg = (sm.qp[seg][q - 1] + sm.qp[seg][q] + 1) >> 1;
  int s[4][8];
  int32_t* base = &sm.y[4 * seg][XO - 4 + 8 * k];
#pragma unroll
  for (int i = 0; i < 4; ++i) load8(base + i * LPITCH, f, s[i]);
  if (luma_edge(s, luma_beta(sm, a, qp_avg), luma_tc(sm, a, qp_avg),
                sm.flags[seg][q - 1] & 4, sm.flags[seg][q] & 4, a.bd_y)) {
#pragma unroll
    for (int i = 0; i < 4; ++i) store8(base + i * LPITCH, f, s[i]);
  }
}

// chroma lane u: edges 0 .. CV_EDGES - 2 in fours, paired as luma's,
// then the last edge (xc0 + CRW) a lane each
__device__ __forceinline__ void chroma_vertical(DeblockSmem& sm,
                                                const DeblockArgs& a,
                                                const Region& rg, int u) {
  int k, seg, e, f = 0;
  if (u < CV_LANES) {
    const int g = u >> 3, h = g % CV_GROUPS;
    f = (u >> 2) & 1;
    k = g / CV_GROUPS;
    seg = 2 * (h % (CV_SEGS / 2)) + f;
    e = 4 * (h / (CV_SEGS / 2)) + (u & 3);
  } else {
    k = (u - CV_LANES) / CV_SEGS;
    seg = (u - CV_LANES) % CV_SEGS;
    e = CV_EDGES - 1;
  }
  const int gy = rg.yc0 - HALO_C + 2 * seg, gx = rg.xc0 + 8 * e;
  const int q = 4 * e + 1;
  if (gy < 0 || gy >= rg.Hc || gx <= 0 || gx >= rg.Wc ||
      !(sm.flags[seg][q] & 1))
    return;
  const int qp_avg = (sm.qp[seg][q - 1] + sm.qp[seg][q] + 1) >> 1;
  int d[2][8], s[2][4];
  int32_t* base = &sm.c[k][2 * seg][XO - 4 + 8 * e];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    load8(base + i * CPITCH, f, d[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = d[i][2 + j];
  }
  if (chroma_edge(s, chroma_tc(sm, a, qp_avg, k), sm.flags[seg][q - 1] & 4,
                  sm.flags[seg][q] & 4, a.bd_c)) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      d[i][3] = s[i][1];
      d[i][4] = s[i][2];
      store8(base + i * CPITCH, f, d[i]);
    }
  }
}

// Horizontal edges. Luma edge k at y0 + 8k reads staged rows 8k .. 8k +
// 7, its segment j columns x0 + 4j .. + 3: a 16-byte row piece. Chroma
// edge e at yc0 + 8e reads staged rows 8e .. 8e + 3, segment j columns
// xc0 + 2j, + 1: 8 bytes. Neighbouring lanes take neighbouring segments
// of one edge, and so different banks. The 4x4 map row of the edge (Q
// side) is q, the P side's q - 1.
__device__ __forceinline__ void luma_horizontal(DeblockSmem& sm,
                                                const DeblockArgs& a,
                                                const Region& rg, int lane) {
  const int k = lane / LH_SEGS, j = lane % LH_SEGS;
  const int gy = rg.y0 + 8 * k, gx = rg.x0 + 4 * j;
  const int q = 2 * k + 1, col = j + 1;
  if (gy <= 0 || gy >= rg.H || gx >= rg.W || !(sm.flags[q][col] & 2)) return;
  const int qp_avg = (sm.qp[q - 1][col] + sm.qp[q][col] + 1) >> 1;
  int s[4][8];
  int32_t* base = &sm.y[8 * k][XO + 4 * j];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int4 r = *reinterpret_cast<const int4*>(base + jj * LPITCH);
    s[0][jj] = r.x;
    s[1][jj] = r.y;
    s[2][jj] = r.z;
    s[3][jj] = r.w;
  }
  if (luma_edge(s, luma_beta(sm, a, qp_avg), luma_tc(sm, a, qp_avg),
                sm.flags[q - 1][col] & 4, sm.flags[q][col] & 4, a.bd_y)) {
#pragma unroll
    for (int jj = 1; jj < 7; ++jj)
      *reinterpret_cast<int4*>(base + jj * LPITCH) =
          make_int4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
  }
}

__device__ __forceinline__ void chroma_horizontal(DeblockSmem& sm,
                                                  const DeblockArgs& a,
                                                  const Region& rg, int u) {
  const int k = u / (CH_EDGES * CH_SEGS);
  const int e = u % (CH_EDGES * CH_SEGS) / CH_SEGS, j = u % CH_SEGS;
  const int gy = rg.yc0 + 8 * e, gx = rg.xc0 + 2 * j;
  const int q = 4 * e + 1, col = j + 1;
  if (gy <= 0 || gy >= rg.Hc || gx >= rg.Wc || !(sm.flags[q][col] & 2))
    return;
  const int qp_avg = (sm.qp[q - 1][col] + sm.qp[q][col] + 1) >> 1;
  int s[2][4];
  int32_t* base = &sm.c[k][8 * e][XO + 2 * j];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int2 r = *reinterpret_cast<const int2*>(base + jj * CPITCH);
    s[0][jj] = r.x;
    s[1][jj] = r.y;
  }
  if (chroma_edge(s, chroma_tc(sm, a, qp_avg, k), sm.flags[q - 1][col] & 4,
                  sm.flags[q][col] & 4, a.bd_c)) {
    *reinterpret_cast<int2*>(base + CPITCH) = make_int2(s[0][1], s[1][1]);
    *reinterpret_cast<int2*>(base + 2 * CPITCH) = make_int2(s[0][2], s[1][2]);
  }
}

__global__ void __launch_bounds__(THREADS) deblock_kernel(DeblockArgs a) {
  __shared__ DeblockSmem sm;
  const int t = blockIdx.z, tid = threadIdx.x;
  const int x0 = blockIdx.x * DB_RW, y0 = blockIdx.y * DB_RH;
  const Region rg{x0, y0, x0 / 2, y0 / 2, a.p[0].h, a.p[0].w, a.p[1].h,
                  a.p[1].w};

  // every global load first: tables, maps, the three planes
  const int my0 = y0 / 4 - 1, mx0 = x0 / 4 - 1;
  constexpr int MAPS = MROWS * MCOLS;
  constexpr int MAP_ITERS = (MAPS + THREADS - 1) / THREADS;
  int m_qp[MAP_ITERS], m_flags[MAP_ITERS];
#pragma unroll
  for (int k = 0; k < MAP_ITERS; ++k) {
    const int i = tid + k * THREADS;
    const int my = my0 + i / MCOLS, mx = mx0 + i % MCOLS;
    m_flags[k] = -1;  // outside the maps
    if (i < MAPS && my >= 0 && my < a.H4 && mx >= 0 && mx < a.W4) {
      const int m = (t * a.H4 + my) * a.W4 + mx;
      m_qp[k] = __ldg(a.qp + m);
      m_flags[k] = (a.vedges[m] ? 1 : 0) | (a.hedges[m] ? 2 : 0) |
                   (a.nf[m] ? 4 : 0);
    }
  }
  const int tb = tid < 52 ? __ldg(a.beta + tid) : 0;
  const int tt = tid < 54 ? __ldg(a.tc + tid) : 0;
  const int tq = tid < 58 ? __ldg(a.cqp + tid) : 0;
  Staged<LROWS, LCOLS> ly;
  ly.load(a.p[0].in + t * a.p[0].sn, a.p[0].sh, rg.H, rg.W, y0 - HALO_L,
          x0 - HALO_L);
  Staged<CROWS, CLOAD> lc[2];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    lc[k].load(a.p[1 + k].in + t * a.p[1 + k].sn, a.p[1 + k].sh, rg.Hc,
               rg.Wc, rg.yc0 - HALO_C, rg.xc0 - HALO_C);
#pragma unroll
  for (int k = 0; k < MAP_ITERS; ++k) {
    const int i = tid + k * THREADS;
    if (m_flags[k] >= 0) {
      sm.qp[i / MCOLS][i % MCOLS] = m_qp[k];
      sm.flags[i / MCOLS][i % MCOLS] = m_flags[k];
    }
  }
  if (tid < 52) sm.beta[tid] = tb;
  if (tid < 54) sm.tc[tid] = tt;
  if (tid < 58) sm.cqp[tid] = tq;
  ly.store(&sm.y[0][0], LPITCH, XO - HALO_L);
#pragma unroll
  for (int k = 0; k < 2; ++k) lc[k].store(&sm.c[k][0][0], CPITCH, XO - HALO_C);
  __syncthreads();

  for (int lane = tid; lane < V_LANES; lane += THREADS) {
    if (lane < LV_LANES)
      luma_vertical(sm, a, rg, lane);
    else
      chroma_vertical(sm, a, rg, lane - LV_LANES);
  }
  __syncthreads();
  for (int lane = tid; lane < H_UNITS; lane += THREADS) {
    if (lane < LH_EDGES * LH_SEGS)
      luma_horizontal(sm, a, rg, lane);
    else
      chroma_horizontal(sm, a, rg, lane - LH_EDGES * LH_SEGS);
  }
  __syncthreads();

  // the region, never the halo, in 16-byte stores
  constexpr int LV = DB_RW / 4, CV = CRW / 4;
  for (int i = tid; i < DB_RH * LV + 2 * CRH * CV; i += THREADS) {
    if (i < DB_RH * LV) {
      const int r = i / LV, x = 4 * (i % LV);
      if (y0 + r < rg.H && x0 + x < rg.W)
        store4(a.p[0].out + (long long)t * rg.H * rg.W + (y0 + r) * rg.W +
                   x0 + x,
               &sm.y[HALO_L + r][XO + x]);
    } else {
      const int u = i - DB_RH * LV;
      const int k = u / (CRH * CV), r = u % (CRH * CV) / CV;
      const int x = 4 * (u % CV);
      if (rg.yc0 + r < rg.Hc && rg.xc0 + x < rg.Wc)
        store4(a.p[1 + k].out + (long long)t * rg.Hc * rg.Wc +
                   (rg.yc0 + r) * rg.Wc + rg.xc0 + x,
               &sm.c[k][HALO_C + r][XO + x]);
    }
  }
}

__device__ __forceinline__ int sign(int v) { return (v > 0) - (v < 0); }

struct SaoSmem {
  __align__(16) int32_t y[SROWS][SPITCH];       // rows y0 - SAO_HALO ...
  __align__(16) int32_t c[2][SCROWS][SCPITCH];  // rows y0/2 - SAO_HALO ...
  int32_t prm[MAX_CTBS][3][SAO_FIELDS];
  uint8_t nf[SAO_RH / 4][SAO_RW / 4];
};

// A plane's region plus one sample of halo on its way into shared
// memory (its region's first column at XO): in 16-byte loads for the
// region's columns and 4-byte loads for the two halo columns where the
// input is aligned (VEC), in 4-byte loads otherwise.
template <bool VEC, int ROWS, int RW>
struct SaoStaged;
static_assert(SAO_HALO == 1, "SaoStaged stages one halo column a side");

template <int ROWS, int RW>
struct SaoStaged<true, ROWS, RW> {
  StagedVec<ROWS, RW / 4> body;
  Staged<ROWS, 2> edge;  // columns -1 and RW, as 2 columns RW + 1 apart
  __device__ __forceinline__ void load(const PlaneIO& pl, int t, int gy0,
                                       int gx0) {
    const int32_t* in = pl.in + t * pl.sn;
    body.load(in, pl.sh, pl.h, pl.w, gy0, gx0);
    // column c of `edge` is sample column gx0 - 1 + c (RW + 1)
#pragma unroll
    for (int k = 0; k < Staged<ROWS, 2>::ITERS; ++k) {
      const int i = threadIdx.x + k * THREADS;
      const int y = gy0 + i / 2, x = gx0 - 1 + (i % 2) * (RW + 1);
      if (i < ROWS * 2 && y >= 0 && y < pl.h && x >= 0 && x < pl.w) {
        edge.v[k] = __ldg(in + y * pl.sh + x);
        edge.ok |= 1u << k;
      }
    }
  }
  __device__ __forceinline__ void store(int32_t* dst, int pitch) const {
    body.store(dst, pitch, XO);
#pragma unroll
    for (int k = 0; k < Staged<ROWS, 2>::ITERS; ++k) {
      const int i = threadIdx.x + k * THREADS;
      if (edge.ok >> k & 1)
        dst[i / 2 * pitch + XO - 1 + (i % 2) * (RW + 1)] = edge.v[k];
    }
  }
};

template <int ROWS, int RW>
struct SaoStaged<false, ROWS, RW> {
  Staged<ROWS, RW + 2 * SAO_HALO> all;
  __device__ __forceinline__ void load(const PlaneIO& pl, int t, int gy0,
                                       int gx0) {
    all.load(pl.in + t * pl.sn, pl.sh, pl.h, pl.w, gy0, gx0 - SAO_HALO);
  }
  __device__ __forceinline__ void store(int32_t* dst, int pitch) const {
    all.store(dst, pitch, XO - SAO_HALO);
  }
};

// SaoTypeIdx 1 (band) and 2 (edge) of 4 consecutive samples of a row;
// bypass samples, type 0 and any other type keep the sample. VEC: every
// enabled input may be read in 16-byte vectors.
template <bool VEC>
__global__ void __launch_bounds__(THREADS) sao_kernel(SaoArgs a) {
  __shared__ SaoSmem sm;
  const int t = blockIdx.z, tid = threadIdx.x;
  const int x0 = blockIdx.x * SAO_RW, y0 = blockIdx.y * SAO_RH;
  const int H = a.p[0].h, W = a.p[0].w;
  const int cl = a.ctb_log2;
  const int cy0 = y0 >> cl, cx0 = x0 >> cl;
  const int ncy = ((min(y0 + SAO_RH, H) - 1) >> cl) - cy0 + 1;
  const int ncx = ((min(x0 + SAO_RW, W) - 1) >> cl) - cx0 + 1;
  constexpr int CTB_INTS = 3 * SAO_FIELDS;
  // every global load first: parameters, bypass bits, the enabled planes
  constexpr int PRMS = MAX_CTBS * CTB_INTS, NFS = (SAO_RH / 4) * (SAO_RW / 4);
  constexpr int P_ITERS = (PRMS + THREADS - 1) / THREADS;
  constexpr int N_ITERS = (NFS + THREADS - 1) / THREADS;
  int p_val[P_ITERS], n_val[N_ITERS];
#pragma unroll
  for (int k = 0; k < P_ITERS; ++k) {
    const int i = tid + k * THREADS;
    const int ctb = i / CTB_INTS, ry = ctb / ncx, rx = ctb % ncx;
    p_val[k] = ctb < ncy * ncx
                   ? __ldg(a.sao + ((t * a.R + cy0 + ry) * a.C + cx0 + rx) *
                                       CTB_INTS + i % CTB_INTS)
                   : 0;
  }
#pragma unroll
  for (int k = 0; k < N_ITERS; ++k) {
    const int i = tid + k * THREADS;
    const int my = y0 / 4 + i / (SAO_RW / 4), mx = x0 / 4 + i % (SAO_RW / 4);
    n_val[k] = i < NFS && my < a.H4 && mx < a.W4
                   ? a.nf[(t * a.H4 + my) * a.W4 + mx]
                   : 0;
  }
  SaoStaged<VEC, SROWS, SAO_RW> ly;
  SaoStaged<VEC, SCROWS, SAO_RW / 2> lc[2];
  if (a.p[0].out) ly.load(a.p[0], t, y0 - SAO_HALO, x0);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (a.p[1 + k].out)
      lc[k].load(a.p[1 + k], t, y0 / 2 - SAO_HALO, x0 / 2);
#pragma unroll
  for (int k = 0; k < P_ITERS; ++k) {
    const int i = tid + k * THREADS;
    const int ctb = i / CTB_INTS;
    if (ctb < ncy * ncx)
      (&sm.prm[ctb / ncx * MAX_CTB_COLS + ctb % ncx][0][0])[i % CTB_INTS] =
          p_val[k];
  }
#pragma unroll
  for (int k = 0; k < N_ITERS; ++k) {
    const int i = tid + k * THREADS;
    if (i < NFS) (&sm.nf[0][0])[i] = n_val[k];
  }
  if (a.p[0].out) ly.store(&sm.y[0][0], SPITCH);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (a.p[1 + k].out) lc[k].store(&sm.c[k][0][0], SCPITCH);
  __syncthreads();

  // 4 samples a group: luma groups first, then Cb's, then Cr's
  constexpr int LG = SAO_RW / 4, CG = SAO_RW / 8;
  constexpr int LUMA_GROUPS = SAO_RH * LG, CHROMA_GROUPS = SAO_RH / 2 * CG;
  for (int g = tid; g < SAO_GROUPS; g += THREADS) {
    int comp, r, x;
    if (g < LUMA_GROUPS) {
      comp = 0;
      r = g / LG;
      x = 4 * (g % LG);
    } else {
      const int u = g - LUMA_GROUPS;
      comp = 1 + u / CHROMA_GROUPS;
      r = u % CHROMA_GROUPS / CG;
      x = 4 * (u % CG);
    }
    const PlaneIO& pl = a.p[comp];
    if (pl.out == nullptr) continue;
    const int sub = comp ? 1 : 0;  // log2 of the chroma subsampling
    const int gy = (y0 >> sub) + r, gx = (x0 >> sub) + x;
    if (gy >= pl.h || gx >= pl.w) continue;
    const int pitch = comp ? SCPITCH : SPITCH;
    const int32_t* c = comp ? &sm.c[comp - 1][SAO_HALO + r][XO + x]
                            : &sm.y[SAO_HALO + r][XO + x];
    const int4 s4 = *reinterpret_cast<const int4*>(c);
    int s[4] = {s4.x, s4.y, s4.z, s4.w};
    int v[4] = {s4.x, s4.y, s4.z, s4.w};
    const int ccl = cl - sub;
    const int32_t* prm =
        sm.prm[((gy >> ccl) - cy0) * MAX_CTB_COLS + (gx >> ccl) - cx0][comp];
    const int type = prm[0];
    // the bypass bits of the 4x4 luma blocks under the samples
    const int nrow = comp ? r >> 1 : r >> 2;
    const bool nf0 = sm.nf[nrow][comp ? x >> 1 : x >> 2];
    const bool nf1 = sm.nf[nrow][comp ? (x >> 1) + 1 : x >> 2];
    const int bd = a.bd[comp];
    const int mxv = (1 << bd) - 1;
    const int scale = 1 << (bd - min(bd, 10));
    if (type == 1) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int band = s[k] >> (bd - 5);
        int dlt = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (band == ((prm[1] + i) & 31)) dlt += prm[2 + i] * scale;
        v[k] = clip3(s[k] + dlt, 0, mxv);
      }
    } else if (type == 2) {
      // neighbours (dx0, dy0) and (-dx0, -dy0) of the four edge classes
      const int cls = prm[1];
      const bool eo = cls >= 0 && cls < 4;
      const int dx0 = cls == 1 ? 0 : (cls == 3 ? 1 : -1);
      const int dy0 = cls == 0 ? 0 : -1;
      const bool rows_in = eo && gy + dy0 >= 0 && gy + dy0 < pl.h &&
                           gy - dy0 >= 0 && gy - dy0 < pl.h;
      const int32_t* na = c + dy0 * pitch + dx0;
      const int32_t* nb = c - dy0 * pitch - dx0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ax = gx + k + dx0, bx = gx + k - dx0;
        int dlt = 0;
        if (rows_in && ax >= 0 && ax < pl.w && bx >= 0 && bx < pl.w) {
          const int sg = sign(s[k] - na[k]) + sign(s[k] - nb[k]);
          const int e = sg == -2 ? 0 : sg == -1 ? 1 : sg == 1 ? 2
                        : sg == 2 ? 3 : -1;
          if (e >= 0) dlt = prm[2 + e] * scale;
        }
        v[k] = clip3(s[k] + dlt, 0, mxv);
      }
    }
    if (nf0) v[0] = s[0], v[1] = s[1];
    if (nf1) v[2] = s[2], v[3] = s[3];
    int32_t* out = pl.out + (long long)t * pl.h * pl.w + gy * pl.w + gx;
    *reinterpret_cast<int4*>(out) = make_int4(v[0], v[1], v[2], v[3]);
  }
}

PlaneIO plane_io(const void* in, void* out, long long sn, long long sh, int h,
                 int w) {
  PlaneIO p;
  p.in = static_cast<const int32_t*>(in);
  p.out = static_cast<int32_t*>(out);
  p.sn = sn;
  p.sh = (int)sh;
  p.h = h;
  p.w = w;
  p.vec = reinterpret_cast<uintptr_t>(in) % 16 == 0 && sn % 4 == 0 &&
          sh % 4 == 0;
  return p;
}

// one block a region of a tile: (columns, rows, tiles)
dim3 region_grid(int n, int H, int W, int rh, int rw) {
  return dim3((W + rw - 1) / rw, (H + rh - 1) / rh, n);
}

}  // namespace

extern "C" {

// Deblocking of n tiles of H x W luma (Y [n,H,W], Cb and Cr [n,H/2,W/2],
// int32) in one launch: every vertical edge (vedges), then every
// horizontal one (hedges), from the inputs (element strides sn_*, sh_*,
// unit column stride) into new contiguous outputs, every sample written.
// vedges, hedges, nf: [n, H/4, W/4] bool; qp: [n, H/4, W/4] int32; beta,
// tc, cqp: the int32 tables of tables.ReconTables. H and W are multiples
// of 8. Returns cudaGetLastError() after the launch on `stream`.
int heif_deblock(void* y, void* cb, void* cr, const void* y_in,
                 const void* cb_in, const void* cr_in, long long sn_y,
                 long long sh_y, long long sn_cb, long long sh_cb,
                 long long sn_cr, long long sh_cr, const void* vedges,
                 const void* hedges, const void* qp, const void* nf,
                 const void* beta, const void* tc, const void* cqp, int n,
                 int H, int W, int beta_off, int tc_off, int cb_off,
                 int cr_off, int bd_y, int bd_c, void* stream) {
  DeblockArgs a;
  a.p[0] = plane_io(y_in, y, sn_y, sh_y, H, W);
  a.p[1] = plane_io(cb_in, cb, sn_cb, sh_cb, H / 2, W / 2);
  a.p[2] = plane_io(cr_in, cr, sn_cr, sh_cr, H / 2, W / 2);
  a.vedges = static_cast<const uint8_t*>(vedges);
  a.hedges = static_cast<const uint8_t*>(hedges);
  a.qp = static_cast<const int32_t*>(qp);
  a.nf = static_cast<const uint8_t*>(nf);
  a.beta = static_cast<const int32_t*>(beta);
  a.tc = static_cast<const int32_t*>(tc);
  a.cqp = static_cast<const int32_t*>(cqp);
  a.H4 = H / 4;
  a.W4 = W / 4;
  a.beta_off = beta_off;
  a.tc_off = tc_off;
  a.c_off[0] = cb_off;
  a.c_off[1] = cr_off;
  a.bd_y = bd_y;
  a.bd_c = bd_c;
  deblock_kernel<<<region_grid(n, H, W, DB_RH, DB_RW), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// SAO over n tiles: the inputs (strides as above) into new contiguous
// outputs; a null output skips its plane. sao: [n, R, C, 3, 6] int32 per
// CTB (R, C: CTB rows and columns); nf: [n, H/4, W/4] bool. Returns
// cudaGetLastError() after the launch on `stream`.
int heif_sao(void* y, void* cb, void* cr, const void* y_in, const void* cb_in,
             const void* cr_in, long long sn_y, long long sh_y, long long sn_cb,
             long long sh_cb, long long sn_cr, long long sh_cr,
             const void* sao, const void* nf, int n, int H, int W, int R,
             int C, int ctb_log2, int bd_y, int bd_c, void* stream) {
  SaoArgs a;
  a.p[0] = plane_io(y_in, y, sn_y, sh_y, H, W);
  a.p[1] = plane_io(cb_in, cb, sn_cb, sh_cb, H / 2, W / 2);
  a.p[2] = plane_io(cr_in, cr, sn_cr, sh_cr, H / 2, W / 2);
  a.sao = static_cast<const int32_t*>(sao);
  a.nf = static_cast<const uint8_t*>(nf);
  a.R = R;
  a.C = C;
  a.H4 = H / 4;
  a.W4 = W / 4;
  a.ctb_log2 = ctb_log2;
  a.bd[0] = bd_y;
  a.bd[1] = bd_c;
  a.bd[2] = bd_c;
  bool vec = true;
  for (const PlaneIO& p : a.p)
    if (p.out) vec = vec && p.vec;
  const dim3 grid = region_grid(n, H, W, SAO_RH, SAO_RW);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    sao_kernel<true><<<grid, THREADS, 0, st>>>(a);
  else
    sao_kernel<false><<<grid, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
