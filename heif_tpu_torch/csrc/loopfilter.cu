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
//
// Design, correctness first:
// - deblock: two launches, each over all three planes (blockIdx.y is the
//   plane). Launch 0 takes every vertical edge from the input planes
//   (strided views, as the intra walk leaves them) into new contiguous
//   planes; launch 1 takes every horizontal edge in place on those. The
//   §8.7.2 order (all vertical edges of the picture before any
//   horizontal one) is the order of the two launches on one stream.
//   A thread owns one window of 8 samples across an edge position
//   (8c - 4 .. 8c + 3) on one segment along it: 4 lines of luma, 2 of
//   chroma, the units in which the decisions are made. Windows of one
//   launch never overlap, and an edge changes at most 3 samples on each
//   side, so no thread reads what another writes. Windows at c = 0 and
//   past the last edge only copy (launch 0) or do nothing (launch 1).
//   Launch 0 puts the window's samples of a row side by side in a warp
//   (neighbouring threads, neighbouring windows of one segment); launch
//   1 puts neighbouring segments side by side, so both read rows.
// - SAO: one launch, one thread per sample of every enabled plane. It
//   reads the per-CTB parameters and the 4x4 bypass map where the sample
//   lies, never upsampled per-sample maps, and the deblocked samples of
//   the input only, so it writes to new planes.
// Shared-memory tiles, wider loads and TMA are left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// One plane of the batch: `in` is [n, h, w] with element strides sn, sh
// and unit column stride; `out` is [n, h, w] contiguous (null: skip).
struct PlaneIO {
  const int32_t* in;
  int32_t* out;
  long long sn, sh;
  int h, w;
};

struct DeblockArgs {
  PlaneIO p[3];            // Y, Cb, Cr
  const uint8_t* edges;    // [n, H4, W4] bool: edges of this pass
  const int32_t* qp;       // [n, H4, W4] QpY per 4x4 block
  const uint8_t* nf;       // [n, H4, W4] bool: samples left unfiltered
  const int32_t* beta;     // [52]
  const int32_t* tc;       // [54]
  const int32_t* cqp;      // [58] chroma QP from qPi
  int n, H4, W4;
  int beta_off, tc_off, c_off[2], bd_y, bd_c;
};

struct SaoArgs {
  PlaneIO p[3];
  const int32_t* sao;      // [n, R, C, 3, 6]: type, class, 4 offsets
  const uint8_t* nf;       // [n, H4, W4]
  int n, R, C, H4, W4, ctb_log2, bd[3];
};

__device__ __forceinline__ int clip3(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// The luma filter of one 4-line segment across an edge: s[i] holds line
// i's p3 p2 p1 p0 q0 q1 q2 q3. Decisions on lines 0 and 3 (§8.7.2.5.3),
// then the strong or weak filter on all 4 lines. Returns whether any
// sample may have changed.
__device__ __forceinline__ bool luma_edge(int (&s)[4][8], int qp_p, int qp_q,
                                          bool nf_p, bool nf_q,
                                          const DeblockArgs& a) {
  const int bd = a.bd_y;
  const int qp_avg = (qp_p + qp_q + 1) >> 1;
  const int beta = a.beta[clip3(qp_avg + a.beta_off, 0, 51)] << (bd - 8);
  const int tc = a.tc[clip3(qp_avg + 2 + a.tc_off, 0, 53)] << (bd - 8);
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

// The chroma filter of one 2-line segment (§8.7.2.5.5): p1 p0 q0 q1 are
// s[i][2..5]; the chroma QP comes from the averaged luma QP plus the
// component's offset, through the table.
__device__ __forceinline__ bool chroma_edge(int (&s)[2][8], int qp_p, int qp_q,
                                            bool nf_p, bool nf_q, int c_off,
                                            const DeblockArgs& a) {
  const int bd = a.bd_c;
  const int qpc = a.cqp[clip3(((qp_p + qp_q + 1) >> 1) + c_off, 0, 57)];
  const int tc = a.tc[clip3(qpc + 2 + a.tc_off, 0, 53)] << (bd - 8);
  if (!(tc > 0) || (nf_p && nf_q)) return false;
  const int mxv = (1 << bd) - 1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p1 = s[i][2], p0 = s[i][3], q0 = s[i][4], q1 = s[i][5];
    const int delta = clip3((((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tc, tc);
    if (!nf_p) s[i][3] = clip3(p0 + delta, 0, mxv);
    if (!nf_q) s[i][4] = clip3(q0 - delta, 0, mxv);
  }
  return true;
}

// One window of one plane. VERT: line i of the segment is row seg*L + i
// and position j is column 8c - 4 + j; otherwise the two are swapped.
template <bool VERT, bool LUMA>
__device__ __forceinline__ void deblock_window(const DeblockArgs& a, int comp,
                                               long long idx) {
  constexpr int L = LUMA ? 4 : 2;
  const PlaneIO& pl = a.p[comp];
  const int len = VERT ? pl.w : pl.h;         // across the edges
  const int segs = (VERT ? pl.h : pl.w) / L;  // along them
  const int chunks = (len + 11) >> 3;
  if (idx >= (long long)a.n * segs * chunks) return;
  int t, seg, c;
  if (VERT) {
    c = (int)(idx % chunks);
    const long long r = idx / chunks;
    seg = (int)(r % segs);
    t = (int)(r / segs);
  } else {
    seg = (int)(idx % segs);
    const long long r = idx / segs;
    c = (int)(r % chunks);
    t = (int)(r / chunks);
  }
  const int x0 = 8 * c - 4;
  const int j0 = max(0, -x0);
  const int j1 = min(8, len - x0);
  // an edge at every multiple of 8 below len (§8.7.2); a chroma plane
  // whose len is 4 past a multiple of 8 has a last, partial window, of
  // which chroma reads only p1 p0 q0 q1
  const bool edge = c >= 1 && 8 * c < len;
  if (!VERT && !edge) return;  // in place: nothing to copy
  const int32_t* in = pl.in + t * pl.sn;
  int32_t* out = pl.out + (long long)t * pl.h * pl.w;
  int s[L][8];
#pragma unroll
  for (int i = 0; i < L; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int line = seg * L + i, pos = x0 + j;
      s[i][j] = (j >= j0 && j < j1)
                    ? in[VERT ? line * pl.sh + pos : pos * pl.sh + line]
                    : 0;
    }
  bool changed = false;
  if (edge) {
    // the edge's 4x4 map entry (Q side) and the one before it (P side)
    const int e4 = LUMA ? 2 * c : 4 * c;
    const long long base = (long long)t * a.H4 * a.W4;
    const long long mq =
        base + (VERT ? (long long)seg * a.W4 + e4 : (long long)e4 * a.W4 + seg);
    const long long mp = mq - (VERT ? 1 : a.W4);
    if (a.edges[mq]) {
      if constexpr (LUMA)
        changed = luma_edge(s, a.qp[mp], a.qp[mq], a.nf[mp], a.nf[mq], a);
      else
        changed = chroma_edge(s, a.qp[mp], a.qp[mq], a.nf[mp], a.nf[mq],
                              a.c_off[comp - 1], a);
    }
  }
  if (!VERT && !changed) return;
#pragma unroll
  for (int i = 0; i < L; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int line = seg * L + i, pos = x0 + j;
      if (j >= j0 && j < j1)
        out[VERT ? (long long)line * pl.w + pos : (long long)pos * pl.w + line] =
            s[i][j];
    }
}

template <bool VERT>
__global__ void __launch_bounds__(THREADS) deblock_kernel(DeblockArgs a) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (blockIdx.y == 0)
    deblock_window<VERT, true>(a, 0, idx);
  else
    deblock_window<VERT, false>(a, blockIdx.y, idx);
}

__device__ __forceinline__ int sign(int v) { return (v > 0) - (v < 0); }

// SaoTypeIdx 1 (band) and 2 (edge) of one sample; bypass samples, type 0
// and any other type keep the sample.
__global__ void __launch_bounds__(THREADS) sao_kernel(SaoArgs a) {
  const int comp = blockIdx.y;
  const PlaneIO& pl = a.p[comp];
  if (pl.out == nullptr) return;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)a.n * pl.h * pl.w) return;
  const int x = (int)(idx % pl.w);
  const long long r = idx / pl.w;
  const int y = (int)(r % pl.h);
  const int t = (int)(r / pl.h);
  const int32_t* in = pl.in + t * pl.sn;
  const int s = in[y * pl.sh + x];
  int v = s;
  const int sub = comp ? 1 : 0;  // log2 of the chroma subsampling
  const bool nf =
      a.nf[((long long)t * a.H4 + ((y << sub) >> 2)) * a.W4 + ((x << sub) >> 2)];
  if (!nf) {
    const int cl = a.ctb_log2 - sub;
    const int32_t* prm =
        a.sao + ((((long long)t * a.R + (y >> cl)) * a.C + (x >> cl)) * 3 + comp) * 6;
    const int type = prm[0];
    const int bd = a.bd[comp];
    const int mxv = (1 << bd) - 1;
    const int scale = 1 << (bd - min(bd, 10));
    if (type == 1) {
      const int band = s >> (bd - 5);
      int dlt = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (band == ((prm[1] + i) & 31)) dlt += prm[2 + i] * scale;
      v = clip3(s + dlt, 0, mxv);
    } else if (type == 2) {
      // neighbours (dx0, dy0), (dx1, dy1) of the four edge classes
      const int cls = prm[1];
      int dlt = 0;
      if (cls >= 0 && cls < 4) {
        const int dx0 = cls == 1 ? 0 : (cls == 3 ? 1 : -1);
        const int dy0 = cls == 0 ? 0 : -1;
        const int ax = x + dx0, ay = y + dy0, bx = x - dx0, by = y - dy0;
        if (ax >= 0 && ax < pl.w && ay >= 0 && ay < pl.h && bx >= 0 &&
            bx < pl.w && by >= 0 && by < pl.h) {
          const int sg = sign(s - in[ay * pl.sh + ax]) +
                         sign(s - in[by * pl.sh + bx]);
          const int k = sg == -2 ? 0 : sg == -1 ? 1 : sg == 1 ? 2 : sg == 2 ? 3 : -1;
          if (k >= 0) dlt = prm[2 + k] * scale;
        }
      }
      v = clip3(s + dlt, 0, mxv);
    }
  }
  pl.out[idx] = v;
}

PlaneIO plane_io(const void* in, void* out, long long sn, long long sh, int h,
                 int w) {
  PlaneIO p;
  p.in = static_cast<const int32_t*>(in);
  p.out = static_cast<int32_t*>(out);
  p.sn = sn;
  p.sh = sh;
  p.h = h;
  p.w = w;
  return p;
}

unsigned int blocks_for(long long items) {
  return (unsigned int)((items + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" {

// One deblocking pass over n tiles of H x W luma (Y [n,H,W], Cb and Cr
// [n,H/2,W/2], int32). pass 0: the vertical edges (edges = vert_edges),
// from the inputs (element strides sn_*, sh_*) into the outputs, every
// sample written. pass 1: the horizontal edges (edges = horiz_edges), in
// place on the outputs (give the outputs as inputs, strides contiguous).
// edges, nf: [n, H/4, W/4] bool; qp: [n, H/4, W/4] int32; beta, tc, cqp:
// the int32 tables of tables.ReconTables. Returns cudaGetLastError()
// after the launch on `stream`.
int heif_deblock(int pass, void* y, void* cb, void* cr, const void* y_in,
                 const void* cb_in, const void* cr_in, long long sn_y,
                 long long sh_y, long long sn_cb, long long sh_cb,
                 long long sn_cr, long long sh_cr, const void* edges,
                 const void* qp, const void* nf, const void* beta,
                 const void* tc, const void* cqp, int n, int H, int W,
                 int beta_off, int tc_off, int cb_off, int cr_off, int bd_y,
                 int bd_c, void* stream) {
  DeblockArgs a;
  a.p[0] = plane_io(y_in, y, sn_y, sh_y, H, W);
  a.p[1] = plane_io(cb_in, cb, sn_cb, sh_cb, H / 2, W / 2);
  a.p[2] = plane_io(cr_in, cr, sn_cr, sh_cr, H / 2, W / 2);
  a.edges = static_cast<const uint8_t*>(edges);
  a.qp = static_cast<const int32_t*>(qp);
  a.nf = static_cast<const uint8_t*>(nf);
  a.beta = static_cast<const int32_t*>(beta);
  a.tc = static_cast<const int32_t*>(tc);
  a.cqp = static_cast<const int32_t*>(cqp);
  a.n = n;
  a.H4 = H / 4;
  a.W4 = W / 4;
  a.beta_off = beta_off;
  a.tc_off = tc_off;
  a.c_off[0] = cb_off;
  a.c_off[1] = cr_off;
  a.bd_y = bd_y;
  a.bd_c = bd_c;
  // the luma plane has the most windows: (W/8 + 1) per 4 rows, or
  // (H/8 + 1) per 4 columns
  const long long items = pass == 0 ? (long long)n * (H / 4) * ((W + 11) / 8)
                                    : (long long)n * (W / 4) * ((H + 11) / 8);
  const dim3 grid(blocks_for(items), 3);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pass == 0)
    deblock_kernel<true><<<grid, THREADS, 0, st>>>(a);
  else
    deblock_kernel<false><<<grid, THREADS, 0, st>>>(a);
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
  a.n = n;
  a.R = R;
  a.C = C;
  a.H4 = H / 4;
  a.W4 = W / 4;
  a.ctb_log2 = ctb_log2;
  a.bd[0] = bd_y;
  a.bd[1] = bd_c;
  a.bd[2] = bd_c;
  const dim3 grid(blocks_for((long long)n * H * W), 3);
  sao_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
