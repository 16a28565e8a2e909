// HEVC intra reference-sample sources (H.265 §6.4.1 availability and the
// §8.4.4.2.2 substitution) for Hopper: for every TU of the luma and the
// chroma worklist of a batch, the [2, 65] uint8 table of where each left
// and top reference sample comes from, which the intra walk
// (csrc/intra.cu) reads. Both worklists in one launch.
//
// No Pallas kernel stands behind it. heif_tpu computes the table with jnp
// code inside `_core` (heif_tpu/ops/batch.py:509-516, through
// jax_recon.ref_sources_device at jax_recon.py:265), which XLA fuses. The
// port ran it as about 300 eager torch ops a chunk; those ops stay, as
// ops/recon.py ref_sources, the oracle that this kernel equals bit for bit.
//
// What bounds it: bytes. Per TU it reads three int32 fields and writes
// 130 bytes (ops/refsrc.py:refsrc_bytes): 14.1 MB, 0.0042 ms, for a
// 16-tile flagship chunk. The availability tests are a few dozen integer
// operations for each 4x4 block along a TU's walk, far below the card's
// integer rate.
//
// Design:
// - A thread a TU, 128 TUs a block; the first blocks take the luma
//   worklist, the rest the chroma one.
// - Availability once per 4x4 luma block. A walk position is available
//   when it lies in the picture, in the same HEVC tile as the TU, and
//   earlier in z-order (the z-scan address of its 4x4 luma block below the
//   TU's own). Every position of one 4x4 block (of 2x2 chroma samples in
//   4:2:0) shares its z-address and its tile, and, where the picture's
//   sides are multiples of 4, its side of the picture boundary. So the
//   walk of 4N + 1 positions is a walk of 2 * (2N / u) + 1 units (u = 4
//   luma or 2 chroma samples; the corner is a unit of its own): at most
//   33 for luma, 65 for chroma of N = 32, one test each. The wrapper
//   takes only pictures whose sides and interior tile boundaries are
//   multiples of 8 luma samples, which HEVC guarantees (MinCbSizeY >= 8,
//   tiles of whole CTBs), and raises on others: the per-position test is
//   not kept.
// - The z-address interleaves the block's position in its CTB by bit
//   spreading (shifts and masks); the TU's tile is the box between the
//   interior boundaries around it, found once, so a unit's tile test is
//   four compares.
// - A TU's availability is a mask of one bit a unit (in registers). The
//   thread then walks the units in order and writes each unit's bytes of
//   the TU's table: an available unit draws from itself; an unavailable
//   one from the last position of the last available unit before it, or,
//   where none is, from the first position of the walk's first available
//   unit; none available at all gives 255. Index 0 of each side is the
//   corner's source, left[1 + i] is walk position 2N - 1 - i and top[1 +
//   i] position 2N + 1 + i for i < 2N, 255 past 2N and on padding steps
//   (size 0). A source is the index into the TU's local reference vector
//   (left side ++ top side, 65 each).
// - The output: a block's TUs are one contiguous run of 130-byte tables.
//   The threads write their tables into that run in shared memory, then
//   copy it out in 16-byte stores, consecutive threads on consecutive
//   bytes.
// What it leaves: a warp's TUs walk as many units as its largest TU has
// (33 for a 32x32 luma TU beside 4x4 TUs of 5), and the table bytes are
// single-byte shared-memory stores; the steps' fields are read with a
// 4-byte load each (24-byte rows).

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int THREADS = 128;  // a thread a TU
constexpr int MAX_S = 32;
constexpr int REF_LEN = 2 * MAX_S + 1;  // 65
constexpr int N_REF = 2 * REF_LEN;      // 130
constexpr int MAX_TILE_COLS = 20;       // interior boundaries (HEVC: 19)
constexpr int MAX_TILE_ROWS = 22;       // (HEVC: 21)
constexpr uint8_t NONE = 255;

struct List {
  const int32_t* steps;  // [n, S, F]: x, y, size (component samples) ...
  uint8_t* out;          // [n, S, 2, 65]
  long long n_tus;       // n * S
  int F;                 // fields a step
  int sub;               // 1 luma, 2 chroma (4:2:0)
  int ushift;            // log2 of a unit's samples: 2 luma, 1 chroma
  int first_block;
};

struct RefArgs {
  List l[2];     // luma, chroma
  int W, H;      // luma picture size
  int cl;        // log2 of the CTB size in 4x4 blocks
  int ctbs_x;    // CTB columns of the picture
  int n_col, n_row;  // interior HEVC tile boundaries, luma samples
  int col_bd[MAX_TILE_COLS];
  int row_bd[MAX_TILE_ROWS];
};

// the low 4 bits of v spread to the even bits 0, 2, 4, 6
__device__ __forceinline__ int spread4(int v) {
  v &= 15;
  v = (v | (v << 2)) & 0x33;
  return (v | (v << 1)) & 0x55;
}

// Z-scan address of the 4x4 block at (g4y, g4x): the raster index of its
// CTB, then the Morton interleave of its position inside the CTB.
__device__ __forceinline__ int z_addr(int g4y, int g4x, const RefArgs& a) {
  const int ctb = (g4y >> a.cl) * a.ctbs_x + (g4x >> a.cl);
  const int m = (1 << a.cl) - 1;
  return (ctb << (2 * a.cl)) + (spread4(g4x & m) | (spread4(g4y & m) << 1));
}

// [lo, hi): the tile span around v between the interior boundaries bd
__device__ __forceinline__ void tile_span(int v, const int* bd, int n,
                                          int& lo, int& hi) {
  lo = 0;
  hi = INT_MAX;
  for (int i = 0; i < n; ++i) {
    if (bd[i] <= v)
      lo = max(lo, bd[i]);
    else
      hi = min(hi, bd[i]);
  }
}

// the local index (left side ++ top side) of walk position w
__device__ __forceinline__ int local_of(int w, int s2) {
  return w <= s2 ? s2 - w : w - s2 + REF_LEN;
}

// Unit U of the walk (left units from the bottom, the corner, then top
// units from the left): its first and last walk positions and a sample
// of it (component coordinates).
__device__ __forceinline__ void unit_at(int U, int nl, int u, int s2, int x,
                                        int y, int& w0, int& w1, int& cx,
                                        int& cy) {
  if (U < nl) {
    w0 = U * u;
    w1 = w0 + u - 1;
    cx = x - 1;
    cy = y + s2 - 1 - w0;
  } else if (U == nl) {
    w0 = w1 = s2;
    cx = x - 1;
    cy = y - 1;
  } else {
    const int j = (U - nl - 1) * u;
    w0 = s2 + 1 + j;
    w1 = s2 + j + u;
    cx = x + j;
    cy = y - 1;
  }
}

// The table of one TU into t[0, 130): availability per unit into a bit
// mask, then the units in walk order, each writing its U positions'
// bytes (the source of an available unit is itself), then 255 past 2N.
template <int U_LOG2>
__device__ __forceinline__ void tu_table(const List& L, const RefArgs& a,
                                         int x, int y, int s2, uint8_t* t) {
  constexpr int u = 1 << U_LOG2;
  const int nl = s2 >> U_LOG2;  // units a side
  const int lx0 = x * L.sub, ly0 = y * L.sub;
  const int z_cur = z_addr(ly0 >> 2, lx0 >> 2, a);
  int tx0, tx1, ty0, ty1;
  tile_span(lx0, a.col_bd, a.n_col, tx0, tx1);
  tile_span(ly0, a.row_bd, a.n_row, ty0, ty1);
  uint64_t m0 = 0;  // units 0-63
  bool m1 = false;  // unit 64
  for (int U = 0; U <= 2 * nl; ++U) {
    int w0, w1, cx, cy;
    unit_at(U, nl, u, s2, x, y, w0, w1, cx, cy);
    const int lx = cx * L.sub, ly = cy * L.sub;
    const bool avail = lx >= 0 && ly >= 0 && lx < a.W && ly < a.H &&
                       lx >= tx0 && lx < tx1 && ly >= ty0 && ly < ty1 &&
                       z_addr(ly >> 2, lx >> 2, a) < z_cur;
    if (U < 64)
      m0 |= (uint64_t)avail << U;
    else
      m1 = avail;
  }
  // none available: 255 everywhere; else the units before the first
  // available one draw from its first position
  int last = -1;
  if (m0 | m1) {
    const int first = m0 ? __ffsll((long long)m0) - 1 : 64;
    int w0, w1, cx, cy;
    unit_at(first, nl, u, s2, x, y, w0, w1, cx, cy);
    last = w0;
  }
  for (int U = 0; U <= 2 * nl; ++U) {
    int w0, w1, cx, cy;
    unit_at(U, nl, u, s2, x, y, w0, w1, cx, cy);
    const bool avail = U < 64 ? (m0 >> U) & 1 : m1;
    const int src = last < 0 ? NONE : local_of(last, s2);
    if (U == nl) {  // the corner: index 0 of both sides
      const uint8_t v = avail ? 0 : src;
      t[0] = v;
      t[REF_LEN] = v;
    } else if (U < nl) {  // left: positions w0..w1 are bytes 2N - w
#pragma unroll
      for (int i = 0; i < u; ++i)
        t[s2 - w0 - i] = avail ? s2 - w0 - i : src;
    } else {  // top: positions w0..w1 are bytes 65 + w - 2N
#pragma unroll
      for (int i = 0; i < u; ++i)
        t[REF_LEN + w0 + i - s2] = avail ? REF_LEN + w0 + i - s2 : src;
    }
    if (avail) last = w1;
  }
  for (int p = s2 + 1; p < REF_LEN; ++p) {
    t[p] = NONE;
    t[REF_LEN + p] = NONE;
  }
}

__global__ void __launch_bounds__(THREADS)
    ref_sources_kernel(const __grid_constant__ RefArgs a) {
  // the block's run of tables, as it lies in `out`
  __shared__ __align__(16) uint8_t stage[THREADS * N_REF];

  const int li = (int)blockIdx.x >= a.l[1].first_block;
  const List& L = a.l[li];
  const long long base =
      (long long)((int)blockIdx.x - L.first_block) * THREADS;
  const int cnt = (int)min((long long)THREADS, L.n_tus - base);
  const int tid = threadIdx.x;

  // a thread a TU
  if (tid < cnt) {
    const int32_t* st = L.steps + (base + tid) * L.F;
    const int x = st[0], y = st[1], size = st[2];
    uint8_t* t = stage + tid * N_REF;
    if (size > 0 && size <= MAX_S) {
      if (L.sub == 1)
        tu_table<2>(L, a, x, y, 2 * size, t);
      else
        tu_table<1>(L, a, x, y, 2 * size, t);
    } else {  // a padding step
      for (int o = 0; o < N_REF; ++o) t[o] = NONE;
    }
  }
  __syncthreads();

  // 16-byte copies out, consecutive threads on consecutive bytes
  uint8_t* out = L.out + base * N_REF;
  const int total = cnt * N_REF;
  for (int b = tid * 16; b < total; b += THREADS * 16) {
    if (b + 16 <= total) {
      *reinterpret_cast<uint4*>(out + b) =
          *reinterpret_cast<const uint4*>(stage + b);
    } else {
      for (int i = b; i < total; ++i) out[i] = stage[i];
    }
  }
}

}  // namespace

extern "C" {

// The source tables of a luma and a chroma worklist (steps: [n, S, F]
// int32, fields x, y, size first; out: [n, S, 2, 65] uint8, 16-byte
// aligned; n * S = 0 skips a list) in a W x H luma picture with CTBs of
// 1 << ctb_log2 luma samples and the given interior HEVC tile boundaries
// (luma samples), in one launch on `stream`. Returns -1 for arguments
// the kernel does not take (more boundaries than it holds, a CTB size
// outside 16-64, F < 3, a picture side or boundary that is not a multiple
// of 8, an unaligned output), else cudaGetLastError() after the launch.
int heif_ref_sources2(const void* steps_y, void* out_y, int n_y, int S_y,
                      int F_y, const void* steps_c, void* out_c, int n_c,
                      int S_c, int F_c, int W, int H, int ctb_log2,
                      const int* col_bd, int n_col, const int* row_bd,
                      int n_row, void* stream) {
  if (n_col < 0 || n_col > MAX_TILE_COLS || n_row < 0 ||
      n_row > MAX_TILE_ROWS || ctb_log2 < 4 || ctb_log2 > 6 || W <= 0 ||
      H <= 0 || W % 8 || H % 8 || n_y < 0 || S_y < 0 || n_c < 0 || S_c < 0)
    return -1;
  RefArgs a;
  a.W = W;
  a.H = H;
  a.cl = ctb_log2 - 2;
  a.ctbs_x = ((W >> 2) + (1 << a.cl) - 1) >> a.cl;
  a.n_col = n_col;
  a.n_row = n_row;
  for (int i = 0; i < n_col; ++i) {
    if (col_bd[i] % 8) return -1;
    a.col_bd[i] = col_bd[i];
  }
  for (int i = 0; i < n_row; ++i) {
    if (row_bd[i] % 8) return -1;
    a.row_bd[i] = row_bd[i];
  }
  const void* steps[2] = {steps_y, steps_c};
  void* outs[2] = {out_y, out_c};
  const int ns[2] = {n_y, n_c}, Ss[2] = {S_y, S_c}, Fs[2] = {F_y, F_c};
  long long blocks = 0;
  for (int c = 0; c < 2; ++c) {
    List& L = a.l[c];
    L.steps = static_cast<const int32_t*>(steps[c]);
    L.out = static_cast<uint8_t*>(outs[c]);
    L.n_tus = (long long)ns[c] * Ss[c];
    L.F = Fs[c];
    L.sub = c == 0 ? 1 : 2;
    L.ushift = c == 0 ? 2 : 1;
    L.first_block = (int)blocks;
    if (L.n_tus == 0) continue;
    if (L.F < 3 || (reinterpret_cast<uintptr_t>(L.out) & 15)) return -1;
    blocks += (L.n_tus + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffff) return -1;
  }
  if (blocks == 0) return 0;
  ref_sources_kernel<<<(unsigned)blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
