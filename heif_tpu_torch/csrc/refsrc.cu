// HEVC intra reference-sample sources (H.265 §6.4.1 availability and the
// §8.4.4.2.2 substitution) for Hopper: for every TU of a batch of
// worklists, the [2, 65] uint8 table of where each left and top reference
// sample comes from, which the intra walk (csrc/intra.cu) reads.
//
// No Pallas kernel stands behind it. heif_tpu computes the table with jnp
// code inside `_core` (heif_tpu/ops/batch.py:509-516, through
// jax_recon.ref_sources_device at jax_recon.py:265), which XLA fuses. The
// port ran it as about 300 eager torch ops a chunk; those ops stay, as
// ops/recon.py ref_sources, the oracle that this kernel equals bit for bit.
//
// What bounds it: bytes. Per TU it reads three int32 fields and writes
// 130 bytes; the availability test is a few dozen integer operations for
// each of 129 walk positions, far below the card's integer rate
// (ops/refsrc.py:refsrc_bytes).
//
// Design, correctness first: one warp a TU (8 TUs a block of 256).
// - The walk: position w in 0..4N runs up the left column from its
//   bottom (w = 0 is p[-1][2N-1]), through the corner (w = 2N) and along
//   the top row; lane l takes positions l, l + 32, ... l + 128. A position
//   is available when it lies in the picture, in the same HEVC tile as
//   the TU, earlier in z-order (the z-scan address of its 4x4 block, read
//   at the position clamped into the picture, below the TU's own), and
//   within 4N of the walk's start. Chroma positions are scaled to luma
//   before those tests.
// - Five ballots give every lane the whole availability mask (129 bits).
//   The substitution is then a lookup per position: the last available
//   position at or before w, or, where there is none, the first available
//   one of the walk; no position available at all gives 255 everywhere.
// - The output: lane l writes bytes l, l + 32, ... of the TU's 130:
//   index 0 of each side is the corner's source, left[1 + i] is position
//   2N - 1 - i and top[1 + i] position 2N + 1 + i for i < 2N, 255 past
//   2N and on padding steps (size 0). A source is the index into the TU's
//   local reference vector (left side ++ top side, 65 each).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_S = 32;
constexpr int REF_LEN = 2 * MAX_S + 1;  // 65
constexpr int N_REF = 2 * REF_LEN;      // 130
constexpr int WALK = 4 * MAX_S + 1;     // 129 positions
constexpr int MAX_TILE_COLS = 20;       // interior boundaries (HEVC: 19)
constexpr int MAX_TILE_ROWS = 22;       // (HEVC: 21)

struct RefArgs {
  const int32_t* steps;  // [n, S, F]: x, y, size (component samples) ...
  uint8_t* out;          // [n, S, 2, 65]
  long long n_tus;       // n * S
  int F;                 // fields a step
  int sub;               // 1 luma, 2 chroma (4:2:0)
  int W, H;              // luma picture size
  int cl;                // log2 of the CTB size in 4x4 blocks
  int ctbs_x;            // CTB columns of the picture
  int n_col, n_row;      // interior HEVC tile boundaries, luma samples
  int col_bd[MAX_TILE_COLS];
  int row_bd[MAX_TILE_ROWS];
};

// Z-scan address of the 4x4 block at (g4y, g4x): the raster index of its
// CTB, then the Morton interleave of its position inside the CTB.
__device__ __forceinline__ int z_addr(int g4y, int g4x, const RefArgs& a) {
  const int ctb = (g4y >> a.cl) * a.ctbs_x + (g4x >> a.cl);
  const int m = (1 << a.cl) - 1;
  const int ix = g4x & m, iy = g4y & m;
  int z = 0;
  for (int b = 0; b < a.cl; ++b)
    z |= (((ix >> b) & 1) << (2 * b)) | (((iy >> b) & 1) << (2 * b + 1));
  return (ctb << (2 * a.cl)) + z;
}

__device__ __forceinline__ int tile_of(int v, const int* bd, int n) {
  int t = 0;
  for (int i = 0; i < n; ++i) t += v >= bd[i];
  return t;
}

// The last available position at or before w (mask: 5 words), or -1.
__device__ __forceinline__ int last_at_or_before(const uint32_t (&mask)[5],
                                                 int w) {
  int word = w >> 5;
  uint32_t bits = mask[word] & (0xffffffffu >> (31 - (w & 31)));
  while (bits == 0) {
    if (--word < 0) return -1;
    bits = mask[word];
  }
  return (word << 5) + 31 - __clz(bits);
}

__global__ void __launch_bounds__(THREADS) ref_sources_kernel(RefArgs a) {
  const int lane = threadIdx.x & 31;
  const long long tu = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (tu >= a.n_tus) return;  // whole warps leave together
  const int32_t* st = a.steps + tu * a.F;
  const int x = st[0], y = st[1], size = st[2];
  uint8_t* out = a.out + tu * N_REF;
  if (size <= 0) {  // a padding step
    for (int o = lane; o < N_REF; o += 32) out[o] = 255;
    return;
  }
  const int s2 = 2 * size;
  const int cur_lx = x * a.sub, cur_ly = y * a.sub;
  const int z_cur = z_addr(cur_ly >> 2, cur_lx >> 2, a);
  const int tcol = tile_of(cur_lx, a.col_bd, a.n_col);
  const int trow = tile_of(cur_ly, a.row_bd, a.n_row);

  uint32_t mask[5];
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    const int w = lane + 32 * r;
    bool avail = false;
    if (w < WALK && w <= 2 * s2) {
      const bool left = w <= s2;
      const int cx = left ? x - 1 : x + (w - s2 - 1);
      const int cy = left ? y + (s2 - 1 - w) : y - 1;
      const int lx = cx * a.sub, ly = cy * a.sub;
      avail = lx >= 0 && ly >= 0 && lx < a.W && ly < a.H;
      if (avail) {
        const int zn = z_addr(min(max(ly, 0), a.H - 1) >> 2,
                              min(max(lx, 0), a.W - 1) >> 2, a);
        avail = zn < z_cur &&
                tile_of(lx, a.col_bd, a.n_col) == tcol &&
                tile_of(ly, a.row_bd, a.n_row) == trow;
      }
    }
    mask[r] = __ballot_sync(0xffffffffu, avail);
  }
  int first = -1;  // the first available position of the walk
#pragma unroll
  for (int r = 4; r >= 0; --r)
    if (mask[r]) first = 32 * r + __ffs(mask[r]) - 1;

  for (int o = lane; o < N_REF; o += 32) {
    const int side = o >= REF_LEN;  // 0 left, 1 top
    const int p = o - side * REF_LEN;
    int w = -1;  // the walk position this byte draws from
    if (p == 0)
      w = s2;
    else if (p - 1 < s2)
      w = side ? s2 + p : s2 - p;
    uint8_t v = 255;
    if (w >= 0 && first >= 0) {
      int src = last_at_or_before(mask, w);
      if (src < 0) src = first;
      v = (uint8_t)(src <= s2 ? s2 - src : src - s2 + REF_LEN);
    }
    out[o] = v;
  }
}

}  // namespace

extern "C" {

// The source tables of n worklists of S steps (steps: [n, S, F] int32,
// fields x, y, size first; out: [n, S, 2, 65] uint8) of component comp
// (0 luma, 1 chroma of 4:2:0) in a W x H luma picture with CTBs of
// 1 << ctb_log2 luma samples and the given interior HEVC tile boundaries
// (luma samples). Returns -1 for arguments the kernel does not take (more
// boundaries than it holds, a CTB size outside 16-64, F < 3), else
// cudaGetLastError() after the launch on `stream`.
int heif_ref_sources(const void* steps, void* out, int n, int S, int F,
                     int comp, int W, int H, int ctb_log2,
                     const int* col_bd, int n_col, const int* row_bd,
                     int n_row, void* stream) {
  if (n_col < 0 || n_col > MAX_TILE_COLS || n_row < 0 ||
      n_row > MAX_TILE_ROWS || ctb_log2 < 4 || ctb_log2 > 6 || F < 3 ||
      W <= 0 || H <= 0)
    return -1;
  RefArgs a;
  a.steps = static_cast<const int32_t*>(steps);
  a.out = static_cast<uint8_t*>(out);
  a.n_tus = (long long)n * S;
  a.F = F;
  a.sub = comp == 0 ? 1 : 2;
  a.W = W;
  a.H = H;
  a.cl = ctb_log2 - 2;
  a.ctbs_x = ((W >> 2) + (1 << a.cl) - 1) >> a.cl;
  a.n_col = n_col;
  a.n_row = n_row;
  for (int i = 0; i < n_col; ++i) a.col_bd[i] = col_bd[i];
  for (int i = 0; i < n_row; ++i) a.row_bd[i] = row_bd[i];
  if (a.n_tus == 0) return 0;
  const long long blocks = (a.n_tus + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffff) return -1;
  ref_sources_kernel<<<(unsigned)blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
