// The mma.sync engine of the backward sweeps, as one header: the ring of
// weight slabs, the warp's product on it, the scratch's 8 x 8 pieces, and
// the parameter pass with its reduction as templates over a table of (X, GZ,
// widths). The light kernel, both directions (lights.cu), and the predictor
// kernel's backward (predictor.cu) run on it; shader.cu and sdf_grad.cu keep
// their own copies of the same engine.
//
// A sweep block holds 16 warps over a tile of rows: warp w owns 32 rows
// (two m16n8k16 row tiles) and 64 columns (WN = 8 n8-tiles) of a 256-wide
// layer, 64 f32 accumulators a lane. The weights stream through a 2-stage
// ring of bf16 slabs in shared memory, filled by 16-byte cp.async copies: a
// slab of up to SLAB_K weight rows [k][n] for the forward recompute
// (ldmatrix.trans gives the B fragments), or of SLAB_K output columns with
// all input rows [n][k] for the reverse sweep (plain ldmatrix gives W^T's).
#pragma once

#include "mma.cuh"

namespace nero {

constexpr int LAYER_W = 256;                // the hidden width of every head
constexpr int WN = 8;                       // n8-tiles a warp holds: 64 columns
constexpr int NQ = LAYER_W / (8 * WN);      // column groups of a layer
constexpr int SLAB_K = 128;                 // weight rows (recompute) or columns (sweep) per slab
constexpr int LDB = LAYER_W + 8;            // recompute slab [SLAB_K][LDB] bf16
constexpr int LDT = SLAB_K + 8;             // sweep slab [LAYER_W][LDT] bf16
constexpr int STAGES = 2;
constexpr int STAGE_ELEMS = SLAB_K * LDB > LAYER_W * LDT ? SLAB_K * LDB : LAYER_W * LDT;
constexpr int HS = LAYER_W / SLAB_K;        // slabs of a 256-row (recompute) or -column (sweep) layer

// The scratch lies in device memory in pieces, not rows: a piece is 8 rows x
// 8 columns (128 bytes), a group of 32 rows of width W is its W / 8 column
// blocks of four pieces (rows 0-7, 8-15, 16-23, 24-31) in order, the groups
// in row order. Element (row r, column c) of a width-W array is at
// piece_off(r, c, W). A warp's accumulators hold whole pieces, so its stores
// and loads of one (n8-tile, 8 rows) are 128 contiguous bytes; a stage of
// the parameter pass is four contiguous runs, copied as they lie, and
// ldmatrix reads its 8 x 8 matrices as whole pieces.
constexpr int F_S = 64, F_J = 4 * F_S;  // a piece; a column block of 4 pieces
__host__ __device__ constexpr size_t piece_off(size_t r, int c, int W) {
  return ((r >> 5) * (W / 8) + (c >> 3)) * F_J + ((r >> 3) & 3) * F_S + (r & 7) * 8 + (c & 7);
}

// A slab of the weight stream: `rows` rows of `cols` columns at element
// offset `off` of the packed weights, row stride ldg there and lds in the ring.
struct Slab {
  size_t off;
  int rows, cols, ldg, lds;
};

// The slabs of the stream in order; the block keeps them as a table in shared
// memory, so that refilling the ring holds no registers beside the
// accumulators.
struct SlabRec {
  unsigned off;
  unsigned short rows, cols, ldg, lds;
};

__device__ __forceinline__ SlabRec slab_rec(const Slab& s) {
  return {(unsigned)s.off, (unsigned short)s.rows, (unsigned short)s.cols, (unsigned short)s.ldg,
          (unsigned short)s.lds};
}

// The ring of weight slabs. next() waits for the oldest slab, makes it (and
// every shared-memory write before the call) visible to the block, refills
// the stage that the block finished with, and returns the slab's
// shared-memory address.
struct Ring {
  bf16* base;
  const bf16* W;
  const SlabRec* recs;
  int count;  // slabs in the table
  int slab;

  __device__ __forceinline__ void load(int s) const {
    if (s < count) {
      const SlabRec sl = recs[s];
      bf16* st = base + (s % STAGES) * STAGE_ELEMS;
      const int cpr = sl.cols / 8;  // 16-byte chunks per row
      for (int v = threadIdx.x; v < sl.rows * cpr; v += blockDim.x) {
        const int r = v / cpr, c = (v - r * cpr) * 8;
        cp_async16(st + r * sl.lds + c, W + sl.off + (size_t)r * sl.ldg + c);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  }

  __device__ __forceinline__ unsigned next() {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    load(slab + STAGES - 1);
    const unsigned a = smem_u32(base) + (slab % STAGES) * STAGE_ELEMS * 2;
    ++slab;
    return a;
  }
};

// acc[m][j] += X[rows of m-tile m, 0:K] @ B[:, n8-tile j of the warp's
// columns] for the warp's first `ncols` columns (a multiple of 16; none: the
// warp only keeps the ring's pace), k in steps of 16 from 0 up, B from the
// ring: the recompute's slabs [k][n] (ldmatrix.trans) or, WT, the sweep's
// [n][k], which are W^T's fragments without .trans. x: this lane's ldmatrix
// address in the warp's first row of X (leading dim ldx); col0: the warp's
// first column.
template <bool WT>
__device__ __forceinline__ void product(float (&acc)[2][WN][4], Ring& ring, unsigned x, int ldx,
                                        int K, int col0, int ncols) {
  const int lane = threadIdx.x & 31;
  const unsigned lane_b = WT ? (x4_lane(lane, LDT) + col0 * LDT) * 2
                             : ((lane & 15) * LDB + (lane >> 4) * 8 + col0) * 2;
  const int jn = min(WN / 2, max(ncols, 0) / 16);
  for (int k0 = 0; k0 < K; k0 += SLAB_K) {
    const unsigned b = ring.next() + lane_b;
    if (jn == 0) continue;
    const int ksteps = min(SLAB_K, K - k0) / 16;
#pragma unroll 1
    for (int kk = 0; kk < ksteps; ++kk) {
      unsigned a[2][4];
      ldsm_x4(a[0], x + (k0 + kk * 16) * 2);
      ldsm_x4(a[1], x + (16 * ldx + k0 + kk * 16) * 2);
#pragma unroll
      for (int j = 0; j < WN / 2; ++j) {
        if (j < jn) {
          unsigned bb[4];
          if (WT) ldsm_x4(bb, b + (j * 16 * LDT + kk * 16) * 2);
          else ldsm_x4_t(bb, b + (kk * 16 * LDB + j * 16) * 2);
          mma_bf16(acc[0][2 * j], a[0], bb[0], bb[1]);
          mma_bf16(acc[1][2 * j], a[1], bb[0], bb[1]);
          mma_bf16(acc[0][2 * j + 1], a[0], bb[2], bb[3]);
          mma_bf16(acc[1][2 * j + 1], a[1], bb[2], bb[3]);
        }
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[2][WN][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
}

// the sum over the 4 lanes of a row (adjacent threads); every lane gets the
// same bits
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void row_sum3(float* v) {
  for (int k = 0; k < 3; ++k) v[k] = row_sum(v[k]);
}

// ---------------------------------------------------------------------------
// the parameter pass: dW = X^T GZ and db = column sums of GZ, every layer of
// every head in one launch over (tile of the table, row chunk), then the
// chunks' partials added in chunk order (no atomics: the same gradients
// every run)
// ---------------------------------------------------------------------------

constexpr int PW_THREADS = 512;  // 16 warps: a 128 x 256 tile of dW, 32 x 64 a warp
constexpr int PW_RS = 128;       // rows per stage
constexpr int PW_STAGES = 2;
constexpr int PW_STAGE = PW_RS * (128 + LAYER_W);  // X's 128 columns at most, G's 256
constexpr size_t PW_SMEM = (size_t)PW_STAGES * PW_STAGE * 2;
constexpr int PW_MIN_ROWS = 2048;  // rows per chunk, at least
constexpr int PW_MAX_CHUNKS = 64;
static_assert(PW_SMEM <= 232448, "parameter pass shared memory");

// One block's share of the parameter gradients: dW[out + k * ldo + n] for
// k < 8 xn, n < 8 gn = the sum over the chunk's rows of X[row][8 xp + k]
// G[row][n], X and G in pieces of widths xw and 8 gn.
struct PwTile {
  const bf16 *X, *G;
  int xw, xp, xn, gn;
  size_t out;
  int ldo;
  int db;  // db row (head * 4 + layer), its column sums of G; < 0: none
};

// Element offset of layer l's (0-3) weights in a head packed as w1 [di, 256],
// w2, w3 [256, 256], w4 [256, out] from `woff`.
__host__ __device__ constexpr size_t layer_woff(size_t woff, int di, int l) {
  return woff + (l == 0 ? 0 : (size_t)di * LAYER_W + (size_t)(l - 1) * LAYER_W * LAYER_W);
}

// Row chunks of the parameter pass: at least PW_MIN_ROWS rows each, at most
// PW_MAX_CHUNKS, PW_RS-row stages (m_rows a multiple of PW_RS).
inline int pw_chunks(int m_rows) {
  const int c = m_rows / PW_MIN_ROWS;
  return c < 1 ? 1 : c > PW_MAX_CHUNKS ? PW_MAX_CHUNKS : c;
}

inline int pw_chunk_rows(int m_rows) {
  const int c = pw_chunks(m_rows);
  return ((m_rows + c - 1) / c + PW_RS - 1) / PW_RS * PW_RS;
}

// The parameter pass of block (blockIdx.x = tile of the table, blockIdx.y =
// row chunk, blockIdx.z = scene). tab: PwTile tile(int t, bf16* scratch,
// size_t M), w_total() (floats of dW) and part_row() (floats of one chunk's
// partials: dW, then dB [heads][4][256]); a table whose widths are fixed when
// it is compiled (lights.cu) is a stateless object, one whose input width
// comes at run time (predictor.cu) carries it. Scene z reads the z-th
// scratch of scene_scratch elements and writes the z-th gridDim.y chunks'
// partials: m_rows and rows_per_chunk are one scene's, so a scene's sums run
// in its one-scene launch's order (one scene: z = 0, no offset).
template <class Tab>
__device__ __forceinline__ void param_pass(const Tab& tab, bf16* __restrict__ scratch, int m_rows,
                                           int rows_per_chunk, float* __restrict__ part,
                                           size_t scene_scratch = 0) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* stages = reinterpret_cast<bf16*>(smem_raw);  // per stage X then G, each in pieces
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ig = warp / 4, og = warp % 4;  // the warp's 32 input rows and 64 output columns
  const int g = lane >> 2, t = lane & 3;
  const size_t M = (size_t)m_rows;
  const PwTile T = tab.tile(blockIdx.x, scratch + blockIdx.z * scene_scratch, M);
  const int m0 = blockIdx.y * rows_per_chunk;
  const int n_st = max(0, min((int)M - m0, rows_per_chunk)) / PW_RS;
  constexpr int GROUPS = PW_RS / 32;

  // the stage's 32-row groups, pieces p .. p + n - 1 of each: GROUPS runs of
  // n * F_J elements in device memory, 16 bytes a copy
  auto copy = [&](bf16* dst, const bf16* src, int w, int p, int n, size_t m) {
    const int run = n * F_J / 8;
    for (int v = tid; v < GROUPS * run; v += PW_THREADS) {
      const int q = v / run, c = (v - q * run) * 8;
      cp_async16(dst + q * n * F_J + c, src + (m / 32 + q) * (w / 8) * F_J + p * F_J + c);
    }
  };
  auto load = [&](int i) {
    if (i < n_st) {
      bf16* xs = stages + (i % PW_STAGES) * PW_STAGE;
      const size_t m = (size_t)m0 + (size_t)i * PW_RS;
      copy(xs, T.X, T.xw, T.xp, T.xn, m);
      copy(xs + PW_RS * T.xn * 8, T.G, T.gn * 8, 0, T.gn, m);
    }
    cp_async_commit();
  };

  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
  float dbs = 0.0f;
  const bool rows_here = ig * 4 < T.xn && og * 8 < T.gn;
  // ldmatrix: lanes 8q .. 8q + 7 give the rows of matrix q. A = X^T (.trans):
  // matrices (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15);
  // B = G (.trans): (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
  const int a_k8 = lane >> 4, a_m8 = (lane >> 3) & 1, b_k8 = (lane >> 3) & 1, b_n8 = lane >> 4;

  for (int s = 0; s < PW_STAGES - 1; ++s) load(s);
  for (int i = 0; i < n_st; ++i) {
    cp_async_wait<PW_STAGES - 2>();
    __syncthreads();
    load(i + PW_STAGES - 1);  // into the stage the block finished with
    bf16* xs = stages + (i % PW_STAGES) * PW_STAGE;
    const bf16* gs = xs + PW_RS * T.xn * 8;
    if (T.db >= 0 && tid < T.gn * 8) {  // every row of the stage
#pragma unroll
      for (int q = 0; q < GROUPS; ++q)
#pragma unroll 8
        for (int r = 0; r < 32; ++r)
          dbs += from_bf(gs[(q * T.gn + (tid >> 3)) * F_J + r * 8 + (tid & 7)]);
    }
    if (rows_here) {
      const unsigned xa = smem_u32(xs), ga = smem_u32(gs);
#pragma unroll
      for (int kk = 0; kk < PW_RS / 16; ++kk) {
        const int q = kk >> 1;  // the 32-row group of rows 16 kk .. 16 kk + 15
        unsigned a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int piece = ig * 4 + mt * 2 + a_m8, kind = (2 * kk + a_k8) & 3;
          ldsm_x4_t(a[mt], xa + ((q * T.xn + piece) * F_J + kind * F_S + (lane & 7) * 8) * 2);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (og * 8 + j * 2 >= T.gn) break;
          const int piece = og * 8 + j * 2 + b_n8, kind = (2 * kk + b_k8) & 3;
          unsigned bb[4];
          ldsm_x4_t(bb, ga + ((q * T.gn + piece) * F_J + kind * F_S + (lane & 7) * 8) * 2);
          mma_bf16(acc[0][2 * j], a[0], bb[0], bb[1]);
          mma_bf16(acc[1][2 * j], a[1], bb[0], bb[1]);
          mma_bf16(acc[0][2 * j + 1], a[0], bb[2], bb[3]);
          mma_bf16(acc[1][2 * j + 1], a[1], bb[2], bb[3]);
        }
      }
    }
  }

  float* out = part + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * tab.part_row();
  if (rows_here) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = ig * 32 + m * 16 + g + h * 8, n = og * 64 + j * 8 + 2 * t;
          if (k < T.xn * 8 && n < T.gn * 8)
            *reinterpret_cast<float2*>(out + T.out + (size_t)k * T.ldo + n) =
                make_float2(acc[m][j][2 * h], acc[m][j][2 * h + 1]);
        }
  }
  if (T.db >= 0 && tid < LAYER_W)
    out[tab.w_total() + T.db * LAYER_W + tid] = tid < T.gn * 8 ? dbs : 0.0f;
}

// dW, dB = the chunks' partials added in chunk order; blockIdx.y is the
// scene: its n_chunks partials, its dW (w_total floats) and dB
template <class Tab>
__device__ __forceinline__ void reduce_chunks(const Tab& tab, const float* __restrict__ part,
                                              int n_chunks, float* __restrict__ dW,
                                              float* __restrict__ dB) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t row = tab.part_row(), w = tab.w_total();
  if (i >= row) return;
  part += (size_t)blockIdx.y * n_chunks * row;
  dW += blockIdx.y * w;
  dB += blockIdx.y * (row - w);
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c) s += part[(size_t)c * row + i];
  if (i < w) dW[i] = s;
  else dB[i - w] = s;
}

}  // namespace nero
