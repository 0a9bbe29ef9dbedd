// One 4-layer prediction head, forward and backward, for Hopper (sm_90a).
//
// Replaces nero_tpu/ops/pallas/predictor_kernel.py::predictor_fused (:226),
// pallas_calls nero_predictor_fwd (:151) and nero_predictor_bwd (:171), bodies
// _fwd_kernel and _bwd_kernel (:92-134): x [n, d_in] -> 3 x (product + bias +
// ReLU, 256 wide) -> product + bias -> out [n, d_out], pre-activation; the
// final sigmoid / exp stays outside. Weights arrive weight-norm-resolved,
// bf16, [in, out] row-major, w1 padded to a multiple of 16 rows (di) and w4
// to 16 columns; sums are f32. Any d_in up to 272 and d_out up to 16: every
// head of the Stage-I shader.
//
// Forward (predictor_fwd_kernel), on the mma.sync engine of engine.cuh that
// the backward and lights.cu run too: one block of 16 warps per tile of PB
// = 128 rows (warp w: rows 32(w/4) .. +31, columns 64(w%4) .. +63, 64 f32
// accumulators a lane). x goes into the tile as bf16 through load_x, the
// sweep's input code (zeros past d_in and past n, a float at a time: a row
// of an odd d_in starts at an odd float); the weights stream through the
// 2-stage cp.async ring on a slab table of the forward's own (W1 in
// ceil(di / 128) slabs, W2, W3 in two each, then W4 [256, 16] as two
// 128-row slabs of its 16 columns: the backward never streams W4, so its
// table is not a prefix); bias and ReLU in registers, each H once into the
// tile, bf16, with the rounding points of the sweep's recompute (bf16 X and
// H, f32 sums, k from 0 up in steps of 16). The output layer runs on the
// warps of columns 0-63, their first two n8-tiles, and its f32 sums plus
// the bias go straight from the accumulators to out. No C tile; the
// forward and the recompute stay two loops (one shared loop spilled in the
// shader kernel). Rows past n are masked.
//
// Backward: the TPU kernel adds dW and db into VMEM accumulators across a
// sequential grid (:112-134). Blocks on this card run in no order, so the
// gradient is taken in three launches on the mma.sync engine of engine.cuh,
// which lights.cu's backward runs too:
//  * predictor_bwd_sweep_kernel, one block of 16 warps per tile of PB = 128
//    rows (warp w: rows 32(w/4) .. +31, columns 64(w%4) .. +63). It
//    recomputes the head: x rounded to bf16 into the tile (zeros past d_in
//    and past n, read a float at a time: a row of an odd d_in starts at an
//    odd float), the products on weight slabs streamed through the 2-stage
//    cp.async ring, bias and ReLU in registers, X and H1-H3 to the scratch
//    once, bf16. Then the reverse sweep: GZ4 = bf16(gout) in 16 columns,
//    GH = GZ W^T, the ReLU mask from the H the lane wrote, each GZ to the
//    scratch; then (want_dx) dx = GZ1 W1^T, stored as scalars straight from
//    the accumulators (no encoding backward needs it in shared memory). The
//    16 warps span 256 columns, and a W1^T slab of all 272 input rows would
//    not fit a stage of the ring (272 x 136 > STAGE_ELEMS), so at di = 272
//    the columns 256-271 take a second pass over GZ1 on two 16-row slabs
//    (one warp of each row group does the work).
//  * predictor_bwd_params_kernel: dW = X^T GZ and db (column sums of GZ) of
//    the four layers in one launch over (layer, 128-row part of its input,
//    row chunk): engine.cuh's param_pass on a table that carries di.
//  * predictor_bwd_reduce_kernel adds the chunks' partials in chunk order (no
//    atomics): dW and dB are the same to the bit in every call.
// Rows past n carry zero cotangents: they add nothing.
//
// The scene axis (predictor_fwd_scenes, predictor_bwd_scenes): the multi-
// scene step of nero_tpu vmaps the head over S scenes' stacked weights, so
// its pallas_calls run once for all scenes. Here one launch each way takes
// S scenes of n rows: blockIdx.y is the scene in the forward, the sweep and
// the reduction, blockIdx.z in the parameter pass; each scene's blocks run
// the one-scene code on its rows, weights, biases, scratch and partials,
// with the row chunks of one scene's n, so each scene's out, dx, dW and dB
// equal its one-scene launch's to the bit. The one-scene entries are S = 1.
//
// Bound: tensor-core operations, 2 * (d_in*256 + 2*256*256 + 256*d_out) per
// row forward and 3x that backward (0.026 and 0.079 ms at N = 65,536, d_in
// 259), against 4 * (d_in + d_out) bytes per row in and out. What keeps both
// directions from it: every 128-row tile streams the head's weights (0.41
// MB bf16 at di 272) from L2 through a 2-stage ring, a block barrier a
// slab, so a block's products wait on the stream and the epilogues run
// between them, not beside them (the backward twice, ~0.4 GB a launch at N
// = 65,536); mma.sync, not the warpgroup products; the output layer keeps
// 12 of the 16 warps idle for its 16 columns. The backward also writes the
// scratch (3.6 KB a row at di 272), which the parameter pass reads back
// (each layer's GZ once for each 128-row part of its input).
#include "engine.cuh"

using namespace nero;

namespace {

constexpr int HID = 256;
constexpr int DO = 16;           // head outputs padded
constexpr int MAX_DI = 272;      // the widest input: [feats, pts] = 259, padded
constexpr int PB = 128;          // rows per tile, both directions
constexpr int BTHREADS = 512;    // 16 warps: PB / 32 row groups x NQ column groups
constexpr int LDA = MAX_DI + 8;  // input / activation / cotangent tile [PB][LDA] bf16
constexpr size_t TILE_BYTES = (size_t)PB * LDA * 2;
// the forward's stream: W1 in up to 3 slabs, W2, W3 and W4 in HS each
constexpr int MAX_FWD_SLABS = (MAX_DI + SLAB_K - 1) / SLAB_K + 3 * HS;
constexpr size_t F_SMEM =
    TILE_BYTES + (size_t)STAGES * STAGE_ELEMS * 2 + (size_t)MAX_FWD_SLABS * sizeof(SlabRec);
// the backward's at di = 272 with dx: W1 in 3 slabs, W2, W3, W4^T, W3^T,
// W2^T, and W1^T in two passes of HS slabs
constexpr int MAX_SLABS = (MAX_DI + SLAB_K - 1) / SLAB_K + 6 * HS + 1;
constexpr size_t B_SMEM =
    TILE_BYTES + (size_t)STAGES * STAGE_ELEMS * 2 + (size_t)MAX_SLABS * sizeof(SlabRec);
static_assert(HID == LAYER_W, "the engine's layer width");
static_assert(BTHREADS == 4 * PB, "GZ4 is loaded by 4 lanes a row");
static_assert(BTHREADS / 32 == PB / 32 * NQ, "warps tile the rows and the columns");
static_assert(PW_RS % PB == 0, "the scratch's rows are whole tiles");
static_assert(DO <= 8 * WN && DO % 16 == 0, "the output layer: the first n8-tiles of a warp");
static_assert(F_SMEM <= 232448 && B_SMEM <= 232448, "shared memory");

inline bool di_ok(int di) { return di >= 16 && di % 16 == 0 && di <= MAX_DI; }

inline bool dims_ok(int d_in, int di, int d_out) {
  return d_in >= 1 && di >= d_in && di_ok(di) && d_out >= 1 && d_out <= DO;
}

// bf16 elements of one head's packed weights: w1 [di, 256], w2, w3, w4 [256, 16]
__host__ __device__ inline size_t weight_elems(int di) {
  return (size_t)di * HID + 2 * (size_t)HID * HID + (size_t)HID * DO;
}

// The tile's input: x rounded to bf16, zeros past d_in and past n, a float at
// a time (a row of an odd d_in starts at an odd float). Not inlined: the
// per-row phases keep their registers out of the products'.
__device__ __noinline__ void load_x(const float* __restrict__ x, int n, int d_in, int di, int p0,
                                    bf16* A) {
  for (int idx = threadIdx.x; idx < PB * di; idx += BTHREADS) {
    const int r = idx / di, c = idx - r * di;
    A[r * LDA + c] = to_bf(p0 + r < n && c < d_in ? x[(size_t)(p0 + r) * d_in + c] : 0.0f);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

__host__ __device__ inline int n_fwd_slabs(int di) { return (di + SLAB_K - 1) / SLAB_K + 3 * HS; }

// Slab s of the forward's stream: W1 (di rows in slabs of SLAB_K), W2 and
// W3 as [k][n] slabs of SLAB_K rows, then W4 [256, 16] as HS slabs of SLAB_K
// rows and its 16 columns. The backward's slab_at starts with the same
// slabs but never streams W4.
__device__ Slab fwd_slab_at(int s, int di) {
  const int n1 = (di + SLAB_K - 1) / SLAB_K;
  if (s < n1) return {(size_t)s * SLAB_K * HID, min(SLAB_K, di - s * SLAB_K), HID, HID, LDB};
  s -= n1;
  const int l = 1 + s / HS, j = s % HS, cols = l == 3 ? DO : HID;
  return {layer_woff(0, di, l) + (size_t)j * SLAB_K * cols, SLAB_K, cols, cols, LDB};
}

// x [n, d_in] f32; W packed bf16 (w1 [di,256], w2, w3, w4 [256,16]); B [4][256]
// f32 -> out [n, d_out]. blockIdx.y is the scene: n rows a scene, its rows
// after the rows of the scenes before it, its weights and biases the y-th
// set (one scene: y = 0, no offset).
__global__ void __launch_bounds__(BTHREADS, 1)
predictor_fwd_kernel(const float* __restrict__ x, int n, int d_in, int di, int d_out,
                     const bf16* __restrict__ W, const float* __restrict__ B,
                     float* __restrict__ out) {
  x += blockIdx.y * (size_t)n * d_in;
  out += blockIdx.y * (size_t)n * d_out;
  W += blockIdx.y * weight_elems(di);
  B += blockIdx.y * 4 * HID;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* A = reinterpret_cast<bf16*>(smem_raw);  // input, then activations [PB][LDA]
  bf16* ring_base = reinterpret_cast<bf16*>(smem_raw + TILE_BYTES);
  SlabRec* recs = reinterpret_cast<SlabRec*>(ring_base + STAGES * STAGE_ELEMS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp / NQ, cq = warp % NQ;  // row group, column group
  const int g = lane >> 2, t = lane & 3;      // accumulator row and column pair
  const int p0 = blockIdx.x * PB;
  const int count = n_fwd_slabs(di);

  for (int i = tid; i < count; i += BTHREADS) recs[i] = slab_rec(fwd_slab_at(i, di));
  __syncthreads();
  Ring ring{ring_base, W, recs, count, 0};
  for (int st = 0; st < STAGES - 1; ++st) ring.load(st);  // in flight while x comes in
  load_x(x, n, d_in, di, p0, A);

  const unsigned a_x = smem_u32(A + (grp * 32 + (lane & 15)) * LDA + (lane >> 4) * 8);
  const int col0 = cq * WN * 8;
  bf16* arow = A + (grp * 32 + g) * LDA + col0 + 2 * t;
  float acc[2][WN][4];

  // H = relu(z + b) to the tile, once, bf16
  for (int l = 0; l < 3; ++l) {
    zero(acc);
    product<false>(acc, ring, a_x, LDA, l == 0 ? di : HID, col0, HID - col0);
    __syncthreads();  // every warp is done reading the tile
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      const float2 b2 = *reinterpret_cast<const float2*>(B + l * HID + col0 + j * 8 + 2 * t);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(fmaxf(acc[m][j][2 * hf] + b2.x, 0.0f),
                                    fmaxf(acc[m][j][2 * hf + 1] + b2.y, 0.0f));
          *reinterpret_cast<__nv_bfloat162*>(arow + (16 * m + 8 * hf) * LDA + j * 8) = v;
        }
    }
  }

  // the output layer on the warps of columns 0-63, their first DO / 8
  // n8-tiles; f32 sums plus the bias straight to out
  zero(acc);
  product<false>(acc, ring, a_x, LDA, HID, col0, DO - col0);
  if (cq != 0) return;
#pragma unroll
  for (int j = 0; j < DO / 8; ++j)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = p0 + grp * 32 + 16 * m + 8 * hf + g;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = j * 8 + 2 * t + e;
          if (r < n && c < d_out)
            out[(size_t)r * d_out + c] = acc[m][j][2 * hf + e] + B[3 * HID + c];
        }
      }
}

// ---------------------------------------------------------------------------
// backward: recompute and reverse sweep
// ---------------------------------------------------------------------------

// Scratch of the backward (bf16, in pieces) for M rows: X [M][di], H
// [3][M][256] (layers 1-3 as the recompute formed them), GZ [3][M][256],
// GZ4 [M][16].
struct Scratch {
  bf16* base;
  size_t M;
  int di;
  __host__ __device__ bf16* x() const { return base; }
  __host__ __device__ bf16* hid(int l) const { return base + M * di + (size_t)l * M * HID; }
  __host__ __device__ bf16* gz(int l) const { return hid(3 + l); }
  __host__ __device__ bf16* gz4() const { return hid(6); }
  __host__ __device__ static size_t elems(size_t m, int di) {
    return m * di + 6 * m * HID + m * DO;
  }
};

// dx passes of W1^T: its input columns 0 .. 255, and 256 .. di - 1 when di > 256
__host__ __device__ inline int dx_passes(int di, bool dx) { return dx ? (di + HID - 1) / HID : 0; }

__host__ __device__ inline int n_slabs(int di, bool dx) {
  return (di + SLAB_K - 1) / SLAB_K + 4 * HS + 1 + dx_passes(di, dx) * HS;
}

// Slab s of the stream: the recompute's W1 (di rows in slabs of SLAB_K), W2
// and W3 (the output layer's product is not needed); then the sweep's W4^T,
// W3^T and W2^T in slabs of SLAB_K of their output columns (W4: its 16) with
// all their input rows; then (dx) W1^T, its rows 0 .. 255 and then 256 ..
// di - 1 (at di > 256). rows = 0 past the end.
__device__ Slab slab_at(int s, int di, bool dx) {
  const int n1 = (di + SLAB_K - 1) / SLAB_K;
  if (s < n1) return {(size_t)s * SLAB_K * HID, min(SLAB_K, di - s * SLAB_K), HID, HID, LDB};
  s -= n1;
  if (s < 2 * HS) {
    const int l = 1 + s / HS, j = s % HS;
    return {layer_woff(0, di, l) + (size_t)j * SLAB_K * HID, SLAB_K, HID, HID, LDB};
  }
  s -= 2 * HS;
  if (s == 0) return {layer_woff(0, di, 3), HID, DO, DO, LDT};
  s -= 1;
  if (s < 2 * HS) {
    const int l = 2 - s / HS, j = s % HS;  // W3, W2
    return {layer_woff(0, di, l) + (size_t)j * SLAB_K, HID, SLAB_K, HID, LDT};
  }
  s -= 2 * HS;
  if (s < dx_passes(di, dx) * HS) {
    const int r0 = s / HS * HID, j = s % HS;
    return {(size_t)r0 * HID + (size_t)j * SLAB_K, min(HID, di - r0), SLAB_K, HID, LDT};
  }
  return {0, 0, 0, 0, 0};
}

// x [n, d_in], gout [n, d_out] f32 -> dx [n, d_in] (want_dx) and the scratch
// (m_rows rows) that the parameter pass reads. blockIdx.y is the scene, as
// in the forward; its scratch the y-th of m_rows rows.
__global__ void __launch_bounds__(BTHREADS, 1)
predictor_bwd_sweep_kernel(const float* __restrict__ x, int n, int d_in, int di, int d_out,
                           const bf16* __restrict__ W, const float* __restrict__ B,
                           const float* __restrict__ gout, float* __restrict__ dx, int want_dx,
                           bf16* __restrict__ scratch, int m_rows) {
  x += blockIdx.y * (size_t)n * d_in;
  gout += blockIdx.y * (size_t)n * d_out;
  if (want_dx) dx += blockIdx.y * (size_t)n * d_in;
  W += blockIdx.y * weight_elems(di);
  B += blockIdx.y * 4 * HID;
  scratch += blockIdx.y * Scratch::elems((size_t)m_rows, di);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* A = reinterpret_cast<bf16*>(smem_raw);  // input, activations, cotangents [PB][LDA]
  bf16* ring_base = reinterpret_cast<bf16*>(smem_raw + TILE_BYTES);
  SlabRec* recs = reinterpret_cast<SlabRec*>(ring_base + STAGES * STAGE_ELEMS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp / NQ, cq = warp % NQ;  // row group, column group
  const int g = lane >> 2, t = lane & 3;      // accumulator row and column pair
  const int p0 = blockIdx.x * PB;
  const size_t row0 = (size_t)p0;
  const Scratch S{scratch, (size_t)m_rows, di};
  const bool with_dx = want_dx != 0;
  const int count = n_slabs(di, with_dx);

  for (int i = tid; i < count; i += BTHREADS) recs[i] = slab_rec(slab_at(i, di, with_dx));
  load_x(x, n, d_in, di, p0, A);
  __syncthreads();
  {  // X to the scratch, 16 bytes a copy
    const int cb = di / 8;
    for (int v = tid; v < PB * cb; v += BTHREADS) {
      const int r = v / cb, c = (v - r * cb) * 8;
      *reinterpret_cast<uint4*>(S.x() + piece_off(row0 + r, c, di)) =
          *reinterpret_cast<const uint4*>(A + r * LDA + c);
    }
  }
  Ring ring{ring_base, W, recs, count, 0};
  for (int st = 0; st < STAGES - 1; ++st) ring.load(st);

  const unsigned a_x = smem_u32(A + (grp * 32 + (lane & 15)) * LDA + (lane >> 4) * 8);
  const int col0 = cq * WN * 8;
  const size_t go = piece_off(row0 + grp * 32 + g, col0 + 2 * t, HID);
  bf16* arow = A + (grp * 32 + g) * LDA + col0 + 2 * t;
  float acc[2][WN][4];

  // ---- recompute: H = relu(z + b) to the tile and the scratch ----
  for (int l = 0; l < 3; ++l) {
    zero(acc);
    product<false>(acc, ring, a_x, LDA, l == 0 ? di : HID, col0, HID - col0);
    __syncthreads();  // every warp is done reading the tile
    bf16* hg = S.hid(l) + go;
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      const float2 b2 = *reinterpret_cast<const float2*>(B + l * HID + col0 + j * 8 + 2 * t);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(fmaxf(acc[m][j][2 * hf] + b2.x, 0.0f),
                                    fmaxf(acc[m][j][2 * hf + 1] + b2.y, 0.0f));
          *reinterpret_cast<__nv_bfloat162*>(arow + (16 * m + 8 * hf) * LDA + j * 8) = v;
          *reinterpret_cast<__nv_bfloat162*>(hg + (2 * m + hf) * F_S + j * F_J) = v;
        }
    }
  }
  __syncthreads();  // the last H is in the tile: GZ4 goes over it

  // ---- reverse sweep ----
  {  // GZ4 = bf16(gout) in 16 columns, zeros past d_out and past n
    const int r = tid >> 2, c = (tid & 3) * 4;
    float v[4];
    for (int k = 0; k < 4; ++k)
      v[k] = p0 + r < n && c + k < d_out ? gout[(size_t)(p0 + r) * d_out + c + k] : 0.0f;
    const __nv_bfloat162 v01 = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 v23 = __floats2bfloat162_rn(v[2], v[3]);
    __nv_bfloat162* a2 = reinterpret_cast<__nv_bfloat162*>(A + r * LDA + c);
    a2[0] = v01;
    a2[1] = v23;
    __nv_bfloat162* g2 = reinterpret_cast<__nv_bfloat162*>(S.gz4() + piece_off(row0 + r, c, DO));
    g2[0] = v01;
    g2[1] = v23;
  }
  for (int l = 2; l >= 0; --l) {
    // the cotangent of H_l: GH = GZ_{l+1} @ W_{l+1}^T; then the ReLU mask
    zero(acc);
    product<true>(acc, ring, a_x, LDA, l == 2 ? DO : HID, col0, HID - col0);
    __syncthreads();  // every warp is done reading the cotangent tile
    const bf16* hl = S.hid(l) + go;
    bf16* gzl = S.gz(l) + go;
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float2 hv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(hl + (2 * m + hf) * F_S + j * F_J));
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(hv.x > 0.0f ? acc[m][j][2 * hf] : 0.0f,
                                    hv.y > 0.0f ? acc[m][j][2 * hf + 1] : 0.0f);
          *reinterpret_cast<__nv_bfloat162*>(gzl + (2 * m + hf) * F_S + j * F_J) = v;
          *reinterpret_cast<__nv_bfloat162*>(arow + (16 * m + 8 * hf) * LDA + j * 8) = v;
        }
  }

  // dx = GZ1 @ W1^T, 256 columns a pass, from the accumulators
  for (int c0 = 0; c0 < dx_passes(di, with_dx) * HID; c0 += HID) {
    zero(acc);
    product<true>(acc, ring, a_x, LDA, HID, col0, min(HID, di - c0) - col0);
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = p0 + grp * 32 + 16 * m + 8 * hf + g;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = c0 + col0 + j * 8 + 2 * t + e;
            if (r < n && c < d_in) dx[(size_t)r * d_in + c] = acc[m][j][2 * hf + e];
          }
        }
  }
}

// ---------------------------------------------------------------------------
// backward: weight and bias gradients
// ---------------------------------------------------------------------------

// The parameter pass's table: layer 1's input in 128-row parts, then two
// items each for layers 2-4; X and GZ from the scratch.
struct PwTab {
  int di;
  __host__ __device__ int n1() const { return (di + 127) / 128; }
  __host__ __device__ int n_items() const { return n1() + 6; }
  __host__ __device__ size_t w_total() const { return layer_woff(0, di, 3) + (size_t)HID * DO; }
  // floats of one chunk's partials: dW (packed), then dB [4][256]
  __host__ __device__ size_t part_row() const { return w_total() + 4 * HID; }
  __device__ PwTile tile(int t, bf16* scratch, size_t M) const {
    const Scratch S{scratch, M, di};
    const int l = t < n1() ? 0 : 1 + (t - n1()) / 2, it = t < n1() ? t : (t - n1()) % 2;
    const int xw = l == 0 ? di : HID, ldo = l == 3 ? DO : HID;
    return {l == 0 ? S.x() : S.hid(l - 1), l == 3 ? S.gz4() : S.gz(l), xw, 16 * it,
            min(16, xw / 8 - 16 * it), ldo / 8, layer_woff(0, di, l) + (size_t)it * 128 * ldo, ldo,
            it == 0 ? l : -1};
  }
};

__global__ void __launch_bounds__(PW_THREADS, 1)
predictor_bwd_params_kernel(PwTab tab, bf16* __restrict__ scratch, int m_rows,
                            int rows_per_chunk, float* __restrict__ part) {
  param_pass(tab, scratch, m_rows, rows_per_chunk, part, Scratch::elems((size_t)m_rows, tab.di));
}

__global__ void predictor_bwd_reduce_kernel(PwTab tab, const float* __restrict__ part,
                                            int n_chunks, float* __restrict__ dW,
                                            float* __restrict__ dB) {
  reduce_chunks(tab, part, n_chunks, dW, dB);
}

// rows of the backward's scratch: n rounded up to the parameter pass's stage
inline int bwd_rows(int n) { return (n + PW_RS - 1) / PW_RS * PW_RS; }

// The launches at S scenes of n rows each: scene s's rows are rows s n .. (s
// + 1) n - 1 of x, gout, dx and out, its weights W + s weight_elems(di), its
// biases B + s 4 256, its scratch and partials the s-th of S equal parts,
// its dW and dB the s-th rows of [S, weight_elems(di)] and [S, 4, 256]. Each
// scene's blocks run the one-scene code on its own pointers, with the
// chunks of one scene's rows, so a scene's outputs and gradients are those
// of its one-scene launch to the bit.
int fwd_scenes(const float* x, int n, int n_scenes, int d_in, int di, int d_out, const bf16* W,
               const float* B, float* out, cudaStream_t stream) {
  if (!dims_ok(d_in, di, d_out)) return (int)cudaErrorInvalidValue;
  if (n <= 0 || n_scenes <= 0) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      predictor_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F_SMEM);
  if (err != cudaSuccess) return (int)err;
  predictor_fwd_kernel<<<dim3((n + PB - 1) / PB, n_scenes), BTHREADS, F_SMEM, stream>>>(
      x, n, d_in, di, d_out, W, B, out);
  return (int)cudaGetLastError();
}

int sweep_scenes(const float* x, int n, int n_scenes, int d_in, int di, int d_out,
                 const bf16* W, const float* B, const float* gout, float* dx, int want_dx,
                 bf16* scratch, cudaStream_t stream) {
  if (!dims_ok(d_in, di, d_out)) return (int)cudaErrorInvalidValue;
  if (n <= 0 || n_scenes <= 0) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      predictor_bwd_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)B_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int m = bwd_rows(n);
  predictor_bwd_sweep_kernel<<<dim3(m / PB, n_scenes), BTHREADS, B_SMEM, stream>>>(
      x, n, d_in, di, d_out, W, B, gout, dx, want_dx, scratch, m);
  return (int)cudaGetLastError();
}

int params_scenes(int n, int n_scenes, int di, bf16* scratch, float* part, cudaStream_t stream) {
  if (!di_ok(di)) return (int)cudaErrorInvalidValue;
  if (n <= 0 || n_scenes <= 0) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      predictor_bwd_params_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)PW_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int m = bwd_rows(n);
  const PwTab tab{di};
  predictor_bwd_params_kernel<<<dim3(tab.n_items(), pw_chunks(m), n_scenes), PW_THREADS, PW_SMEM,
                                stream>>>(tab, scratch, m, pw_chunk_rows(m), part);
  return (int)cudaGetLastError();
}

int reduce_scenes(int n, int n_scenes, int di, const float* part, float* dW, float* dB,
                  cudaStream_t stream) {
  if (!di_ok(di)) return (int)cudaErrorInvalidValue;
  if (n <= 0 || n_scenes <= 0) return 0;
  const PwTab tab{di};
  predictor_bwd_reduce_kernel<<<dim3((unsigned)((tab.part_row() + 255) / 256), n_scenes), 256, 0,
                                stream>>>(tab, part, pw_chunks(bwd_rows(n)), dW, dB);
  return (int)cudaGetLastError();
}

// All three, three launches. With no rows nothing is launched: dW and dB stay
// as the caller made them.
int bwd_scenes(const float* x, int n, int n_scenes, int d_in, int di, int d_out, const bf16* W,
               const float* B, const float* gout, float* dx, int want_dx, bf16* scratch,
               float* part, float* dW, float* dB, cudaStream_t stream) {
  int rc = sweep_scenes(x, n, n_scenes, d_in, di, d_out, W, B, gout, dx, want_dx, scratch,
                        stream);
  if (rc) return rc;
  rc = params_scenes(n, n_scenes, di, scratch, part, stream);
  if (rc) return rc;
  return reduce_scenes(n, n_scenes, di, part, dW, dB, stream);
}

}  // namespace

extern "C" {

int predictor_tile() { return PB; }
int predictor_max_d_in() { return MAX_DI; }
int predictor_max_d_out() { return DO; }
size_t predictor_weight_elems(int di) { return weight_elems(di); }
// bf16 elements of the backward's scratch, floats of its partials, for n rows
// of a head whose input is padded to di (one scene's: S scenes take S times)
size_t predictor_scratch_elems(int n, int di) { return Scratch::elems((size_t)bwd_rows(n), di); }
size_t predictor_part_elems(int n, int di) {
  return (size_t)pw_chunks(bwd_rows(n)) * PwTab{di}.part_row();
}

int predictor_fwd(const float* x, int n, int d_in, int di, int d_out, const bf16* W,
                  const float* B, float* out, cudaStream_t stream) {
  return fwd_scenes(x, n, 1, d_in, di, d_out, W, B, out, stream);
}

// The backward's first part: recompute and reverse sweep, gout [n, d_out] ->
// dx [n, d_in] (if want_dx), and the scratch (predictor_scratch_elems bf16)
// for the second.
int predictor_bwd_sweep(const float* x, int n, int d_in, int di, int d_out, const bf16* W,
                        const float* B, const float* gout, float* dx, int want_dx,
                        bf16* scratch, cudaStream_t stream) {
  return sweep_scenes(x, n, 1, d_in, di, d_out, W, B, gout, dx, want_dx, scratch, stream);
}

// The second: the parameter pass, the scratch -> part (predictor_part_elems
// floats).
int predictor_bwd_params(int n, int di, bf16* scratch, float* part, cudaStream_t stream) {
  return params_scenes(n, 1, di, scratch, part, stream);
}

// The third: dW (packed layout, f32) and dB [4][256], every element.
int predictor_bwd_reduce(int n, int di, const float* part, float* dW, float* dB,
                         cudaStream_t stream) {
  return reduce_scenes(n, 1, di, part, dW, dB, stream);
}

// All three, three launches. With no rows nothing is launched: dW and dB stay
// as the caller made them.
int predictor_bwd(const float* x, int n, int d_in, int di, int d_out, const bf16* W,
                  const float* B, const float* gout, float* dx, int want_dx, bf16* scratch,
                  float* part, float* dW, float* dB, cudaStream_t stream) {
  return bwd_scenes(x, n, 1, d_in, di, d_out, W, B, gout, dx, want_dx, scratch, part, dW, dB,
                    stream);
}

// S scenes of n rows in one launch each way (fwd_scenes, bwd_scenes): x [S,
// n, d_in]; W [S, predictor_weight_elems(di)] bf16; B [S, 4, 256]; out [S, n,
// d_out]; gout [S, n, d_out], dx [S, n, d_in]; the scratch and the partials
// S times one scene's; dW [S, predictor_weight_elems(di)], dB [S, 4, 256].
int predictor_fwd_scenes(const float* x, int n, int n_scenes, int d_in, int di, int d_out,
                         const bf16* W, const float* B, float* out, cudaStream_t stream) {
  return fwd_scenes(x, n, n_scenes, d_in, di, d_out, W, B, out, stream);
}

int predictor_bwd_scenes(const float* x, int n, int n_scenes, int d_in, int di, int d_out,
                         const bf16* W, const float* B, const float* gout, float* dx,
                         int want_dx, bf16* scratch, float* part, float* dW, float* dB,
                         cudaStream_t stream) {
  return bwd_scenes(x, n, n_scenes, d_in, di, d_out, W, B, gout, dx, want_dx, scratch, part, dW,
                    dB, stream);
}

}  // extern "C"
