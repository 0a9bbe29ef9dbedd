// One 4-layer prediction head, forward and backward, for Hopper (sm_90a).
//
// Replaces nero_tpu/ops/pallas/predictor_kernel.py::predictor_fused (:226),
// pallas_calls nero_predictor_fwd (:151) and nero_predictor_bwd (:171):
// x [n, d_in] -> 3 x (product + bias + ReLU, 256 wide) -> product + bias ->
// out [n, d_out], pre-activation; the final sigmoid / exp stays outside.
// Weights arrive weight-norm-resolved, bf16, [in, out] row-major, w1 padded
// to a multiple of 16 rows and w4 to 16 columns; sums are f32 (block_mm).
// Any d_in up to 272 and d_out up to 16: every head of the Stage-I shader.
//
// Forward (predictor_rows_kernel<false>): one block per tile of P = 64 rows;
// only x comes in and only out goes out. Rows past n are masked.
//
// Backward: the TPU kernel adds dW and db into VMEM accumulators across a
// sequential grid (:112-134). Blocks on this card run in no order, so
// predictor_rows_kernel<true> recomputes its tile's forward, keeps the three
// ReLU masks (taken from the f32 pre-activation, z > 0) in shared memory,
// writes the layer inputs X, H1..H3 and the pre-activation cotangents
// dZ1..dZ4 (bf16) to device memory and the input cotangent dx = dZ1 @ W1^T
// to its output; dW_l = H_l^T dZ_l and db_l then come from the two-pass
// chunked reduction of common.cuh: per-chunk partial sums added in a fixed
// order, no atomics.
//
// Bound: tensor-core operations, 2 * (d_in*256 + 2*256*256 + 256*d_out) per
// row forward and 3x that backward, against 4 * (d_in + d_out) bytes per
// row. This first version streams the weights from L2 and round-trips the
// backward's activations (about 3.6 KB a row) through device memory.
#include "common.cuh"

using namespace nero;

namespace {

constexpr int P = 64;
constexpr int NTHREADS = 512;
constexpr int HID = 256;
constexpr int DO = 16;       // head outputs padded
constexpr int MAX_DI = 272;  // the widest input: [feats, pts] = 259, padded
constexpr int LDX = MAX_DI + 8, LDH = HID + 8, LDC = MAX_DI + 4;
constexpr int DW_CHUNK_MIN_ROWS = 2048;  // rows per weight-gradient chunk, at least
constexpr size_t SMEM_FWD = (size_t)P * LDX * 2 + (size_t)P * LDH * 2 + (size_t)P * LDC * 4;
constexpr size_t SMEM_BWD = SMEM_FWD + 3 * (size_t)P * HID;  // + the ReLU masks

// backward scratch for M rows (bf16): X [M][di], H [3][M][256], DZ [3][M][256],
// DZ4 [M][16]
struct Scratch {
  bf16 *X, *H, *DZ, *DZ4;
  __host__ __device__ Scratch(bf16* base, size_t M, int di) {
    X = base;
    H = X + M * di;
    DZ = H + 3 * M * HID;
    DZ4 = DZ + 3 * M * HID;
  }
  static size_t elems(size_t M, int di) { return M * di + 6 * M * HID + M * DO; }
};

__host__ __device__ inline void head_layers(const bf16* W, int di, const bf16** Wl) {
  Wl[0] = W;
  Wl[1] = Wl[0] + (size_t)di * HID;
  Wl[2] = Wl[1] + (size_t)HID * HID;
  Wl[3] = Wl[2] + (size_t)HID * HID;
}

// x [n, d_in] f32; W packed bf16 (w1 [di,256], w2, w3, w4 [256,16]); B [4][256]
// f32. Forward: out [n, d_out]. Backward: gout [n, d_out] -> dx [n, d_in] (if
// want_dx) and the scratch that feeds the weight-gradient pass.
template <bool BWD>
__global__ void __launch_bounds__(NTHREADS, 1)
predictor_rows_kernel(const float* __restrict__ x, int n, int d_in, int di, int d_out,
                      const bf16* __restrict__ W, const float* __restrict__ B,
                      float* __restrict__ out, const float* __restrict__ gout,
                      float* __restrict__ dx, int want_dx, bf16* __restrict__ scratch,
                      int m_rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* X = reinterpret_cast<bf16*>(smem_raw);
  bf16* Hb = X + P * LDX;
  float* C = reinterpret_cast<float*>(Hb + P * LDH);
  unsigned char* mask = reinterpret_cast<unsigned char*>(C + P * LDC);  // [3][P][HID], BWD
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * P;
  const size_t row0 = (size_t)p0;
  const size_t M = (size_t)m_rows;
  Scratch S(scratch, M, di);
  const bf16* Wl[4];
  head_layers(W, di, Wl);

  for (int idx = tid; idx < P * di; idx += NTHREADS) {
    const int r = idx / di, c = idx % di;
    const float v = (p0 + r < n && c < d_in) ? x[(size_t)(p0 + r) * d_in + c] : 0.0f;
    const bf16 bv = to_bf(v);
    X[r * LDX + c] = bv;
    if (BWD) S.X[(row0 + r) * di + c] = bv;
  }
  __syncthreads();

  for (int l = 0; l < 3; ++l) {
    if (l == 0) block_mm<false>(X, LDX, Wl[0], HID, C, LDC, P, HID, di, false);
    else block_mm<false>(Hb, LDH, Wl[l], HID, C, LDC, P, HID, HID, false);
    __syncthreads();
    for (int idx = tid; idx < P * HID; idx += NTHREADS) {
      const int r = idx / HID, c = idx % HID;
      const float z = C[r * LDC + c] + B[l * HID + c];
      const bf16 v = to_bf(fmaxf(z, 0.0f));
      Hb[r * LDH + c] = v;
      if (BWD) {
        mask[(l * P + r) * HID + c] = z > 0.0f;
        S.H[((size_t)l * M + row0 + r) * HID + c] = v;
      }
    }
    __syncthreads();
  }

  if (!BWD) {
    block_mm<false>(Hb, LDH, Wl[3], DO, C, LDC, P, DO, HID, false);
    __syncthreads();
    for (int idx = tid; idx < P * d_out; idx += NTHREADS) {
      const int r = idx / d_out, c = idx % d_out;
      if (p0 + r < n) out[(size_t)(p0 + r) * d_out + c] = C[r * LDC + c] + B[3 * HID + c];
    }
    return;
  }

  // ---- backward: dZ4 = gout, then the ReLU chain in reverse ----
  for (int idx = tid; idx < P * DO; idx += NTHREADS) {
    const int r = idx / DO, c = idx % DO;
    const float g = (c < d_out && p0 + r < n) ? gout[(size_t)(p0 + r) * d_out + c] : 0.0f;
    const bf16 v = to_bf(g);
    Hb[r * LDH + c] = v;
    S.DZ4[(row0 + r) * DO + c] = v;
  }
  __syncthreads();
  block_mm<true>(Hb, LDH, Wl[3], DO, C, LDC, P, HID, DO, false);  // dH3
  __syncthreads();
  for (int l = 2; l >= 0; --l) {
    bf16* DZ = S.DZ + (size_t)l * M * HID;
    for (int idx = tid; idx < P * HID; idx += NTHREADS) {
      const int r = idx / HID, c = idx % HID;
      const bf16 v = to_bf(mask[(l * P + r) * HID + c] ? C[r * LDC + c] : 0.0f);
      Hb[r * LDH + c] = v;
      DZ[(row0 + r) * HID + c] = v;
    }
    __syncthreads();
    if (l > 0) block_mm<true>(Hb, LDH, Wl[l], HID, C, LDC, P, HID, HID, false);
    else if (want_dx) block_mm<true>(Hb, LDH, Wl[0], HID, C, LDC, P, di, HID, false);
    __syncthreads();
  }
  if (want_dx) {
    for (int idx = tid; idx < P * d_in; idx += NTHREADS) {
      const int r = idx / d_in, c = idx % d_in;
      if (p0 + r < n) dx[(size_t)(p0 + r) * d_in + c] = C[r * LDC + c];
    }
  }
}

inline bool dims_ok(int d_in, int di, int d_out) {
  return d_in >= 1 && di >= d_in && di % 16 == 0 && di <= MAX_DI && d_out >= 1 && d_out <= DO;
}

}  // namespace

extern "C" {

int predictor_tile() { return P; }
int predictor_max_d_in() { return MAX_DI; }
int predictor_max_d_out() { return DO; }
size_t predictor_weight_elems(int di) {
  return (size_t)di * HID + 2 * (size_t)HID * HID + (size_t)HID * DO;
}
size_t predictor_scratch_elems(int m_rows, int di) { return Scratch::elems((size_t)m_rows, di); }
// the reduction scratch covers the widest product of any head: the first layer
// at the widest input (272 x 256), which also covers the 256 x 256 hidden ones
size_t predictor_part_elems(int m_rows) {
  return part_elems(m_rows, dw_chunks(m_rows, DW_CHUNK_MIN_ROWS), MAX_DI, HID);
}

int predictor_fwd(const float* x, int n, int d_in, int di, int d_out, const bf16* W,
                  const float* B, float* out, cudaStream_t stream) {
  if (!dims_ok(d_in, di, d_out)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(predictor_rows_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_FWD);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + P - 1) / P;
  predictor_rows_kernel<false><<<tiles, NTHREADS, SMEM_FWD, stream>>>(
      x, n, d_in, di, d_out, W, B, out, nullptr, nullptr, 0, nullptr, tiles * P);
  return (int)cudaGetLastError();
}

// gout [n, d_out] -> dx [n, d_in] (if want_dx), dW (packed layout, f32), dB
// [4][256] (zeroed by the caller). scratch: predictor_scratch_elems bf16;
// part: predictor_part_elems floats; m_rows = n rounded up to the tile.
int predictor_bwd(const float* x, int n, int d_in, int di, int d_out, const bf16* W,
                  const float* B, const float* gout, float* dx, int want_dx, bf16* scratch,
                  float* part, float* dW, float* dB, cudaStream_t stream) {
  if (!dims_ok(d_in, di, d_out)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(predictor_rows_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BWD);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + P - 1) / P;
  const int M = tiles * P;
  predictor_rows_kernel<true><<<tiles, NTHREADS, SMEM_BWD, stream>>>(
      x, n, d_in, di, d_out, W, B, nullptr, gout, dx, want_dx, scratch, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = dw_chunks(M, DW_CHUNK_MIN_ROWS);
  Scratch S(scratch, (size_t)M, di);
  const size_t LH = (size_t)M * HID;
  weight_grad(S.X, di, S.DZ, HID, M, di, HID, n_chunks, part, dW, 0, stream);
  weight_grad(S.H, HID, S.DZ + LH, HID, M, HID, HID, n_chunks, part, dW + (size_t)di * HID, 0,
              stream);
  weight_grad(S.H + LH, HID, S.DZ + 2 * LH, HID, M, HID, HID, n_chunks, part,
              dW + (size_t)di * HID + HID * HID, 0, stream);
  weight_grad(S.H + 2 * LH, HID, S.DZ4, DO, M, HID, DO, n_chunks, part,
              dW + (size_t)di * HID + 2 * HID * HID, 0, stream);
  for (int l = 0; l < 3; ++l)
    bias_grad(S.DZ + l * LH, HID, M, HID, 1, 1, part, dB + l * HID, 0, stream);
  bias_grad(S.DZ4, DO, M, DO, 1, 1, part, dB + 3 * HID, 0, stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
