// Building blocks shared by the port's hand-written Hopper kernels.
//
//  * block_mm: a block-wide matrix product C (f32, shared memory) = A (bf16,
//    shared memory, row-major) @ B (bf16, device memory, row- or
//    column-major), on the tensor cores through WMMA 16x16x16 bf16 tiles
//    with f32 accumulation -- the numerics of the TPU kernels' bf16-operand /
//    f32-accumulate matmuls. Each warp owns a 64x16 output strip (four
//    accumulator fragments) and streams its B fragments from device memory
//    (the weights stay resident in the 50 MB L2).
//  * dw_partial_kernel + reduce_kernel: weight gradients dW = X^T G summed
//    over all rows, the row tiles staged through shared memory by a
//    two-stage asynchronous-copy pipeline. Hopper blocks run in no order,
//    so unlike the TPU's sequential-grid accumulators every block writes
//    the partial sum of its row chunk and a second pass adds the chunks in
//    a fixed order (deterministic, no atomics).
//  * colsum_partial_kernel: bias gradients, the same two-pass scheme.
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <type_traits>

namespace nero {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ bf16 to_bf(float x) { return __float2bfloat16(x); }
__device__ __forceinline__ float from_bf(bf16 x) { return __bfloat162float(x); }

// C[M,N] (=|+=) A[M,K] @ B[K,N]. B_COL: B(k,n) = B[n*ldb + k] (a row-major
// [N,K] weight used transposed); else B(k,n) = B[k*ldb + n].
// M % 64 == 0, N % 16 == 0, K % 16 == 0; lda, ldb multiples of 8, ldc of 4,
// all tile pointers 32-byte aligned. Callers synchronise the block around it.
template <bool B_COL>
__device__ __forceinline__ void block_mm(const bf16* A, int lda, const bf16* B, int ldb,
                                         float* C, int ldc, int M, int N, int K, bool acc) {
  using BLayout = typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int ntiles = N / 16;
  const int items = (M / 64) * ntiles;
  for (int item = warp; item < items; item += nwarps) {
    const int mg = item / ntiles, nt = item % ntiles;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* cp = C + (mg * 64 + i * 16) * ldc + nt * 16;
      if (acc) wmma::load_matrix_sync(c[i], cp, ldc, wmma::mem_row_major);
      else wmma::fill_fragment(c[i], 0.0f);
    }
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b;
      const bf16* bp = B_COL ? B + (size_t)nt * 16 * ldb + k : B + (size_t)k * ldb + nt * 16;
      wmma::load_matrix_sync(b, bp, ldb);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + (mg * 64 + i * 16) * lda + k, lda);
        wmma::mma_sync(c[i], a, b, c[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wmma::store_matrix_sync(C + (mg * 64 + i * 16) * ldc + nt * 16, c[i], ldc,
                              wmma::mem_row_major);
  }
}

constexpr int DW_THREADS = 512;  // 16 warps: a 128 x 256 output tile per block
constexpr int DW_ROWS = 32;      // rows per pipeline stage
constexpr int DW_LDX = 128 + 8, DW_LDG = 256 + 8;
constexpr int DW_STAGE = DW_ROWS * (DW_LDX + DW_LDG);
constexpr size_t DW_SMEM = 2 * DW_STAGE * sizeof(bf16);

// Stage rows [m, m + DW_ROWS) of X[:, kb:kb+128] and G[:, nb:nb+256] into
// shared memory with 16-byte asynchronous copies (zeros past the edges).
__device__ __forceinline__ void dw_load_stage(bf16* st, const bf16* X, int ldx, const bf16* G,
                                              int ldg, int m, int m1, int kb, int K, int nb,
                                              int N) {
  bf16* xs = st;
  bf16* gs = st + DW_ROWS * DW_LDX;
  for (int v = threadIdx.x; v < DW_ROWS * 16; v += DW_THREADS) {
    const int r = v / 16, c = (v % 16) * 8;
    bf16* dst = xs + r * DW_LDX + c;
    if (m + r < m1 && kb + c < K) __pipeline_memcpy_async(dst, X + (size_t)(m + r) * ldx + kb + c, 16);
    else *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  for (int v = threadIdx.x; v < DW_ROWS * 32; v += DW_THREADS) {
    const int r = v / 32, c = (v % 32) * 8;
    bf16* dst = gs + r * DW_LDG + c;
    if (m + r < m1 && nb + c < N) __pipeline_memcpy_async(dst, G + (size_t)(m + r) * ldg + nb + c, 16);
    else *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  __pipeline_commit();
}

// part[chunk][K][N] = sum over rows m of chunk: X[m,k] * G[m,n].
// X [M, ldx] and G [M, ldg] bf16 row-major; K, N multiples of 16; ldx, ldg
// multiples of 8; rows_per_chunk a multiple of DW_ROWS. Two-stage pipeline:
// the next 32 rows are copied while the tensor cores work on these.
__global__ void __launch_bounds__(DW_THREADS) dw_partial_kernel(
    const bf16* __restrict__ X, int ldx, const bf16* __restrict__ G, int ldg, int M, int K,
    int N, int rows_per_chunk, float* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char dw_smem[];
  bf16* stage[2] = {reinterpret_cast<bf16*>(dw_smem),
                    reinterpret_cast<bf16*>(dw_smem) + DW_STAGE};
  const int warp = threadIdx.x >> 5;
  const int kl = (warp / 4) * 2, nl = (warp % 4) * 4;  // local tiles of this warp
  const int kb = blockIdx.x * 128, nb = blockIdx.y * 256;
  const int kt0 = kb / 16 + kl, nt0 = nb / 16 + nl;
  const int ktiles = K / 16, ntiles = N / 16;
  const int m0 = blockIdx.z * rows_per_chunk;
  const int m1 = min(M, m0 + rows_per_chunk);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(c[i][j], 0.0f);
  const bool active = kt0 < ktiles && nt0 < ntiles;
  if (m0 < m1) dw_load_stage(stage[0], X, ldx, G, ldg, m0, m1, kb, K, nb, N);
  int s = 0;
  for (int m = m0; m < m1; m += DW_ROWS, s ^= 1) {
    if (m + DW_ROWS < m1) {
      dw_load_stage(stage[s ^ 1], X, ldx, G, ldg, m + DW_ROWS, m1, kb, K, nb, N);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    if (active) {
      const bf16* xs = stage[s];
      const bf16* gs = stage[s] + DW_ROWS * DW_LDX;
#pragma unroll
      for (int rr = 0; rr < DW_ROWS; rr += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], xs + rr * DW_LDX + (kl + i) * 16, DW_LDX);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, gs + rr * DW_LDG + (nl + j) * 16, DW_LDG);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(c[i][j], a[i], b, c[i][j]);
        }
      }
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * K * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (kt0 + i < ktiles && nt0 + j < ntiles)
        wmma::store_matrix_sync(out + (size_t)(kt0 + i) * 16 * N + (nt0 + j) * 16, c[i][j], N,
                                wmma::mem_row_major);
}

// part[chunk][n] = sum over rows m of chunk with (m % period) < keep of G[m,n].
// Block (32, 8): 32 columns, 8 row lanes reduced through shared memory.
constexpr int COLSUM_ROWS = 1024;  // rows per chunk
__global__ void colsum_partial_kernel(const bf16* __restrict__ G, int ldg, int M, int N,
                                      int period, int keep, float* __restrict__ part) {
  __shared__ float acc[8][33];
  const int n = blockIdx.x * 32 + threadIdx.x;
  const int m0 = blockIdx.y * COLSUM_ROWS;
  const int m1 = min(M, m0 + COLSUM_ROWS);
  float s = 0.0f;
  if (n < N)
    for (int m = m0 + threadIdx.y; m < m1; m += 8)
      if (m % period < keep) s += from_bf(G[(size_t)m * ldg + n]);
  acc[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && n < N) {
    float t = 0.0f;
    for (int y = 0; y < 8; ++y) t += acc[y][threadIdx.x];
    part[(size_t)blockIdx.y * N + n] = t;
  }
}

// out[i] (=|+=) sum over chunks of part[chunk][i], in chunk order.
__global__ void reduce_kernel(const float* __restrict__ part, int n_chunks, int n,
                              float* __restrict__ out, int accumulate) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = accumulate ? out[i] : 0.0f;
  for (int c = 0; c < n_chunks; ++c) s += part[(size_t)c * n + i];
  out[i] = s;
}

// Row chunks of the weight-gradient pass: at least min_rows rows each, at
// most 64 chunks (enough blocks to fill the card for every layer shape).
inline int dw_chunks(int M, int min_rows) {
  const int c = M / min_rows;
  return c < 1 ? 1 : c > 64 ? 64 : c;
}

inline int chunk_rows(int M, int n_chunks) {
  int r = (M + n_chunks - 1) / n_chunks;
  return (r + DW_ROWS - 1) / DW_ROWS * DW_ROWS;
}

// out[K,N] (=|+=) X^T G over all M rows; part holds n_chunks * K * N floats.
inline void weight_grad(const bf16* X, int ldx, const bf16* G, int ldg, int M, int K, int N,
                        int n_chunks, float* part, float* out, int accumulate,
                        cudaStream_t stream) {
  const int rows = chunk_rows(M, n_chunks);
  dim3 grid((K + 127) / 128, (N + 255) / 256, n_chunks);
  cudaFuncSetAttribute(dw_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)DW_SMEM);
  dw_partial_kernel<<<grid, DW_THREADS, DW_SMEM, stream>>>(X, ldx, G, ldg, M, K, N, rows, part);
  const int n = K * N;
  reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, n_chunks, n, out, accumulate);
}

// out[N] (=|+=) column sums of the rows of G with (m % period) < keep;
// part holds bias_chunks(M) * N floats.
inline int bias_chunks(int M) { return (M + COLSUM_ROWS - 1) / COLSUM_ROWS; }
inline void bias_grad(const bf16* G, int ldg, int M, int N, int period, int keep, float* part,
                      float* out, int accumulate, cudaStream_t stream) {
  const int chunks = bias_chunks(M);
  dim3 grid((N + 31) / 32, chunks);
  colsum_partial_kernel<<<grid, dim3(32, 8), 0, stream>>>(G, ldg, M, N, period, keep, part);
  reduce_kernel<<<(N + 255) / 256, 256, 0, stream>>>(part, chunks, N, out, accumulate);
}

// Floats of `part` that weight_grad (n_chunks, outputs up to K x N) and
// bias_grad (outputs up to N) need for M rows.
inline size_t part_elems(int M, int n_chunks, int K, int N) {
  const size_t dw = (size_t)n_chunks * K * N, db = (size_t)bias_chunks(M) * N;
  return dw > db ? dw : db;
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

}  // namespace nero
