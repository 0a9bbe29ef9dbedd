// Building blocks shared by the port's hand-written Hopper kernels.
//
//  * block_mm: a block-wide matrix product C (f32, shared memory) = A (bf16,
//    shared memory, row-major) @ B (bf16, device memory, row- or
//    column-major), on the tensor cores through WMMA 16x16x16 bf16 tiles
//    with f32 accumulation -- the numerics of the TPU kernels' bf16-operand /
//    f32-accumulate matmuls. Each warp owns a 64x16 output strip (four
//    accumulator fragments) and streams its B fragments from device memory
//    (the weights stay resident in the 50 MB L2). It has two users left: the
//    forward of predictor.cu and sdf_fwd.cu.
// The backwards' weight and bias gradients are engine.cuh's parameter pass
// (or the copies of it in shader.cu and sdf_grad.cu).
#pragma once

#include <cuda_bf16.h>
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

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

}  // namespace nero
