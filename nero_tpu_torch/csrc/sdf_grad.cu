// SDF MLP with its spatial gradient, forward and backward, for Hopper (sm_90a).
//
// Replaces nero_tpu/ops/pallas/sdf_grad_kernel.py::sdf_with_grad_fused
// (pallas_call nero_sdf_grad_fwd :363 and nero_sdf_grad_bwd :387).
//
// Forward (sdf_rows_kernel<false>): one block per tile of P = 32 points.
// The tile's PE(6) and its three tangents (d/dx, d/dy, d/dz) are stacked
// into 4P = 128 rows and run through the 9 layers in shared memory: the
// bias on primal rows only, the tangent rule u' = sigmoid(beta z) * (u @ W),
// the 217-column mask at layer 3 and the skip layer as two products (w4a on
// h3, w4b on the PE). Emits sdf, feats[256] and grad[3]; nothing but the
// points comes in and nothing but these goes out.
//
// Backward: where the TPU kept nine stacked pre-activations of its row block
// in VMEM (4.7 MB), a Hopper block has 227 KB. So sdf_rows_kernel<true>
// recomputes the forward of its tile and writes pre-activations Z (bf16, as
// the TPU kernel stores them), layer inputs H and the PE to device memory,
// then runs the reverse sweep of its tile in shared memory (the through_act
// second-order softplus'' epilogue of sdf_grad_kernel.py:297-309) and writes
// each layer's pre-activation cotangent GZ. The parameter gradients
// dW_l = H_l^T GZ_l and db_l = sum of primal rows of GZ_l then come from the
// two-pass chunked reduction of common.cuh (the TPU accumulated them across
// a sequential grid). Point gradients are not produced: sample positions are
// detached upstream, as on the TPU (sdf_grad_kernel.py:431-432).
//
// Bound: tensor-core operations at 989 TFLOP/s bf16 (ops/sdf_grad.py::flops):
// 4 stacked rows through layers 0-7, but at layer 8 only the primal row
// needs all 257 outputs; a tangent row needs the sdf column alone. This
// first version is far from it: WMMA tiles fed from shared memory and L2,
// one 227 KB block per SM, layer 8 run at all 272 columns for the tangent
// rows too, and the backward's scratch round trip through device memory
// (about 3.4 GB at N = 65,536).
#include "sdf_net.cuh"

using namespace nero;
using namespace nero::sdfnet;

namespace {

constexpr int P = 32;           // points per tile
constexpr int ROWS = 4 * P;     // primal + 3 tangent rows
constexpr int LDA = OUTW + 8;   // shared-memory leading dims (bank skew)
constexpr int LDP = PEW + 8;
constexpr int LDC = OUTW + 4;
constexpr int NTHREADS = 512;
constexpr int DW_CHUNK_MIN_ROWS = 4096;  // stacked rows per weight-gradient chunk, at least
constexpr size_t SMEM_BYTES =
    (size_t)ROWS * LDA * 2 + (size_t)ROWS * LDP * 2 + (size_t)ROWS * LDC * 4;

// scratch (bf16) per M = 4 * n_pad stacked rows: Z[8][M][256], H[8][M][256],
// GZ[8][M][256], GZ8[M][272], PE[M][48]
struct Scratch {
  bf16 *Z, *H, *GZ, *GZ8, *PE;
  __host__ __device__ Scratch(bf16* base, size_t M) {
    Z = base;
    H = Z + 8 * M * HID;
    GZ = H + 8 * M * HID;
    GZ8 = GZ + 8 * M * HID;
    PE = GZ8 + M * OUTW;
  }
  static size_t elems(size_t M) { return 24 * M * HID + M * OUTW + M * PEW; }
};

template <bool BWD>
__global__ void __launch_bounds__(NTHREADS, 1)
sdf_rows_kernel(const float* __restrict__ pts, const bf16* __restrict__ W,
                const float* __restrict__ bias, float beta, float scale, int n_pad,
                float* __restrict__ out_sdf, float* __restrict__ out_grad,
                float* __restrict__ out_feats, const float* __restrict__ d_sdf,
                const float* __restrict__ d_grad, const float* __restrict__ d_feats,
                bf16* __restrict__ scratch) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* A = reinterpret_cast<bf16*>(smem);
  bf16* PEb = A + ROWS * LDA;
  float* C = reinterpret_cast<float*>(PEb + ROWS * LDP);
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * P;
  const size_t M = 4 * (size_t)n_pad;
  const size_t row0 = (size_t)blockIdx.x * ROWS;
  Scratch S(scratch, M);

  // PE(6) of the scaled points and its tangents w.r.t. the unscaled points
  for (int idx = tid; idx < ROWS * PEW; idx += NTHREADS) {
    const int row = idx / PEW, c = idx % PEW;
    const int s = row / P, r = row % P;
    float v = 0.0f;
    if (c < 3) {
      v = s == 0 ? pts[(p0 + r) * 3 + c] * scale : (c == s - 1 ? scale : 0.0f);
    } else if (c < NPE) {
      const int i = (c - 3) / 6, q = (c - 3) % 6, k = q % 3;
      const bool is_cos = q >= 3;
      const float f = (float)(1 << i);
      const float x = pts[(p0 + r) * 3 + k] * scale * f;
      if (s == 0) v = is_cos ? cosf(x) : sinf(x);
      else if (k == s - 1) v = scale * f * (is_cos ? -sinf(x) : cosf(x));
    }
    const bf16 bv = to_bf(v);
    PEb[row * LDP + c] = bv;
    if (BWD) S.PE[(row0 + row) * PEW + c] = bv;
  }
  __syncthreads();

  const int n_fwd = BWD ? 8 : 9;  // the backward needs layers 0..7 only
  for (int l = 0; l < n_fwd; ++l) {
    if (l == 0) {
      block_mm<false>(PEb, LDP, W + OFF_W0, HID, C, LDC, ROWS, HID, PEW, false);
    } else if (l == 4) {
      block_mm<false>(A, LDA, W + OFF_W4A, HID, C, LDC, ROWS, HID, HID, false);
      __syncthreads();
      block_mm<false>(PEb, LDP, W + OFF_W4B, HID, C, LDC, ROWS, HID, PEW, true);
    } else if (l == 8) {
      block_mm<false>(A, LDA, W + OFF_W8, OUTW, C, LDC, ROWS, OUTW, HID, false);
    } else {
      block_mm<false>(A, LDA, W + layer_off(l), HID, C, LDC, ROWS, HID, HID, false);
    }
    __syncthreads();
    if (l == 8) break;
    // activation: primal softplus, tangents sigmoid(beta z_primal) * z_tangent
    for (int idx = tid; idx < P * HID; idx += NTHREADS) {
      const int r = idx / HID, c = idx % HID;
      const float zp = C[r * LDC + c] + bias[l * OUTW + c];
      const float s = sigmoidf_(beta * zp);
      const bool masked = (l == 3 && c >= MASK_W);
      const float hp = masked ? 0.0f : softplus_b(zp, beta);
      A[r * LDA + c] = to_bf(hp);
      if (BWD) {
        S.Z[((size_t)l * M + row0 + r) * HID + c] = to_bf(zp);
        S.H[((size_t)l * M + row0 + r) * HID + c] = to_bf(hp);
      }
#pragma unroll
      for (int j = 1; j < 4; ++j) {
        const int row = j * P + r;
        const float zt = C[row * LDC + c];
        const float ht = masked ? 0.0f : s * zt;
        A[row * LDA + c] = to_bf(ht);
        if (BWD) {
          S.Z[((size_t)l * M + row0 + row) * HID + c] = to_bf(zt);
          S.H[((size_t)l * M + row0 + row) * HID + c] = to_bf(ht);
        }
      }
    }
    __syncthreads();
  }

  if (!BWD) {
    for (int idx = tid; idx < P * 257; idx += NTHREADS) {
      const int r = idx / 257, c = idx % 257;
      const float v = C[r * LDC + c] + bias[8 * OUTW + c];
      if (c == 0) out_sdf[p0 + r] = v;
      else out_feats[(size_t)(p0 + r) * HID + c - 1] = v;
    }
    for (int idx = tid; idx < P * 3; idx += NTHREADS) {
      const int r = idx / 3, j = idx % 3;
      out_grad[(p0 + r) * 3 + j] = C[((j + 1) * P + r) * LDC];
    }
    return;
  }

  // reverse sweep. Cotangent of z8: primal rows [d_sdf, d_feats], tangent
  // row j carries d_grad_j in the sdf column.
  for (int idx = tid; idx < ROWS * OUTW; idx += NTHREADS) {
    const int row = idx / OUTW, c = idx % OUTW;
    const int s = row / P, r = row % P;
    float g = 0.0f;
    if (s == 0) {
      if (c == 0) g = d_sdf[p0 + r];
      else if (c <= HID) g = d_feats[(size_t)(p0 + r) * HID + c - 1];
    } else if (c == 0) {
      g = d_grad[(p0 + r) * 3 + s - 1];
    }
    const bf16 gb = to_bf(g);
    A[row * LDA + c] = gb;
    S.GZ8[(row0 + row) * OUTW + c] = gb;
  }
  __syncthreads();

  for (int l = 8; l >= 1; --l) {
    // cotangent of h_l = act(z_{l-1}):  GH = GZ_l @ W_l^T  (w4a for the skip)
    const int ldw = l == 8 ? OUTW : HID;
    block_mm<true>(A, LDA, W + layer_off(l), ldw, C, LDC, ROWS, HID, ldw, false);
    __syncthreads();
    const int lp = l - 1;
    const bf16* Z = S.Z + (size_t)lp * M * HID;
    for (int idx = tid; idx < P * HID; idx += NTHREADS) {
      const int r = idx / HID, c = idx % HID;
      const float zp = from_bf(Z[(row0 + r) * HID + c]);
      const float s = sigmoidf_(beta * zp);
      const float s2 = beta * s * (1.0f - s);  // softplus_b''
      const bool masked = (lp == 3 && c >= MASK_W);
      float mix = 0.0f;
      float gzt[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int row = (j + 1) * P + r;
        const float ght = C[row * LDC + c];
        mix += from_bf(Z[(row0 + row) * HID + c]) * ght;
        gzt[j] = masked ? 0.0f : s * ght;
      }
      const float gzp = masked ? 0.0f : s * C[r * LDC + c] + s2 * mix;
      bf16* GZ = S.GZ + (size_t)lp * M * HID;
      A[r * LDA + c] = to_bf(gzp);
      GZ[(row0 + r) * HID + c] = to_bf(gzp);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int row = (j + 1) * P + r;
        A[row * LDA + c] = to_bf(gzt[j]);
        GZ[(row0 + row) * HID + c] = to_bf(gzt[j]);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

size_t sdf_grad_weight_elems() { return W_TOTAL; }
int sdf_grad_tile() { return P; }
size_t sdf_grad_scratch_elems(int n_pad) { return Scratch::elems(4 * (size_t)n_pad); }
size_t sdf_grad_part_elems(int n_pad) {
  return part_elems(4 * n_pad, dw_chunks(4 * n_pad, DW_CHUNK_MIN_ROWS), HID, OUTW);
}

// pts [n_pad,3] f32 (n_pad % 32 == 0); W packed bf16; bias [9,272] f32.
int sdf_grad_fwd(const float* pts, int n_pad, const bf16* W, const float* bias, float beta,
                 float scale, float* sdf, float* grad, float* feats, cudaStream_t stream) {
  cudaFuncSetAttribute(sdf_rows_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM_BYTES);
  sdf_rows_kernel<false><<<n_pad / P, NTHREADS, SMEM_BYTES, stream>>>(
      pts, W, bias, beta, scale, n_pad, sdf, grad, feats, nullptr, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// Gradients w.r.t. the packed weights (dW, same layout, f32) and biases
// (db [9,272] f32). part holds sdf_grad_part_elems(n_pad) floats.
int sdf_grad_bwd(const float* pts, int n_pad, const bf16* W, const float* bias, float beta,
                 float scale, const float* d_sdf, const float* d_grad, const float* d_feats,
                 bf16* scratch, float* part, float* dW, float* db, cudaStream_t stream) {
  cudaFuncSetAttribute(sdf_rows_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM_BYTES);
  sdf_rows_kernel<true><<<n_pad / P, NTHREADS, SMEM_BYTES, stream>>>(
      pts, W, bias, beta, scale, n_pad, nullptr, nullptr, nullptr, d_sdf, d_grad, d_feats,
      scratch);
  const int M = 4 * n_pad;
  const int n_chunks = dw_chunks(M, DW_CHUNK_MIN_ROWS);
  Scratch S(scratch, (size_t)M);
  const size_t LH = (size_t)M * HID;
  // layer 0 reads the PE; layer 4 reads h3 (w4a) and the PE (w4b)
  weight_grad(S.PE, PEW, S.GZ, HID, M, PEW, HID, n_chunks, part, dW + OFF_W0, 0, stream);
  for (int l = 1; l < 8; ++l)
    weight_grad(S.H + (l - 1) * LH, HID, S.GZ + l * LH, HID, M, HID, HID, n_chunks, part,
                dW + layer_off(l), 0, stream);
  weight_grad(S.PE, PEW, S.GZ + 4 * LH, HID, M, PEW, HID, n_chunks, part, dW + OFF_W4B, 0,
              stream);
  weight_grad(S.H + 7 * LH, HID, S.GZ8, OUTW, M, HID, OUTW, n_chunks, part, dW + OFF_W8, 0,
              stream);
  // biases act on primal rows only: row % 128 < 32 in the tile-major layout
  for (int l = 0; l < 8; ++l)
    bias_grad(S.GZ + l * LH, HID, M, HID, ROWS, P, part, db + l * OUTW, 0, stream);
  bias_grad(S.GZ8, OUTW, M, OUTW, ROWS, P, part, db + 8 * OUTW, 0, stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
