// SDF value without gradient, for Hopper (sm_90a).
//
// Replaces nero_tpu/ops/pallas/sdf_kernel.py::sdf_fwd_fused (:148, pallas_call
// nero_sdf_fwd :122, body :91-109): the points scaled by cfg.scale, PE(6),
// the nine weight-norm layers with softplus(100 x)/100 between them, the skip
// layer as two products on [h3, PE] (both weight halves pre-scaled by
// 1/sqrt(2), so the scale lands before the bias), and of the last layer the
// sdf column alone. It serves the no-gradient callers of Stage I: the
// proposal sampler, the occlusion march and the validation march.
//
// One block per tile of P = 128 points: PE into shared memory, each layer a
// block_mm on bf16 operands with f32 sums (the same network, layout and
// rounding as sdf_grad.cu's primal rows, whose packed weights it reads; see
// sdf_net.cuh), the last layer on one 16-column tile. Nothing but the points
// comes in and nothing but one float per point goes out. The TPU layout's
// padding (39 -> 128 lanes, 217 -> 256) is not copied: the PE is padded to
// the 48 of the MMA tile and layer 3's 39 spare columns are masked to zero.
// Rows past n are masked: read as zero, never written.
//
// Bound: tensor-core operations, 2 * 459,008 per point (ops/sdf_fwd.py::
// flops) against 16 bytes per point. This first version streams the weights
// from L2 for every tile and round-trips each layer through shared memory
// in f32.
#include "sdf_net.cuh"

using namespace nero;
using namespace nero::sdfnet;

namespace {

constexpr int P = 128;  // points per tile
constexpr int NTHREADS = 512;
constexpr int LDA = HID + 8, LDP = PEW + 8, LDC = HID + 4;
constexpr size_t SMEM_BYTES = (size_t)P * LDA * 2 + (size_t)P * LDP * 2 + (size_t)P * LDC * 4;

__global__ void __launch_bounds__(NTHREADS, 1)
sdf_fwd_kernel(const float* __restrict__ pts, int n, const bf16* __restrict__ W,
               const float* __restrict__ bias, float beta, float scale,
               float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* A = reinterpret_cast<bf16*>(smem);
  bf16* PEb = A + P * LDA;
  float* C = reinterpret_cast<float*>(PEb + P * LDP);
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * P;

  for (int idx = tid; idx < P * PEW; idx += NTHREADS) {
    const int r = idx / PEW, c = idx % PEW;
    float v = 0.0f;
    if (p0 + r < n && c < NPE) {
      const float* p = pts + (size_t)(p0 + r) * 3;
      if (c < 3) {
        v = p[c] * scale;
      } else {
        const int i = (c - 3) / 6, q = (c - 3) % 6;
        const float x = p[q % 3] * scale * (float)(1 << i);
        v = q >= 3 ? cosf(x) : sinf(x);
      }
    }
    PEb[r * LDP + c] = to_bf(v);
  }
  __syncthreads();

  for (int l = 0; l < 8; ++l) {
    if (l == 0) {
      block_mm<false>(PEb, LDP, W + OFF_W0, HID, C, LDC, P, HID, PEW, false);
    } else if (l == 4) {
      block_mm<false>(A, LDA, W + OFF_W4A, HID, C, LDC, P, HID, HID, false);
      __syncthreads();
      block_mm<false>(PEb, LDP, W + OFF_W4B, HID, C, LDC, P, HID, PEW, true);
    } else {
      block_mm<false>(A, LDA, W + layer_off(l), HID, C, LDC, P, HID, HID, false);
    }
    __syncthreads();
    for (int idx = tid; idx < P * HID; idx += NTHREADS) {
      const int r = idx / HID, c = idx % HID;
      const float z = C[r * LDC + c] + bias[l * OUTW + c];
      const bool masked = (l == 3 && c >= MASK_W);
      A[r * LDA + c] = to_bf(masked ? 0.0f : softplus_b(z, beta));
    }
    __syncthreads();
  }
  // the sdf is column 0 of layer 8: one 16-column tile of w8 [256, 272]
  block_mm<false>(A, LDA, W + OFF_W8, OUTW, C, LDC, P, 16, HID, false);
  __syncthreads();
  for (int r = tid; r < P; r += NTHREADS)
    if (p0 + r < n) out[p0 + r] = C[r * LDC] + bias[8 * OUTW];
}

}  // namespace

extern "C" {

size_t sdf_fwd_weight_elems() { return W_TOTAL; }

// pts [n,3] f32; W packed bf16 (sdf_net.cuh); bias [9,272] f32; out [n] f32.
int sdf_fwd(const float* pts, int n, const bf16* W, const float* bias, float beta, float scale,
            float* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(sdf_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  sdf_fwd_kernel<<<(n + P - 1) / P, NTHREADS, SMEM_BYTES, stream>>>(pts, n, W, bias, beta,
                                                                     scale, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
