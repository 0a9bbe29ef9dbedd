// SDF value without gradient, for Hopper (sm_90a).
//
// Replaces nero_tpu/ops/pallas/sdf_kernel.py::sdf_fwd_fused (:148, pallas_call
// nero_sdf_fwd :122, body :91-109): the points scaled by cfg.scale,
// PE(multires) (6 shipped; sdf_net.cuh builds any multires 1-20),
// the nine weight-norm layers with softplus(100 x)/100 between them, the skip
// layer as two products on [h3, PE] (both weight halves pre-scaled by
// 1/sqrt(2), so the scale lands before the bias), and of the last layer the
// sdf column alone. It serves the no-gradient callers of Stage I: the
// proposal sampler, the occlusion march and the validation march.
//
// It runs on the SDF-with-gradient kernel's forward engine (sdf_net.cuh)
// with one row kind: a block of 16 warps, warp w on 16 MT points (MT
// m16n8k16 row tiles) and 64 columns of a layer, so a tile is 64 MT points.
// The PE goes into shared memory, padded (39 channels to 48 at multires 6), zero past
// n (rows past n are never read and never written); the weights stream
// through the engine's 2-stage cp.async ring on a slab table of this
// kernel's own (w0, w1-w4a, w4b, w5-w7, then of w8 the sdf column's n8-tile
// alone: 4 KB of w8's 139 KB); each layer's bias and softplus run in
// registers on the accumulators and go once, bf16, into the activation tile.
// Layer 8 is the sdf n8-tile on the warps of columns 0-63, and its column 0
// plus the bias goes straight from the accumulators to `out`. The arithmetic
// is B1's primal rows' (the same PE code, k from 0 up in steps of 16, w4a
// before w4b into the same sums, the bias after the product, div_beta), so
// the sdf equals sdf_grad.cu's to the bit, at either tile size.
//
// The tile per launch: 64 points (MT = 1) when the launch is one wave of
// them, n <= 64 x the card's SM count (8,448 points on an H100: the
// sampler's 8,192-point up-sample passes run 128 tiles of 64 points on 132
// SMs, not 64 tiles of 128), else 128 (MT = 2). A 64-point block streams the
// same weights for half the points and takes about 0.7 of a 128-point
// block's time (kernel_variants.py --kernel sdf_fwd), so it pays only where
// it saves a wave: from 64 x SMs points on, 128 points a tile needs no more
// waves than 64 would.
//
// The scene axis (sdf_fwd_scenes): nero_tpu's multi-scene step vmaps the
// sampler and the marches over S scenes' stacked weights, so the pallas_call
// runs once for all scenes. Here one launch takes S scenes of n points:
// blockIdx.y is the scene, its points rows s n .. (s + 1) n - 1 of pts and
// out, its weights and biases the s-th set (as sdf_grad.cu's). The tile
// follows the rule above at the launch's S n points: the sdf is the same at
// either tile size, so each scene's values are its one-scene launch's to the
// bit. The one-scene entry `sdf_fwd` is S = 1.
//
// Bound: tensor-core operations, 2 * 459,008 per point (ops/sdf_fwd.py::
// flops) against 16 bytes per point. What keeps it from the bound: the
// softplus (expf and log1pf) of every element of every hidden layer, which
// B1 forms on one row in four and B6 on every row, runs between the
// products, not beside them; every block streams all 0.97 MB of the hidden
// layers' weights from L2 through the 2-stage ring, a block barrier a slab
// (with the PE, the stream alone takes 0.41 of the launch's 0.97 ms at
// 131,072 points: kernel_variants.py's `weights_only`); mma.sync, not the
// warpgroup products.
#include "sdf_net.cuh"

using namespace nero;
using namespace nero::sdfnet;

namespace {

template <int MT>
struct Tile {
  static constexpr int P = 4 * 16 * MT;  // points: 4 row groups of MT m16 tiles
  static constexpr size_t SMEM =
      ((size_t)P * LDH + (size_t)P * LDP + (size_t)STAGES * STAGE_ELEMS) * 2;
};
static_assert(Tile<2>::SMEM <= 232448, "shared memory");

// pts [n,3] f32; W packed bf16 (sdf_net.cuh); bias [9,272] f32 -> out [n] f32.
// blockIdx.y is the scene: n points a scene, its rows after the rows of the
// scenes before it, its weights and biases the y-th set (one scene: y = 0).
template <int MT>
__global__ void __launch_bounds__(F_THREADS, 1)
sdf_fwd_kernel(const float* __restrict__ pts, int n, const bf16* __restrict__ W,
               const float* __restrict__ bias, float beta, float scale,
               float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  pts += blockIdx.y * (size_t)n * 3;
  out += blockIdx.y * (size_t)n;
  W += blockIdx.y * (size_t)W_TOTAL;
  bias += blockIdx.y * 9 * OUTW;
  constexpr int P = Tile<MT>::P;
  bf16* H = reinterpret_cast<bf16*>(smem);  // activations [P][LDH]
  bf16* PEb = H + P * LDH;                  // PE [P][LDP]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = warp / NQ, cq = warp % NQ;  // row group, column group
  const int g = lane >> 2, t = lane & 3;      // accumulator row and column pair
  const int p0 = blockIdx.x * P;

  Ring<VALUE_STREAM> ring{PEb + P * LDP, W, 0};
  for (int s = 0; s < STAGES - 1; ++s) ring.load(s);
  pe_tile<1, MT>(PEb, pts, p0, n, scale, nullptr);
  hidden_layers<1, MT>(H, PEb, ring, bias, beta, nullptr, 0);

  // layer 8: the sdf column's n8-tile, k in steps of 16 from 0 up
  const unsigned h_x = smem_u32(H + (grp * 16 * MT + (lane & 15)) * LDH + (lane >> 4) * 8);
  float acc[MT][4] = {};
  for (int k0 = 0; k0 < HID; k0 += SLAB_K) {
    const unsigned b = ring.next() + ((lane & 15) * LDB + (lane >> 4) * 8) * 2;
    if (cq != 0) continue;  // the other warps keep the ring's pace
#pragma unroll
    for (int kk = 0; kk < SLAB_K / 16; ++kk) {
      unsigned bb[2];
      ldsm_x2_t(bb, b + kk * 16 * LDB * 2);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        unsigned a[4];
        ldsm_x4(a, h_x + (16 * m * LDH + k0 + kk * 16) * 2);
        mma_bf16(acc[m], a, bb[0], bb[1]);
      }
    }
  }
  if (cq == 0 && t == 0) {  // column 0: c0 (row g) and c2 (row g + 8) of each row tile
    const float b8 = bias[8 * OUTW];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = p0 + grp * 16 * MT + 16 * m + 8 * hf + g;
        if (r < n) out[r] = acc[m][2 * hf] + b8;
      }
  }
}

template <int MT>
int launch(const float* pts, int n, int n_scenes, const bf16* W, const float* bias, float beta,
           float scale, float* out, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      sdf_fwd_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile<MT>::SMEM);
  if (err != cudaSuccess) return (int)err;
  constexpr int P = Tile<MT>::P;
  sdf_fwd_kernel<MT><<<dim3((n + P - 1) / P, n_scenes), F_THREADS, Tile<MT>::SMEM, stream>>>(
      pts, n, W, bias, beta, scale, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t sdf_fwd_weight_elems() { return W_TOTAL; }

// Points a tile at n points on a card of `sms` SMs: 64 when the launch is
// one wave of 64-point tiles, else 128.
int sdf_fwd_tile(int n, int sms) { return (n + 63) / 64 <= sms ? 64 : 128; }

// S scenes of n points in one launch: pts [S, n, 3] f32; W [S, W_TOTAL] packed
// bf16 (sdf_net.cuh); bias [S, 9, 272] f32; out [S, n] f32. The tile by the
// rule at S n points.
int sdf_fwd_scenes(const float* pts, int n, int n_scenes, const bf16* W, const float* bias,
                   float beta, float scale, float* out, cudaStream_t stream) {
  if (n <= 0 || n_scenes <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (sdf_fwd_tile(n * n_scenes, sms) == 64)
    return launch<1>(pts, n, n_scenes, W, bias, beta, scale, out, stream);
  return launch<2>(pts, n, n_scenes, W, bias, beta, scale, out, stream);
}

// pts [n,3] f32; W packed bf16 (sdf_net.cuh); bias [9,272] f32; out [n] f32.
int sdf_fwd(const float* pts, int n, const bf16* W, const float* bias, float beta, float scale,
            float* out, cudaStream_t stream) {
  return sdf_fwd_scenes(pts, n, 1, W, bias, beta, scale, out, stream);
}

}  // extern "C"
