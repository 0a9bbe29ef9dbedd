// Sphere-march visibility tracer of the distilled SDF field, for sm_90a.
//
// Replaces nero_tpu/ops/pallas/march_kernel.py::sphere_march_fused
// (_sphere_march_kernel + _illinois_refine, pallas_call at :338). Per ray it
// computes the same function: a fixed number of sphere-trace evaluations of
// the PE6 -> 3 x 128 ReLU -> 1 field with step clip(lip*f - margin, dt_min,
// cap), the bracket of the first crossing frozen where it is found, then
// n_refine Illinois (regula-falsi) or bisection evaluations. Outputs are the
// refined t and the `found` flag; bounding-sphere validity is the caller's.
// The kernel has no gradient.
//
// What bounds it: tensor-core operations. One evaluation is 2*(39*128 +
// 2*128*128 + 128) operations per ray and a ray takes n_sphere + n_refine of
// them, against 40 bytes per ray of device-memory traffic.
//
// Design (simple first): one block of 256 threads walks tiles of 128 rays
// on a persistent grid (one block per SM). The 76 KB of bf16 weights are
// copied into shared memory once per block and stay there. Each evaluation
// writes the tile's [128, 48] bf16 positional encoding to shared memory,
// runs the three products on the tensor cores (block_mm: WMMA bf16 operands,
// f32 accumulation, the TPU kernel's numerics) with bias + ReLU + bf16
// rounding between them, and takes the 128 -> 1 output as a per-ray dot. A
// ray's march state lives in the registers of a pair of neighbouring
// threads (each takes half of the encoding and half of the dot). Every ray
// runs every trip, so there is no divergence; the ragged last tile is
// masked, not padded.
#include "common.cuh"

namespace nero {

constexpr int SM_RAYS = 128;     // rays per tile
constexpr int SM_THREADS = 256;  // two threads per ray
constexpr int SM_W = 128;        // field width
constexpr int SM_PE = 48;        // 3 + 6*6 = 39 encoding channels, padded
constexpr int SM_NPE = 39;
constexpr int SM_OCT = 6;
constexpr int SM_LDW = SM_W + 8;  // bf16 row stride of weights and activations
constexpr int SM_LDC = SM_W + 4;  // f32 row stride of the product
constexpr int SM_WROWS = SM_PE + 2 * SM_W;            // w0, w1, w2 stacked
constexpr int SM_WELEMS = SM_WROWS * SM_W;            // packed bf16 weights
constexpr int SM_FELEMS = 4 * SM_W + 4;               // b0 b1 b2 w3 b3 (+pad)
constexpr size_t SM_SMEM = (size_t)SM_WROWS * SM_LDW * sizeof(bf16) +
                           (size_t)SM_RAYS * SM_LDW * sizeof(bf16) +
                           (size_t)SM_RAYS * SM_LDC * sizeof(float) +
                           (size_t)SM_FELEMS * sizeof(float);

// As[r, c] = bf16(relu(Cs[r, c] + bias[c])) over the whole tile.
__device__ __forceinline__ void bias_relu_store(const float* Cs, const float* bias, bf16* As) {
  for (int v = threadIdx.x; v < SM_RAYS * (SM_W / 2); v += SM_THREADS) {
    const int r = v / (SM_W / 2), c = (v % (SM_W / 2)) * 2;
    const float a = fmaxf(Cs[r * SM_LDC + c] + bias[c], 0.0f);
    const float b = fmaxf(Cs[r * SM_LDC + c + 1] + bias[c + 1], 0.0f);
    *reinterpret_cast<__nv_bfloat162*>(As + r * SM_LDW + c) = __floats2bfloat162_rn(a, b);
  }
}

// The field at one point per ray, for the whole tile at once. Thread pair
// (2*ray, 2*ray + 1) passes the same point; both get the value.
__device__ __forceinline__ float field_eval(float px, float py, float pz, const bf16* Ws,
                                            bf16* As, float* Cs, const float* Fs) {
  const int ray = threadIdx.x >> 1, half = threadIdx.x & 1;
  bf16* arow = As + ray * SM_LDW;
  // positional encoding, octave i from octave i-1 by the double-angle
  // identities; channel order of positional_encode: x, then per octave
  // sin(xyz), cos(xyz)
  float s[3] = {sinf(px), sinf(py), sinf(pz)};
  float c[3] = {cosf(px), cosf(py), cosf(pz)};
  if (half == 0) {
    arow[0] = to_bf(px);
    arow[1] = to_bf(py);
    arow[2] = to_bf(pz);
  } else {
    for (int k = SM_NPE; k < SM_PE; ++k) arow[k] = to_bf(0.0f);
  }
#pragma unroll
  for (int i = 0; i < SM_OCT; ++i) {
    bf16* dst = arow + 3 + 6 * i + 3 * half;  // the sin rows, or the cos rows
    dst[0] = to_bf(half == 0 ? s[0] : c[0]);
    dst[1] = to_bf(half == 0 ? s[1] : c[1]);
    dst[2] = to_bf(half == 0 ? s[2] : c[2]);
    if (i + 1 < SM_OCT) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float s2 = 2.0f * s[k] * c[k];
        c[k] = 1.0f - 2.0f * s[k] * s[k];
        s[k] = s2;
      }
    }
  }
  const bf16* W0 = Ws;
  const bf16* W1 = Ws + SM_PE * SM_LDW;
  const bf16* W2 = W1 + SM_W * SM_LDW;
  __syncthreads();
  block_mm<false>(As, SM_LDW, W0, SM_LDW, Cs, SM_LDC, SM_RAYS, SM_W, SM_PE, false);
  __syncthreads();
  bias_relu_store(Cs, Fs, As);
  __syncthreads();
  block_mm<false>(As, SM_LDW, W1, SM_LDW, Cs, SM_LDC, SM_RAYS, SM_W, SM_W, false);
  __syncthreads();
  bias_relu_store(Cs, Fs + SM_W, As);
  __syncthreads();
  block_mm<false>(As, SM_LDW, W2, SM_LDW, Cs, SM_LDC, SM_RAYS, SM_W, SM_W, false);
  __syncthreads();
  // 128 -> 1: bf16-rounded activations times bf16-rounded weights, f32 sum;
  // the pair splits the columns (even / odd) and adds the halves
  const float* crow = Cs + ray * SM_LDC;
  const float* b2 = Fs + 2 * SM_W;
  const float* w3 = Fs + 3 * SM_W;
  float acc = 0.0f;
#pragma unroll 8
  for (int j = 0; j < SM_W / 2; ++j) {
    const int col = 2 * j + half;
    acc += from_bf(to_bf(fmaxf(crow[col] + b2[col], 0.0f))) * w3[col];
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  // Cs is next written by the first product of the next evaluation, which
  // follows a block-wide barrier, so no barrier is needed here
  return acc + Fs[4 * SM_W];
}

struct MarchArgs {
  int n_sphere, n_refine, illinois;
  float t0_eps, margin, lip, dt_frac, cap_frac;
};

__device__ __forceinline__ float secant(float lo, float hi, float flo, float fhi) {
  const float denom = flo - fhi;
  const float mid = fabsf(denom) > 1e-12f ? (flo * hi - fhi * lo) / denom : 0.5f * (lo + hi);
  return fminf(fmaxf(mid, lo), hi);
}

__global__ void __launch_bounds__(SM_THREADS) sphere_march_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ t_enter_g, const float* __restrict__ t_exit_g, int R,
    const bf16* __restrict__ W, const float* __restrict__ F, MarchArgs a,
    float* __restrict__ t_out, unsigned char* __restrict__ found_out) {
  extern __shared__ __align__(128) unsigned char sm_smem[];
  bf16* Ws = reinterpret_cast<bf16*>(sm_smem);
  bf16* As = Ws + SM_WROWS * SM_LDW;
  float* Cs = reinterpret_cast<float*>(As + SM_RAYS * SM_LDW);
  float* Fs = Cs + SM_RAYS * SM_LDC;

  // weights and biases into shared memory, once per block
  for (int v = threadIdx.x; v < SM_WELEMS / 8; v += SM_THREADS) {
    const int r = v / (SM_W / 8), c = (v % (SM_W / 8)) * 8;
    *reinterpret_cast<uint4*>(Ws + r * SM_LDW + c) =
        *reinterpret_cast<const uint4*>(W + (size_t)r * SM_W + c);
  }
  for (int v = threadIdx.x; v < SM_FELEMS; v += SM_THREADS) {
    float x = F[v];
    if (v >= 3 * SM_W && v < 4 * SM_W) x = from_bf(to_bf(x));  // w3 as a bf16 operand
    Fs[v] = x;
  }
  __syncthreads();

  const int n_tiles = (R + SM_RAYS - 1) / SM_RAYS;
  const int evals = a.n_sphere + a.n_refine;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int ray = tile * SM_RAYS + (threadIdx.x >> 1);
    const bool live = ray < R;
    float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
    float t_enter = 0.0f, t_exit = 1e-3f;
    if (live) {
      ox = rays_o[3 * (size_t)ray];
      oy = rays_o[3 * (size_t)ray + 1];
      oz = rays_o[3 * (size_t)ray + 2];
      dx = rays_d[3 * (size_t)ray];
      dy = rays_d[3 * (size_t)ray + 1];
      dz = rays_d[3 * (size_t)ray + 2];
      t_enter = t_enter_g[ray];
      t_exit = t_exit_g[ray];
    }
    const float chord = t_exit - t_enter;
    const float dt_min = chord * a.dt_frac, cap = chord * a.cap_frac;
    // march state (names of _sphere_march_kernel's loop carry)
    float t = t_enter, t_prev = t_enter, v_prev = 0.0f;
    float t_lo = t_enter, t_hi = t_enter, f_lo = 0.0f, f_hi = 0.0f;
    bool found = false;

    for (int it = 0; it < evals; ++it) {
      float te;
      if (it == 0) te = t_enter;
      else if (it < a.n_sphere) te = t;
      else te = a.illinois ? secant(t_lo, t_hi, f_lo, f_hi) : 0.5f * (t_lo + t_hi);
      const float v = field_eval(ox + dx * te, oy + dy * te, oz + dz * te, Ws, As, Cs, Fs);
      const float step = fminf(fmaxf(a.lip * v - a.margin, dt_min), cap);
      if (it == 0) {
        found = (v <= 0.0f) && (t_enter <= a.t0_eps);  // the ray starts inside
        v_prev = f_lo = f_hi = v;
        t = fminf(t_enter + step, t_exit);
      } else if (it < a.n_sphere) {
        if (v <= 0.0f && !found) {  // first crossing: freeze the bracket
          t_lo = t_prev;
          t_hi = t;
          f_lo = v_prev;
          f_hi = v;
          found = true;
        }
        if (!found) {
          t_prev = t;
          v_prev = v;
          t = fminf(t + step, t_exit);
        }
      } else if (a.illinois) {
        // halve the retained endpoint's f whenever the other endpoint moves
        if (v > 0.0f) {
          t_lo = te;
          f_lo = v;
          f_hi *= 0.5f;
        } else {
          t_hi = te;
          f_hi = v;
          f_lo *= 0.5f;
        }
      } else {
        if (v > 0.0f) t_lo = te;
        else t_hi = te;
      }
    }
    if (live && (threadIdx.x & 1) == 0) {
      // Illinois ends with one more secant step, which costs no evaluation
      t_out[ray] = a.illinois ? secant(t_lo, t_hi, f_lo, f_hi) : 0.5f * (t_lo + t_hi);
      found_out[ray] = found ? 1 : 0;
    }
  }
}

}  // namespace nero

extern "C" {

int sphere_march_tile() { return nero::SM_RAYS; }
size_t sphere_march_weight_elems() { return nero::SM_WELEMS; }
size_t sphere_march_float_elems() { return nero::SM_FELEMS; }

// rays_o, rays_d [R,3] f32; t_enter, t_exit [R] f32; W [SM_WELEMS] bf16
// (w0 [48,128], w1, w2 [128,128], row-major [in,out]); F [SM_FELEMS] f32
// (b0, b1, b2, w3, b3); t_out [R] f32; found_out [R] bytes (0/1).
int sphere_march(const void* rays_o, const void* rays_d, const void* t_enter,
                 const void* t_exit, int R, const void* W, const void* F, int n_sphere,
                 int n_refine, int illinois, float t0_eps, float margin, float lip,
                 float dt_frac, float cap_frac, void* t_out, void* found_out, void* stream) {
  using namespace nero;
  if (R <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(sphere_march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SM_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (R + SM_RAYS - 1) / SM_RAYS;
  const int grid = n_tiles < sms ? n_tiles : sms;
  MarchArgs a{n_sphere, n_refine, illinois, t0_eps, margin, lip, dt_frac, cap_frac};
  sphere_march_kernel<<<grid, SM_THREADS, SM_SMEM, (cudaStream_t)stream>>>(
      (const float*)rays_o, (const float*)rays_d, (const float*)t_enter, (const float*)t_exit,
      R, (const bf16*)W, (const float*)F, a, (float*)t_out, (unsigned char*)found_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
