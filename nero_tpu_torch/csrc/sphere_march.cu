// Sphere-march visibility tracer of the distilled SDF field, for sm_90a.
//
// Replaces nero_tpu/ops/pallas/march_kernel.py::sphere_march_fused
// (_sphere_march_kernel + _illinois_refine, pallas_call at :338). Per ray it
// computes the same function: a fixed number of sphere-trace evaluations of
// the distilled field (csrc/field.cuh, `std` or `wide` topology) with step
// clip(lip*f - margin, dt_min, cap), the bracket of the first crossing
// frozen where it is found, then n_refine Illinois (regula-falsi) or bisection evaluations. Outputs are the
// refined t and the `found` flag; bounding-sphere validity is the caller's.
// The kernel has no gradient.
//
// What bounds it: tensor-core operations. One evaluation is 2*(39*128 +
// 2*128*128 + 128) operations per ray (`wide`: 2*(123*128 + 128*128 + 128))
// and a ray takes n_sphere + n_refine of them, against 40 bytes per ray of
// device-memory traffic.
//
// Design (simple first): one block of 256 threads walks tiles of 128 rays
// on a persistent grid (one block per SM). The bf16 weights (76 KB `std`,
// 64 KB `wide`) are copied into shared memory once per block and stay there.
// Each evaluation is one call of field.cuh's field_eval: the tile's bf16
// encoding to shared memory, the products on the tensor cores (block_mm: WMMA
// bf16 operands, f32 accumulation, the TPU kernel's numerics) with bias +
// ReLU + bf16 rounding between them, and the 128 -> 1 output as a per-ray dot. A
// ray's march state lives in the registers of a pair of neighbouring
// threads (each takes half of the encoding and half of the dot). Every ray
// runs every trip, so there is no divergence; the ragged last tile is
// masked, not padded.
#include "field.cuh"

namespace nero {

struct MarchArgs {
  int n_sphere, n_refine, illinois;
  float t0_eps, margin, lip, dt_frac, cap_frac;
};

__device__ __forceinline__ float secant(float lo, float hi, float flo, float fhi) {
  const float denom = flo - fhi;
  const float mid = fabsf(denom) > 1e-12f ? (flo * hi - fhi * lo) / denom : 0.5f * (lo + hi);
  return fminf(fmaxf(mid, lo), hi);
}

template <bool WIDE>
__global__ void __launch_bounds__(FD_THREADS) sphere_march_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ t_enter_g, const float* __restrict__ t_exit_g, int R,
    const bf16* __restrict__ W, const float* __restrict__ F, MarchArgs a,
    float* __restrict__ t_out, unsigned char* __restrict__ found_out) {
  extern __shared__ __align__(128) unsigned char sm_smem[];
  const FieldSmem s = field_carve<WIDE>(sm_smem);
  field_load<WIDE>(s, W, F);

  const int n_tiles = (R + FD_RAYS - 1) / FD_RAYS;
  const int evals = a.n_sphere + a.n_refine;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int ray = tile * FD_RAYS + (threadIdx.x >> 1);
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
      const float v = field_eval<WIDE>(ox + dx * te, oy + dy * te, oz + dz * te, s);
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

namespace {

template <bool WIDE>
int launch_sphere_march(const void* rays_o, const void* rays_d, const void* t_enter,
                        const void* t_exit, int R, const void* W, const void* F,
                        nero::MarchArgs a, void* t_out, void* found_out, void* stream) {
  using namespace nero;
  cudaError_t err = cudaFuncSetAttribute(sphere_march_kernel<WIDE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)FieldDims<WIDE>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int grid = field_grid((R + FD_RAYS - 1) / FD_RAYS, &err);
  if (err != cudaSuccess) return (int)err;
  sphere_march_kernel<WIDE><<<grid, FD_THREADS, FieldDims<WIDE>::SMEM, (cudaStream_t)stream>>>(
      (const float*)rays_o, (const float*)rays_d, (const float*)t_enter, (const float*)t_exit,
      R, (const bf16*)W, (const float*)F, a, (float*)t_out, (unsigned char*)found_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sphere_march_tile() { return nero::FD_RAYS; }
size_t sphere_march_weight_elems(int wide) {
  return wide ? nero::FieldDims<true>::WELEMS : nero::FieldDims<false>::WELEMS;
}
size_t sphere_march_float_elems(int wide) {
  return wide ? nero::FieldDims<true>::FELEMS : nero::FieldDims<false>::FELEMS;
}

// rays_o, rays_d [R,3] f32; t_enter, t_exit [R] f32; W bf16, the 128-column
// weights stacked row-major [in,out] (std: w0 [48,128], w1, w2 [128,128];
// wide: w0 [128,128], w1 [128,128]); F f32 (the biases of those layers, the
// output weights, the output bias); t_out [R] f32; found_out [R] bytes (0/1).
int sphere_march(const void* rays_o, const void* rays_d, const void* t_enter,
                 const void* t_exit, int R, const void* W, const void* F, int wide,
                 int n_sphere, int n_refine, int illinois, float t0_eps, float margin,
                 float lip, float dt_frac, float cap_frac, void* t_out, void* found_out,
                 void* stream) {
  if (R <= 0) return 0;
  nero::MarchArgs a{n_sphere, n_refine, illinois, t0_eps, margin, lip, dt_frac, cap_frac};
  return wide ? launch_sphere_march<true>(rays_o, rays_d, t_enter, t_exit, R, W, F, a, t_out,
                                          found_out, stream)
              : launch_sphere_march<false>(rays_o, rays_d, t_enter, t_exit, R, W, F, a, t_out,
                                           found_out, stream);
}

}  // extern "C"
