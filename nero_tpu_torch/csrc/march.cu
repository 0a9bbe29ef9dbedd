// Uniform-march visibility tracer of the distilled SDF field, for sm_90a.
//
// Replaces nero_tpu/ops/pallas/march_kernel.py::march_fused (:407, its
// pallas_call at :190, body _march_kernel :135-176). Per ray it computes the
// same function: the field at t_enter, then at the n_coarse - 1 further
// samples t_enter + dt * i with dt = (t_exit - t_enter) / (n_coarse - 1); the
// first sample pair with field > 0 then <= 0 is the bracket (a ray that
// starts inside the surface at its origin counts as found with the bracket
// [t_enter, t_enter]); then n_refine bisections, and the result is the
// bracket's midpoint. Bounding-sphere validity is the caller's. No gradient.
//
// What bounds it: tensor-core operations, n_coarse + n_refine field
// evaluations per ray (see csrc/field.cuh for one evaluation) against 40
// bytes per ray of device-memory traffic.
//
// Design: the skeleton of csrc/sphere_march.cu. One block of 256 threads
// walks tiles of 128 rays on a persistent grid, the weights stay in shared
// memory, a ray's state lives in the registers of a thread pair, and one loop
// with a single call site of field_eval covers the scan and the bisection.
// Every ray runs every trip; the ragged last tile is masked. The sample
// positions are formed as t_enter + dt * float(i) with separately rounded
// product and sum (no fused multiply-add, no running sum), as the plain
// version and the TPU kernel form them: a bracket on a grazing ray moves
// otherwise.
#include "field.cuh"

namespace nero {

template <bool WIDE>
__global__ void __launch_bounds__(FD_THREADS) march_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ t_enter_g, const float* __restrict__ t_exit_g, int R,
    const bf16* __restrict__ W, const float* __restrict__ F, int n_coarse, int n_refine,
    float t0_eps, float* __restrict__ t_out, unsigned char* __restrict__ found_out) {
  extern __shared__ __align__(128) unsigned char mr_smem[];
  const FieldSmem s = field_carve<WIDE>(mr_smem);
  field_load<WIDE>(s, W, F);

  const int n_tiles = (R + FD_RAYS - 1) / FD_RAYS;
  const int evals = n_coarse + n_refine;
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
    const float dt = (t_exit - t_enter) / (float)(n_coarse - 1);
    float t_lo = t_enter, t_hi = t_enter, prev_v = 0.0f;
    bool found = false;

    for (int it = 0; it < evals; ++it) {
      float te;
      if (it == 0) te = t_enter;
      else if (it < n_coarse) te = __fadd_rn(t_enter, __fmul_rn(dt, (float)it));
      else te = 0.5f * (t_lo + t_hi);
      const float v = field_eval<WIDE>(ox + dx * te, oy + dy * te, oz + dz * te, s);
      if (it == 0) {
        found = (v <= 0.0f) && (t_enter <= t0_eps);  // the ray starts inside
        prev_v = v;
      } else if (it < n_coarse) {
        if (prev_v > 0.0f && v <= 0.0f && !found) {  // first + -> - change
          t_lo = __fsub_rn(te, dt);
          t_hi = te;
          found = true;
        }
        prev_v = v;
      } else {
        if (v > 0.0f) t_lo = te;
        else t_hi = te;
      }
    }
    if (live && (threadIdx.x & 1) == 0) {
      t_out[ray] = 0.5f * (t_lo + t_hi);
      found_out[ray] = found ? 1 : 0;
    }
  }
}

}  // namespace nero

namespace {

template <bool WIDE>
int launch_march(const void* rays_o, const void* rays_d, const void* t_enter,
                 const void* t_exit, int R, const void* W, const void* F, int n_coarse,
                 int n_refine, float t0_eps, void* t_out, void* found_out, void* stream) {
  using namespace nero;
  cudaError_t err = cudaFuncSetAttribute(march_kernel<WIDE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)FieldDims<WIDE>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int grid = field_grid((R + FD_RAYS - 1) / FD_RAYS, &err);
  if (err != cudaSuccess) return (int)err;
  march_kernel<WIDE><<<grid, FD_THREADS, FieldDims<WIDE>::SMEM, (cudaStream_t)stream>>>(
      (const float*)rays_o, (const float*)rays_d, (const float*)t_enter, (const float*)t_exit,
      R, (const bf16*)W, (const float*)F, n_coarse, n_refine, t0_eps, (float*)t_out,
      (unsigned char*)found_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int march_tile() { return nero::FD_RAYS; }
size_t march_weight_elems(int wide) {
  return wide ? nero::FieldDims<true>::WELEMS : nero::FieldDims<false>::WELEMS;
}
size_t march_float_elems(int wide) {
  return wide ? nero::FieldDims<true>::FELEMS : nero::FieldDims<false>::FELEMS;
}

// rays_o, rays_d [R,3] f32; t_enter, t_exit [R] f32; W, F as csrc/sphere_march.cu
// takes them; n_coarse >= 2; t_out [R] f32; found_out [R] bytes (0/1).
int march(const void* rays_o, const void* rays_d, const void* t_enter, const void* t_exit,
          int R, const void* W, const void* F, int wide, int n_coarse, int n_refine,
          float t0_eps, void* t_out, void* found_out, void* stream) {
  if (R <= 0) return 0;
  return wide ? launch_march<true>(rays_o, rays_d, t_enter, t_exit, R, W, F, n_coarse,
                                   n_refine, t0_eps, t_out, found_out, stream)
              : launch_march<false>(rays_o, rays_d, t_enter, t_exit, R, W, F, n_coarse,
                                    n_refine, t0_eps, t_out, found_out, stream);
}

}  // extern "C"
