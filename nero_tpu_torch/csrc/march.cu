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
// evaluations per ray (see csrc/sphere_march.cu for one evaluation) against
// 40 bytes per ray of device-memory traffic.
//
// Design: csrc/field.cuh's warp-tile engine, as the sphere march runs on it.
//  * MR_WARPS = 12 warps a block, at most 168 registers a thread; each warp
//    walks 16-ray tiles by a static stride.
//  * Lane 4g + q holds rays g and g + 8; all four lanes of a quad carry both
//    rays' state (t_lo, t_hi, prev_v, found, and dt) bit for bit alike. The
//    rays' fixed values (origin, direction, t_enter, t_exit) wait in the
//    warp's table. The ragged last tile is masked, not padded.
//  * One loop with a single call site of field16 covers the scan and the
//    bisection. Every ray runs every trip, as the TPU kernel's fixed loop
//    does.
// The sample positions are formed as t_enter + dt * float(i) with
// separately rounded product and sum (no fused multiply-add, no running sum),
// and the bracket's low end as t_i - dt, as the plain version and the TPU
// kernel form them: a bracket on a grazing ray moves otherwise.
// kernel_variants.py (--kernel march) times the warp count; PERF.md has the
// times.
#include "field.cuh"

namespace nero {

constexpr int MR_WARPS = 12;               // warps per block
// A ray's fixed values in the warp's table Rs [MARCH_VALS][16]
enum { MV_O = 0, MV_D = 3, MV_T_ENTER = 6, MV_T_EXIT = 7, MARCH_VALS = 8 };

template <bool WIDE>
using MrBlock = FieldBlock<WIDE, MR_WARPS, MARCH_VALS>;

// One ray's scan and bisection state (the names of _march_kernel's loop
// carry); c: the ray's column of the warp's table.
struct Scan {
  const float* c;
  float dt, t_lo, t_hi, prev_v;
  bool found;

  __device__ __forceinline__ float val(int k) const { return c[k * FD_TILE]; }

  __device__ __forceinline__ void init(const float* col, int n_coarse) {
    c = col;
    dt = (val(MV_T_EXIT) - val(MV_T_ENTER)) / (float)(n_coarse - 1);
    t_lo = t_hi = val(MV_T_ENTER);
    prev_v = 0.0f;
    found = false;
  }

  // where evaluation `it` takes the field
  __device__ __forceinline__ float next_t(int it, int n_coarse) const {
    if (it == 0) return val(MV_T_ENTER);
    if (it < n_coarse) return __fadd_rn(val(MV_T_ENTER), __fmul_rn(dt, (float)it));
    return 0.5f * (t_lo + t_hi);
  }

  __device__ __forceinline__ void update(int it, float te, float v, int n_coarse,
                                         float t0_eps) {
    if (it == 0) {
      found = (v <= 0.0f) && (val(MV_T_ENTER) <= t0_eps);  // the ray starts inside
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
};

// Row `row` of the tile (ray `id`) into the warp's table: the rays past R
// get o = d = 0 and the range [0, 1e-3], and are never stored.
__device__ __forceinline__ void march_values(float* Rs, int row, int id, bool live,
                                             const float* __restrict__ rays_o,
                                             const float* __restrict__ rays_d,
                                             const float* __restrict__ t_enter_g,
                                             const float* __restrict__ t_exit_g) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    Rs[(MV_O + k) * FD_TILE + row] = live ? rays_o[3 * (size_t)id + k] : 0.0f;
    Rs[(MV_D + k) * FD_TILE + row] = live ? rays_d[3 * (size_t)id + k] : 0.0f;
  }
  Rs[MV_T_ENTER * FD_TILE + row] = live ? t_enter_g[id] : 0.0f;
  Rs[MV_T_EXIT * FD_TILE + row] = live ? t_exit_g[id] : 1e-3f;
}

template <bool WIDE, int PE>
__global__ void __launch_bounds__(MR_WARPS * 32, 1) march_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ t_enter_g, const float* __restrict__ t_exit_g, int R,
    const bf16* __restrict__ W, const float* __restrict__ F, int pe, int n_coarse,
    int n_refine, float t0_eps, float* __restrict__ t_out,
    unsigned char* __restrict__ found_out) {
  extern __shared__ __align__(128) unsigned char mr_smem[];
  const WarpField f = field_prologue<WIDE, MR_WARPS, MARCH_VALS>(mr_smem, W, F);
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int n_tiles = (R + FD_TILE - 1) / FD_TILE;
  const int evals = n_coarse + n_refine;
  for (int tile = blockIdx.x * MR_WARPS + (threadIdx.x >> 5); tile < n_tiles;
       tile += gridDim.x * MR_WARPS) {
    // lane q = 0 of each quad takes row g, q = 1 row g + 8: loads their rays,
    // then (after the march) stores their results
    const int row = g + 8 * q, id = tile * FD_TILE + row;
    __syncwarp();  // the previous tile's values are read
    if (q < 2) march_values(f.Rs, row, id, id < R, rays_o, rays_d, t_enter_g, t_exit_g);
    __syncwarp();
    Scan ray[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) ray[r].init(f.Rs + g + 8 * r, n_coarse);
    for (int it = 0; it < evals; ++it) {
      float te[2], p[2][3], v[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        te[r] = ray[r].next_t(it, n_coarse);
#pragma unroll
        for (int k = 0; k < 3; ++k) p[r][k] = ray[r].val(MV_O + k) + ray[r].val(MV_D + k) * te[r];
      }
      field16<WIDE, PE>(p, pe, f.Ws, f.Fs, f.Es, lane, v);
#pragma unroll
      for (int r = 0; r < 2; ++r) ray[r].update(it, te[r], v[r], n_coarse, t0_eps);
    }
    // selects, not a runtime index into the state array (which would put it
    // in local memory)
    const float t_hit = q == 0 ? 0.5f * (ray[0].t_lo + ray[0].t_hi)
                               : 0.5f * (ray[1].t_lo + ray[1].t_hi);
    const bool found = q == 0 ? ray[0].found : ray[1].found;
    if (q < 2 && id < R) {
      t_out[id] = t_hit;
      found_out[id] = found ? 1 : 0;
    }
  }
}

}  // namespace nero

namespace {

template <bool WIDE, int PE>
int launch_march(const void* rays_o, const void* rays_d, const void* t_enter,
                 const void* t_exit, int R, const void* W, const void* F, int pe, int n_coarse,
                 int n_refine, float t0_eps, void* t_out, void* found_out, void* stream) {
  using namespace nero;
  constexpr size_t smem = MrBlock<WIDE>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(march_kernel<WIDE, PE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = field_grid(R, MR_WARPS, &err);
  if (err != cudaSuccess) return (int)err;
  march_kernel<WIDE, PE><<<grid, MrBlock<WIDE>::THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)rays_o, (const float*)rays_d, (const float*)t_enter, (const float*)t_exit,
      R, (const bf16*)W, (const float*)F, pe, n_coarse, n_refine, t0_eps, (float*)t_out,
      (unsigned char*)found_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int march_tile() { return nero::FD_TILE; }
size_t march_weight_elems(int wide) {
  return wide ? nero::FieldDims<true>::WELEMS : nero::FieldDims<false>::WELEMS;
}
size_t march_float_elems(int wide) {
  return wide ? nero::FieldDims<true>::FELEMS : nero::FieldDims<false>::FELEMS;
}

// rays_o, rays_d [R,3] f32; t_enter, t_exit [R] f32; W, F as csrc/sphere_march.cu
// takes them (pe too); n_coarse >= 2; t_out [R] f32; found_out [R] bytes (0/1).
int march(const void* rays_o, const void* rays_d, const void* t_enter, const void* t_exit,
          int R, const void* W, const void* F, int wide, int pe, int n_coarse, int n_refine,
          float t0_eps, void* t_out, void* found_out, void* stream) {
  if (R <= 0) return 0;
  return FIELD_DISPATCH(launch_march, wide, pe, rays_o, rays_d, t_enter, t_exit, R, W, F, pe,
                        n_coarse, n_refine, t0_eps, t_out, found_out, stream);
}

}  // extern "C"
