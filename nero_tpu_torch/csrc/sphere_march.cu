// Sphere-march visibility tracer of the distilled SDF field, for sm_90a.
//
// Replaces nero_tpu/ops/pallas/march_kernel.py::sphere_march_fused
// (_sphere_march_kernel + _illinois_refine, pallas_call at :338). Per ray it
// computes the same function: a fixed number of sphere-trace evaluations of
// the distilled field (`std` or `wide` topology, csrc/field.cuh's layout)
// with step clip(lip*f - margin, dt_min, cap), the bracket of the first
// crossing frozen where it is found, then n_refine Illinois (regula-falsi)
// or bisection evaluations. Outputs are the refined t and the `found` flag;
// bounding-sphere validity is the caller's. The kernel has no gradient.
//
// What bounds it: tensor-core operations. One evaluation is 2*((3+6pe)*128 +
// 2*128*128 + 128) operations per ray (`wide`: 2*(123*128 + 128*128 + 128))
// and a ray takes n_sphere + n_refine of them, against 40 bytes per ray of
// device-memory traffic.
//
// Design: csrc/field.cuh's warp-tile engine (its header comment gives the
// layout, the encoding, the products and the output).
//  * SM_WARPS = 12 warps a block, at most 168 registers a thread.
//  * Each lane of a quad carries the march state of both of its rows and
//    computes it bit for bit alike, since field16 gives them the same field
//    values. The rays' fixed values (origin, direction, t range, clip
//    bounds) wait in the warp's table. The ragged last tile is masked, not
//    padded.
// kernel_variants.py (--kernel sphere_march) times each choice undone;
// PERF.md has the times.
#include "field.cuh"

namespace nero {

constexpr int SM_WARPS = 12;               // warps per block
// A ray's fixed values sit in the warp's table Rs [RAY_VALS][16] in shared
// memory (column: the ray's row in the tile), which saves the registers of
// both rays' 20: origin, direction, t range and the step's clip bounds.
enum { RV_O = 0, RV_D = 3, RV_T_ENTER = 6, RV_T_EXIT = 7, RV_DT_MIN = 8, RV_CAP = 9, RAY_VALS = 10 };

template <bool WIDE>
using SmBlock = FieldBlock<WIDE, SM_WARPS, RAY_VALS>;

struct MarchArgs {
  int pe, n_sphere, n_refine, illinois;
  float t0_eps, margin, lip, dt_frac, cap_frac;
};

__device__ __forceinline__ float secant(float lo, float hi, float flo, float fhi) {
  const float denom = flo - fhi;
  const float mid = fabsf(denom) > 1e-12f ? (flo * hi - fhi * lo) / denom : 0.5f * (lo + hi);
  return fminf(fmaxf(mid, lo), hi);
}

// One ray's march state (the names of _sphere_march_kernel's loop carry);
// c: the ray's column of the warp's table.
struct Ray {
  const float* c;
  float t, t_prev, v_prev, t_lo, t_hi, f_lo, f_hi;
  bool found;

  __device__ __forceinline__ float val(int k) const { return c[k * FD_TILE]; }

  __device__ __forceinline__ void init(const float* col) {
    c = col;
    t = t_prev = t_lo = t_hi = val(RV_T_ENTER);
    v_prev = f_lo = f_hi = 0.0f;
    found = false;
  }

  // where evaluation `it` takes the field
  __device__ __forceinline__ float next_t(int it, const MarchArgs& a) const {
    if (it == 0) return val(RV_T_ENTER);
    if (it < a.n_sphere) return t;
    return a.illinois ? secant(t_lo, t_hi, f_lo, f_hi) : 0.5f * (t_lo + t_hi);
  }

  __device__ __forceinline__ void update(int it, float te, float v, const MarchArgs& a) {
    const float step = fminf(fmaxf(a.lip * v - a.margin, val(RV_DT_MIN)), val(RV_CAP));
    if (it == 0) {
      found = (v <= 0.0f) && (val(RV_T_ENTER) <= a.t0_eps);  // the ray starts inside
      v_prev = f_lo = f_hi = v;
      t = fminf(val(RV_T_ENTER) + step, val(RV_T_EXIT));
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
        t = fminf(t + step, val(RV_T_EXIT));
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

  // Illinois ends with one more secant step, which costs no evaluation
  __device__ __forceinline__ float result(const MarchArgs& a) const {
    return a.illinois ? secant(t_lo, t_hi, f_lo, f_hi) : 0.5f * (t_lo + t_hi);
  }
};

// Row `row` of the tile (ray `id`) into the warp's table: the rays past R
// get o = d = 0 and the range [0, 1e-3], and are never stored.
__device__ __forceinline__ void ray_values(float* Rs, int row, int id, bool live,
                                           const float* __restrict__ rays_o,
                                           const float* __restrict__ rays_d,
                                           const float* __restrict__ t_enter_g,
                                           const float* __restrict__ t_exit_g,
                                           const MarchArgs& a) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    Rs[(RV_O + k) * FD_TILE + row] = live ? rays_o[3 * (size_t)id + k] : 0.0f;
    Rs[(RV_D + k) * FD_TILE + row] = live ? rays_d[3 * (size_t)id + k] : 0.0f;
  }
  const float t_enter = live ? t_enter_g[id] : 0.0f;
  const float t_exit = live ? t_exit_g[id] : 1e-3f;
  const float chord = t_exit - t_enter;
  Rs[RV_T_ENTER * FD_TILE + row] = t_enter;
  Rs[RV_T_EXIT * FD_TILE + row] = t_exit;
  Rs[RV_DT_MIN * FD_TILE + row] = chord * a.dt_frac;
  Rs[RV_CAP * FD_TILE + row] = chord * a.cap_frac;
}

template <bool WIDE, int PE>
__global__ void __launch_bounds__(SM_WARPS * 32, 1) sphere_march_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ t_enter_g, const float* __restrict__ t_exit_g, int R,
    const bf16* __restrict__ W, const float* __restrict__ F, MarchArgs a,
    float* __restrict__ t_out, unsigned char* __restrict__ found_out) {
  extern __shared__ __align__(128) unsigned char sm_smem[];
  const WarpField f = field_prologue<WIDE, SM_WARPS, RAY_VALS>(sm_smem, W, F);
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int n_tiles = (R + FD_TILE - 1) / FD_TILE;
  const int evals = a.n_sphere + a.n_refine;
  for (int tile = blockIdx.x * SM_WARPS + (threadIdx.x >> 5); tile < n_tiles;
       tile += gridDim.x * SM_WARPS) {
    // lane q = 0 of each quad takes row g, q = 1 row g + 8: loads their rays,
    // then (after the march) stores their results
    const int row = g + 8 * q, id = tile * FD_TILE + row;
    __syncwarp();  // the previous tile's values are read
    if (q < 2) ray_values(f.Rs, row, id, id < R, rays_o, rays_d, t_enter_g, t_exit_g, a);
    __syncwarp();
    Ray ray[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) ray[r].init(f.Rs + g + 8 * r);
    for (int it = 0; it < evals; ++it) {
      float te[2], p[2][3], v[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        te[r] = ray[r].next_t(it, a);
#pragma unroll
        for (int k = 0; k < 3; ++k) p[r][k] = ray[r].val(RV_O + k) + ray[r].val(RV_D + k) * te[r];
      }
      field16<WIDE, PE>(p, a.pe, f.Ws, f.Fs, f.Es, lane, v);
#pragma unroll
      for (int r = 0; r < 2; ++r) ray[r].update(it, te[r], v[r], a);
    }
    // selects, not a runtime index into the state array (which would put it
    // in local memory)
    const float t_hit = q == 0 ? ray[0].result(a) : ray[1].result(a);
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
int launch_sphere_march(const void* rays_o, const void* rays_d, const void* t_enter,
                        const void* t_exit, int R, const void* W, const void* F,
                        nero::MarchArgs a, void* t_out, void* found_out, void* stream) {
  using namespace nero;
  constexpr size_t smem = SmBlock<WIDE>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(sphere_march_kernel<WIDE, PE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = field_grid(R, SM_WARPS, &err);
  if (err != cudaSuccess) return (int)err;
  sphere_march_kernel<WIDE, PE><<<grid, SmBlock<WIDE>::THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)rays_o, (const float*)rays_d, (const float*)t_enter, (const float*)t_exit,
      R, (const bf16*)W, (const float*)F, a, (float*)t_out, (unsigned char*)found_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sphere_march_tile() { return nero::FD_TILE; }
size_t sphere_march_weight_elems(int wide) {
  return wide ? nero::FieldDims<true>::WELEMS : nero::FieldDims<false>::WELEMS;
}
size_t sphere_march_float_elems(int wide) {
  return wide ? nero::FieldDims<true>::FELEMS : nero::FieldDims<false>::FELEMS;
}

// rays_o, rays_d [R,3] f32; t_enter, t_exit [R] f32; W bf16, the 128-column
// weights stacked row-major [in,out] (std: w0 [48,128], w1, w2 [128,128];
// wide: w0 [128,128], w1 [128,128]); F f32 (the biases of those layers, the
// output weights, the output bias); pe: the `std` field's PE octaves, 0-7
// (wide: ignored); t_out [R] f32; found_out [R] bytes (0/1).
int sphere_march(const void* rays_o, const void* rays_d, const void* t_enter,
                 const void* t_exit, int R, const void* W, const void* F, int wide, int pe,
                 int n_sphere, int n_refine, int illinois, float t0_eps, float margin,
                 float lip, float dt_frac, float cap_frac, void* t_out, void* found_out,
                 void* stream) {
  if (R <= 0) return 0;
  nero::MarchArgs a{pe, n_sphere, n_refine, illinois, t0_eps, margin, lip, dt_frac, cap_frac};
  return FIELD_DISPATCH(launch_sphere_march, wide, pe, rays_o, rays_d, t_enter, t_exit, R, W, F,
                        a, t_out, found_out, stream);
}

}  // extern "C"
