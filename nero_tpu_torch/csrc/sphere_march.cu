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
// What bounds it: tensor-core operations. One evaluation is 2*(39*128 +
// 2*128*128 + 128) operations per ray (`wide`: 2*(123*128 + 128*128 + 128))
// and a ray takes n_sphere + n_refine of them, against 40 bytes per ray of
// device-memory traffic.
//
// Design: warp-private tiles of 16 rays on mma.sync, with no block-wide
// barrier after the weights are loaded.
//  * A persistent grid of one block per SM, SM_WARPS = 12 warps each (at
//    most 168 registers a thread). The bf16 weights (76 KB `std`, 64 KB
//    `wide`, rows padded to FD_LDW = 136 elements against bank conflicts)
//    and the f32 biases are copied into shared memory once per block; that
//    copy ends with the only __syncthreads of the kernel.
//  * Each warp walks 16-ray tiles by a static stride. Lane 4g + q holds rays
//    g and g + 8 of its tile: the rows of an m16n8k16 fragment. All four
//    lanes of a quad carry the march state of both rays and compute it bit
//    for bit alike (they get the same field values, see below), so the march
//    needs no exchange. The rays' fixed values (origin, direction, t range,
//    clip bounds) wait in a warp-private table in shared memory, which makes
//    room in 168 registers. The ragged last tile is masked, not padded.
//  * The quad of a row pair splits the encoding (`std`: each lane at most two
//    of the six (row, coordinate) pairs; `wide`: one of the four chains
//    each), runs the double-angle recurrence of its own values and writes
//    them to the warp's staging tile [16][136] bf16, from which ldmatrix
//    loads the first layer's A fragments.
//  * Products on mma.sync (bf16 operands, f32 sums: the TPU kernel's
//    numerics), W's B fragments by ldmatrix.trans from the [in][out] rows.
//    The accumulators of n8-tiles 2k and 2k + 1 are the next layer's A
//    fragment for k-tile k, so bias + ReLU + bf16 rounding run in registers.
//  * The 128 -> 1 output on the tensor cores too: w_out is column 0 of an
//    n8-tile kept in the padding columns of the last layer's weight rows;
//    lane 4g's sums go to the whole quad by a shuffle, so all four lanes hold
//    the same bits.
// What holds it back now: the rate of mma.sync, and every warp's read of all
// the weights as B fragments per evaluation of 16 rays. kernel_variants.py
// (--kernel sphere_march) times each choice above undone; PERF.md has the
// times.
#include "field.cuh"
#include "mma.cuh"

namespace nero {

constexpr int SM_WARPS = 12;               // warps per block
constexpr int SM_THREADS = SM_WARPS * 32;
constexpr int SM_RAYS = 16;                // rays per warp tile
constexpr unsigned FULL = 0xffffffffu;
// A ray's fixed values sit in the warp's table Rs [RAY_VALS][16] in shared
// memory (column: the ray's row in the tile), which saves the registers of
// both rays' 20: origin, direction, t range and the step's clip bounds.
enum { RV_O = 0, RV_D = 3, RV_T_ENTER = 6, RV_T_EXIT = 7, RV_DT_MIN = 8, RV_CAP = 9, RAY_VALS = 10 };

template <bool WIDE>
struct MarchDims {
  using D = FieldDims<WIDE>;
  static constexpr int KT0 = D::PE / 16;  // k-tiles of the first layer
  // weights, floats, and each warp's staging tile of the encoding and table
  // of its rays' fixed values
  static constexpr size_t SMEM = (size_t)D::WROWS * FD_LDW * sizeof(bf16) +
                                 (size_t)D::FELEMS * sizeof(float) +
                                 (size_t)SM_WARPS * SM_RAYS * FD_LDW * sizeof(bf16) +
                                 (size_t)SM_WARPS * RAY_VALS * SM_RAYS * sizeof(float);
};

struct MarchArgs {
  int n_sphere, n_refine, illinois;
  float t0_eps, margin, lip, dt_frac, cap_frac;
};

__device__ __forceinline__ float secant(float lo, float hi, float flo, float fhi) {
  const float denom = flo - fhi;
  const float mid = fabsf(denom) > 1e-12f ? (flo * hi - fhi * lo) / denom : 0.5f * (lo + hi);
  return fminf(fmaxf(mid, lo), hi);
}

__device__ __forceinline__ unsigned pack_bf2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// One ray's march state (the names of _sphere_march_kernel's loop carry);
// c: the ray's column of the warp's table.
struct Ray {
  const float* c;
  float t, t_prev, v_prev, t_lo, t_hi, f_lo, f_hi;
  bool found;

  __device__ __forceinline__ float val(int k) const { return c[k * SM_RAYS]; }

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
    Rs[(RV_O + k) * SM_RAYS + row] = live ? rays_o[3 * (size_t)id + k] : 0.0f;
    Rs[(RV_D + k) * SM_RAYS + row] = live ? rays_d[3 * (size_t)id + k] : 0.0f;
  }
  const float t_enter = live ? t_enter_g[id] : 0.0f;
  const float t_exit = live ? t_exit_g[id] : 1e-3f;
  const float chord = t_exit - t_enter;
  Rs[RV_T_ENTER * SM_RAYS + row] = t_enter;
  Rs[RV_T_EXIT * SM_RAYS + row] = t_exit;
  Rs[RV_DT_MIN * SM_RAYS + row] = chord * a.dt_frac;
  Rs[RV_CAP * SM_RAYS + row] = chord * a.cap_frac;
}

// The encoding of the tile's 16 points into the warp's staging tile Es
// [16][FD_LDW] bf16. p[r][k]: coordinate k of row g + 8r, where lane 4g + q
// holds rows g and g + 8. Channel order of ops/sphere_march.py's pe_rows
// (std: xyz, then sin(xyz), cos(xyz) per octave, six octaves) and
// pe_rows_wide (xyz, then four chains of five octaves at bases 2^(k/4));
// the padding channels were zeroed once and stay 0. The quad splits the
// work: `std`, lane q takes the (row, coordinate) pairs q and, for q < 2,
// q + 4; `wide`, lane q takes chain q of both rows (lane 0 also the raw xyz).
// Each runs the double-angle recurrence of its own values.
template <bool WIDE>
__device__ __forceinline__ void encode(const float (&p)[2][3], int lane, bf16* Es) {
  const int g = lane >> 2, q = lane & 3;
  __syncwarp();  // the previous evaluation's fragments are loaded
  if (WIDE) {
    // bases 2^(k/4) rounded to f32, as the reference's x * base
    const float b = q == 0   ? 1.0f
                    : q == 1 ? 1.189207115002721f
                    : q == 2 ? 1.4142135623730951f
                             : 1.681792830507429f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bf16* row = Es + (g + 8 * r) * FD_LDW;
      if (q == 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k) row[k] = to_bf(p[r][k]);
      }
      float s[3], c[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) sincosf(p[r][k] * b, &s[k], &c[k]);
      bf16* dst = row + 3 + 30 * q;
#pragma unroll
      for (int o = 0; o < 5; ++o) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          dst[6 * o + k] = to_bf(s[k]);
          dst[6 * o + 3 + k] = to_bf(c[k]);
        }
        if (o + 1 < 5) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float s2 = 2.0f * s[k] * c[k];
            c[k] = 1.0f - 2.0f * s[k] * s[k];
            s[k] = s2;
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pair = q + 4 * i, r = pair >= 3, k = pair - 3 * r;
      if (pair < 6) {
        const float x = pair == 0   ? p[0][0]
                        : pair == 1 ? p[0][1]
                        : pair == 2 ? p[0][2]
                        : pair == 3 ? p[1][0]
                        : pair == 4 ? p[1][1]
                                    : p[1][2];
        bf16* dst = Es + (g + 8 * r) * FD_LDW + k;
        dst[0] = to_bf(x);
        float s, c;
        sincosf(x, &s, &c);
#pragma unroll
        for (int o = 0; o < 6; ++o) {
          dst[3 + 6 * o] = to_bf(s);
          dst[6 + 6 * o] = to_bf(c);
          if (o + 1 < 6) {
            const float s2 = 2.0f * s * c;
            c = 1.0f - 2.0f * s * s;
            s = s2;
          }
        }
      }
    }
  }
  __syncwarp();
}

// The first layer's A fragments from the staging tile by ldmatrix: lanes
// 0-15 give rows 0-15 at k 0, lanes 16-31 the same rows at k 8.
template <int KT>
__device__ __forceinline__ void load_a(const bf16* Es, int lane, unsigned (&a)[KT][4]) {
  const unsigned ea = smem_u32(Es) + ((lane & 15) * FD_LDW + (lane >> 4) * 8) * 2;
#pragma unroll
  for (int k = 0; k < KT; ++k) ldsm_x4(a[k], ea + k * 16 * 2);
}

// acc = A @ W for the tile's 16 rows: A's KT k-tiles in registers, W [16 KT]
// [128] bf16 in shared memory (row stride FD_LDW), B fragments by
// ldmatrix.trans, one x4 for the two n8-tiles 2j and 2j + 1.
template <int KT>
__device__ __forceinline__ void product(const unsigned (&a)[KT][4], const bf16* W, int lane,
                                        float (&acc)[16][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  const unsigned wb = smem_u32(W) + ((lane & 15) * FD_LDW + (lane >> 4) * 8) * 2;
  unsigned b[8][4];
#pragma unroll
  for (int k = 0; k < KT; ++k) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ldsm_x4_t(b[j], wb + (k * 16 * FD_LDW + j * 16) * 2);
      mma_bf16(acc[2 * j], a[k], b[j][0], b[j][1]);
      mma_bf16(acc[2 * j + 1], a[k], b[j][2], b[j][3]);
    }
  }
}

// The next layer's A fragments: bf16(relu(acc + bias)); n8-tiles 2k and
// 2k + 1 of the product are k-tile k of the next input.
__device__ __forceinline__ void bias_relu(const float (&acc)[16][4], const float* bias, int lane,
                                          unsigned (&h)[8][4]) {
  const int q = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * q);
    h[j >> 1][2 * (j & 1)] = pack_bf2(fmaxf(acc[j][0] + b.x, 0.0f), fmaxf(acc[j][1] + b.y, 0.0f));
    h[j >> 1][2 * (j & 1) + 1] =
        pack_bf2(fmaxf(acc[j][2] + b.x, 0.0f), fmaxf(acc[j][3] + b.y, 0.0f));
  }
}

// The field at the tile's 16 points: v[r] of row g + 8r, the same bits in
// every lane of the quad. Ws, Fs: the block's weights and floats; Es: the
// warp's staging tile.
template <bool WIDE>
__device__ __forceinline__ void field16(const float (&p)[2][3], const bf16* Ws, const float* Fs,
                                        bf16* Es, int lane, float (&v)[2]) {
  using D = FieldDims<WIDE>;
  unsigned a0[MarchDims<WIDE>::KT0][4];
  encode<WIDE>(p, lane, Es);
  load_a(Es, lane, a0);
  float acc[16][4];
  product(a0, Ws, lane, acc);
#pragma unroll
  for (int l = 0; l < D::HIDDEN; ++l) {
    unsigned h[8][4];
    bias_relu(acc, Fs + l * FD_W, lane, h);
    product(h, Ws + (D::PE + l * FD_W) * FD_LDW, lane, acc);
  }
  // 128 -> 1 on the tensor cores: bf16(relu(acc + b_last)) @ w_out, w_out
  // being column 0 of an n8-tile that sits in the padding columns of the
  // last layer's rows (ldmatrix.trans, four x4 for the eight k-tiles); the
  // even and odd k-tiles summed apart
  unsigned h[8][4];
  bias_relu(acc, Fs + D::HIDDEN * FD_W, lane, h);
  const unsigned wo = smem_u32(Ws + (D::WROWS - FD_W + lane) * FD_LDW + FD_W);
  float o[2][4] = {};
#pragma unroll
  for (int k = 0; k < 8; k += 2) {
    unsigned b[4];
    ldsm_x4_t(b, wo + k * 16 * FD_LDW * 2);
    mma_bf16(o[0], h[k], b[0], b[1]);
    mma_bf16(o[1], h[k + 1], b[2], b[3]);
  }
  // column 0 is c0 (row g) and c2 (row g + 8) of lane 4g: to the whole quad
  const float b_out = Fs[(D::HIDDEN + 2) * FD_W];
  v[0] = __shfl_sync(FULL, o[0][0] + o[1][0], lane & ~3) + b_out;
  v[1] = __shfl_sync(FULL, o[0][2] + o[1][2], lane & ~3) + b_out;
}

template <bool WIDE>
__global__ void __launch_bounds__(SM_THREADS, 1) sphere_march_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ t_enter_g, const float* __restrict__ t_exit_g, int R,
    const bf16* __restrict__ W, const float* __restrict__ F, MarchArgs a,
    float* __restrict__ t_out, unsigned char* __restrict__ found_out) {
  using D = FieldDims<WIDE>;
  extern __shared__ __align__(128) unsigned char sm_smem[];
  bf16* Ws = reinterpret_cast<bf16*>(sm_smem);
  float* Fs = reinterpret_cast<float*>(Ws + D::WROWS * FD_LDW);
  for (int v = threadIdx.x; v < D::WELEMS / 8; v += SM_THREADS) {
    const int r = v / (FD_W / 8), c = (v % (FD_W / 8)) * 8;
    cp_async16(Ws + r * FD_LDW + c, W + (size_t)r * FD_W + c);
  }
  cp_async_commit();
  for (int v = threadIdx.x; v < D::FELEMS; v += SM_THREADS) Fs[v] = F[v];
  // the output weights as a [128][8] bf16 operand in the padding columns
  // 128-135 of the last layer's rows: w_out in column 128, zeros after it
  bf16* Wo = Ws + (D::WROWS - FD_W) * FD_LDW + FD_W;
  const float* w_out = F + (D::HIDDEN + 1) * FD_W;
  for (int v = threadIdx.x; v < FD_W * 8; v += SM_THREADS)
    Wo[(v >> 3) * FD_LDW + (v & 7)] = to_bf((v & 7) == 0 ? w_out[v >> 3] : 0.0f);
  cp_async_wait<0>();
  __syncthreads();  // the only block-wide barrier: warps never wait on each other after it

  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  bf16* Es = reinterpret_cast<bf16*>(Fs + D::FELEMS) + (threadIdx.x >> 5) * SM_RAYS * FD_LDW;
  float* Rs = reinterpret_cast<float*>(reinterpret_cast<bf16*>(Fs + D::FELEMS) +
                                       SM_WARPS * SM_RAYS * FD_LDW) +
              (threadIdx.x >> 5) * RAY_VALS * SM_RAYS;
  for (int v = lane; v < SM_RAYS * FD_LDW / 2; v += 32) reinterpret_cast<unsigned*>(Es)[v] = 0u;
  const int n_tiles = (R + SM_RAYS - 1) / SM_RAYS;
  const int evals = a.n_sphere + a.n_refine;
  for (int tile = blockIdx.x * SM_WARPS + (threadIdx.x >> 5); tile < n_tiles;
       tile += gridDim.x * SM_WARPS) {
    // lane q = 0 of each quad takes row g, q = 1 row g + 8: loads their rays,
    // then (after the march) stores their results
    const int row = g + 8 * q, id = tile * SM_RAYS + row;
    __syncwarp();  // the previous tile's values are read
    if (q < 2) ray_values(Rs, row, id, id < R, rays_o, rays_d, t_enter_g, t_exit_g, a);
    __syncwarp();
    Ray ray[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) ray[r].init(Rs + g + 8 * r);
    for (int it = 0; it < evals; ++it) {
      float te[2], p[2][3], v[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        te[r] = ray[r].next_t(it, a);
#pragma unroll
        for (int k = 0; k < 3; ++k) p[r][k] = ray[r].val(RV_O + k) + ray[r].val(RV_D + k) * te[r];
      }
      field16<WIDE>(p, Ws, Fs, Es, lane, v);
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

template <bool WIDE>
int launch_sphere_march(const void* rays_o, const void* rays_d, const void* t_enter,
                        const void* t_exit, int R, const void* W, const void* F,
                        nero::MarchArgs a, void* t_out, void* found_out, void* stream) {
  using namespace nero;
  constexpr size_t smem = MarchDims<WIDE>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(sphere_march_kernel<WIDE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // a persistent grid: enough blocks for the warp tiles, one per SM at most
  const int n_tiles = (R + SM_RAYS - 1) / SM_RAYS;
  const int grid = field_grid((n_tiles + SM_WARPS - 1) / SM_WARPS, &err);
  if (err != cudaSuccess) return (int)err;
  sphere_march_kernel<WIDE><<<grid, SM_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)rays_o, (const float*)rays_d, (const float*)t_enter, (const float*)t_exit,
      R, (const bf16*)W, (const float*)F, a, (float*)t_out, (unsigned char*)found_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sphere_march_tile() { return nero::SM_RAYS; }
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
