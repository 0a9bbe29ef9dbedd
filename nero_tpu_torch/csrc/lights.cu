// Stage-II light heads with their encodings, forward and backward, for Hopper
// (sm_90a).
//
// Replaces nero_tpu/ops/pallas/light_kernel.py::lights_fused_raw (:307),
// pallas_calls nero_lights_fwd_f* (:231) and nero_lights_bwd_f* (:259), body
// _lights_block (:69-117). Per row of the (surface point x sample direction)
// lattice it computes the pre-exp outputs of
//   * the outer light head on IDE(direction, kappa = 0), the direction taken
//     raw (it is unit by construction; normalising it would project the
//     radial part out of its gradient), and for `sphere_direction` also on
//     IDE(hit point of the ray on the unit sphere). The hit point is NOT
//     normalised: this follows the unfused path (fields/mc_shading.py::
//     predict_outer_lights), in value and in gradient;
//   * (mode `both`) the inner light head on PE8(traced hit point) and
//     IDE(reflection of the normalised -direction about the normalised hit
//     normal, kappa = 0).
// The exp activations, the hit select and the human light stay outside.
// Heads are 4 layers, 256 wide, ReLU; weights bf16, sums f32 (block_mm).
//
// Forward (lights_rows_kernel<false>): one block per tile of P = 64 rows; the
// per-row geometry by one thread per row, the encodings by 8 threads per row
// (IDE by the de-Moivre recurrence of encode.cuh, polynomial and NaN-free, so
// it evaluates the unnormalised hit point as the plain version does), the
// head products through block_mm, 6 floats out per row. Rows past N are
// masked: never read, never written.
//
// Backward: the TPU kernel linearises its forward with jax.vjp inside its
// body (:154); here it is derived by hand. lights_rows_kernel<true>
// recomputes the tile's forward, writing each head's input X and hidden
// activations H1..H3 (bf16) to device memory, then runs each head's ReLU
// chain in reverse (dZ stored for the weight gradients, dX = dZ1 @ W1^T),
// and pushes dX through the IDE and the row geometry to d points and
// d directions: the sphere hit (through the root and the 0.999 clamp of the
// point), the reflection and the normalisation of -direction. The traced hit
// points and normals arrive detached and get no gradient. Weight and bias
// gradients come from the two-pass chunked reduction of common.cuh
// (deterministic, no atomics).
//
// Bound: tensor-core operations, 2*(di*256 + 2*256*256 + 256*3) per row and
// head forward and 3x that backward, against 72 bytes per row. This first
// version streams the weights from L2 and round-trips the backward's
// activations (6.7 KB per row) through device memory.
#include "encode.cuh"

using namespace nero;

namespace {

constexpr int P = 64;
constexpr int NTHREADS = 512;
constexpr int LANES = NTHREADS / P;  // threads per row in the per-row phases
constexpr int HID = 256;
constexpr int DO = 16;   // head outputs padded
constexpr int GEO = 12;  // points, directions, traced hit points, hit normals
constexpr int OUT = 6;   // inner_z 0:3, outer_z 3:6
constexpr int DGEO = 6;  // d points, d directions
constexpr int NPE8 = 51;
constexpr int DI_INNER = 128;      // 51 + 72 = 123, padded
constexpr int DI_OUTER = 80;       // 72, padded
constexpr int DI_OUTER_SPH = 144;  // 2 x 72
constexpr int MAX_DI = DI_OUTER_SPH;
constexpr int LDX = MAX_DI + 8, LDH = HID + 8, LDC = HID + 4;
constexpr int DW_CHUNK_MIN_ROWS = 2048;  // rows per weight-gradient chunk, at least

__host__ __device__ constexpr size_t head_welems(int di) {
  return (size_t)di * HID + 2 * (size_t)HID * HID + (size_t)HID * DO;
}
// backward scratch of one head for M rows (bf16): X [M][di], H [3][M][256],
// DZ [3][M][256], DZ4 [M][16]
__host__ __device__ constexpr size_t head_scratch(int di, size_t M) {
  return M * di + 6 * M * HID + M * DO;
}

struct Head {
  const bf16* W;   // w1 [di,256], w2, w3 [256,256], w4 [256,16], row-major [in,out]
  const float* B;  // [4][256]
  int di;          // padded input width
  int col;         // first column of the head's outputs in the packed row
  bf16 *X, *H, *DZ, *DZ4;  // backward scratch (null in the forward)
  size_t M;                // rows of the scratch
};

__host__ __device__ inline void head_layers(const Head& h, const bf16** Wl) {
  Wl[0] = h.W;
  Wl[1] = Wl[0] + (size_t)h.di * HID;
  Wl[2] = Wl[1] + (size_t)HID * HID;
  Wl[3] = Wl[2] + (size_t)HID * HID;
}

inline Head make_head(const bf16* W, const float* B, int di, int col, bf16* scratch, size_t M) {
  Head h{W, B, di, col, nullptr, nullptr, nullptr, nullptr, M};
  if (scratch) {
    h.X = scratch;
    h.H = h.X + M * di;
    h.DZ = h.H + 3 * M * HID;
    h.DZ4 = h.DZ + 3 * M * HID;
  }
  return h;
}

struct Args {
  Head inner, outer;
  int n, sphere, both;
};

// per-row state in shared memory
enum { RS_D = 0, RS_SP = 3, RS_HP = 6, RS_DIST = 9, RS_ROOT = 10, RS_NORM = 11, RS_DISC = 12,
       RS_P = 13, RS_N = 16, RS_V = 19, RS_VLEN = 22, RS_R = 23, RS_IN = 26, RS_W = 32 };
// per-row gradient accumulators
enum { RG_P = 0, RG_D = 3, RG_W = 8 };

struct Smem {
  bf16* X;     // [P][LDX]
  bf16* Hb;    // [P][LDH]
  float* C;    // [P][LDC]
  float* rs;   // [P][RS_W]
  float* G;    // [P][8]  cotangent of the packed outputs
  float* rg;   // [P][RG_W]
  float* tab;  // IDE table
};
constexpr size_t SMEM_BYTES = (size_t)P * LDX * 2 + (size_t)P * LDH * 2 + (size_t)P * LDC * 4 +
                              (size_t)P * RS_W * 4 + (size_t)P * 8 * 4 + (size_t)P * RG_W * 4 +
                              TAB * 4;

__device__ Smem carve(unsigned char* base) {
  Smem s;
  s.X = reinterpret_cast<bf16*>(base);
  s.Hb = s.X + P * LDX;
  s.C = reinterpret_cast<float*>(s.Hb + P * LDH);
  s.rs = s.C + P * LDC;
  s.G = s.rs + P * RS_W;
  s.rg = s.G + P * 8;
  s.tab = s.rg + P * RG_W;
  return s;
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// sum over the LANES neighbouring threads of a row
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = 1; o < LANES; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The head's input tile into X (and, for the backward, into its scratch).
template <bool BWD>
__device__ void build_input(const Smem& s, const Head& h, bool inner, bool sphere,
                            size_t row0) {
  const int tid = threadIdx.x;
  const int r = tid / LANES, lane = tid % LANES;
  const float* rs = s.rs + r * RS_W;
  bf16* xrow = s.X + r * LDX;
  if (inner) {
    for (int c = lane; c < NPE8; c += LANES) xrow[c] = to_bf(pe_val(rs + RS_IN, c));
    ide_row(s.tab, rs[RS_R], rs[RS_R + 1], rs[RS_R + 2], 0.0f, xrow + NPE8, 1, lane, LANES);
    for (int c = NPE8 + NIDE + lane; c < h.di; c += LANES) xrow[c] = to_bf(0.0f);
  } else {
    ide_row(s.tab, rs[RS_D], rs[RS_D + 1], rs[RS_D + 2], 0.0f, xrow, 1, lane, LANES);
    if (sphere)
      ide_row(s.tab, rs[RS_HP], rs[RS_HP + 1], rs[RS_HP + 2], 0.0f, xrow + NIDE, 1, lane, LANES);
    for (int c = (sphere ? 2 : 1) * NIDE + lane; c < h.di; c += LANES) xrow[c] = to_bf(0.0f);
  }
  __syncthreads();
  if (BWD) {
    for (int idx = tid; idx < P * h.di; idx += NTHREADS) {
      const int rr = idx / h.di, c = idx % h.di;
      h.X[(row0 + rr) * h.di + c] = s.X[rr * LDX + c];
    }
  }
}

// one head forward; raw outputs go to C[:, 0:DO] (bias added)
template <bool BWD>
__device__ void head_fwd(const Smem& s, const Head& h, size_t row0) {
  const bf16* Wl[4];
  head_layers(h, Wl);
  for (int l = 0; l < 3; ++l) {
    if (l == 0) block_mm<false>(s.X, LDX, Wl[0], HID, s.C, LDC, P, HID, h.di, false);
    else block_mm<false>(s.Hb, LDH, Wl[l], HID, s.C, LDC, P, HID, HID, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < P * HID; idx += NTHREADS) {
      const int r = idx / HID, c = idx % HID;
      const bf16 v = to_bf(fmaxf(s.C[r * LDC + c] + h.B[l * HID + c], 0.0f));
      s.Hb[r * LDH + c] = v;
      if (BWD) h.H[((size_t)l * h.M + row0 + r) * HID + c] = v;
    }
    __syncthreads();
  }
  block_mm<false>(s.Hb, LDH, Wl[3], DO, s.C, LDC, P, DO, HID, false);
  __syncthreads();
  for (int idx = threadIdx.x; idx < P * DO; idx += NTHREADS) {
    const int r = idx / DO, c = idx % DO;
    s.C[r * LDC + c] += h.B[3 * HID + c];
  }
  __syncthreads();
}

// one head backward from the cotangent in G (its three output columns); dZ
// of every layer goes to the scratch; the input cotangent dX = dZ1 @ W1^T is
// left in C[:, 0:di].
__device__ void head_bwd(const Smem& s, const Head& h, size_t row0) {
  const bf16* Wl[4];
  head_layers(h, Wl);
  for (int idx = threadIdx.x; idx < P * DO; idx += NTHREADS) {
    const int r = idx / DO, c = idx % DO;
    const bf16 v = to_bf(c < 3 ? s.G[r * 8 + h.col + c] : 0.0f);
    s.Hb[r * LDH + c] = v;
    h.DZ4[(row0 + r) * DO + c] = v;
  }
  __syncthreads();
  block_mm<true>(s.Hb, LDH, Wl[3], DO, s.C, LDC, P, HID, DO, false);  // dH3
  __syncthreads();
  for (int l = 2; l >= 0; --l) {
    const bf16* H = h.H + (size_t)l * h.M * HID;
    bf16* DZ = h.DZ + (size_t)l * h.M * HID;
    for (int idx = threadIdx.x; idx < P * HID; idx += NTHREADS) {
      const int r = idx / HID, c = idx % HID;
      const bool on = from_bf(H[(row0 + r) * HID + c]) > 0.0f;
      const bf16 v = to_bf(on ? s.C[r * LDC + c] : 0.0f);
      s.Hb[r * LDH + c] = v;
      DZ[(row0 + r) * HID + c] = v;
    }
    __syncthreads();
    if (l > 0) block_mm<true>(s.Hb, LDH, Wl[l], HID, s.C, LDC, P, HID, HID, false);
    else block_mm<true>(s.Hb, LDH, Wl[0], HID, s.C, LDC, P, h.di, HID, false);
    __syncthreads();
  }
}

template <bool BWD>
__global__ void __launch_bounds__(NTHREADS, 1)
lights_rows_kernel(const float* __restrict__ geo, Args a, const float* __restrict__ ide_tab,
                   float* __restrict__ out, const float* __restrict__ gout,
                   float* __restrict__ dgeo) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem s = carve(smem_raw);
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * P;
  const size_t row0 = (size_t)p0;
  const int n = a.n;
  const bool sphere = a.sphere != 0, both = a.both != 0;

  for (int i = tid; i < TAB; i += NTHREADS) s.tab[i] = ide_tab[i];
  if (tid < P) {
    // row geometry
    const int r = tid;
    float* rs = s.rs + r * RS_W;
    float g[GEO] = {0.0f};
    if (p0 + r < n)
      for (int k = 0; k < GEO; ++k) g[k] = geo[(size_t)(p0 + r) * GEO + k];
    const float* p = g;
    const float* d = g + 3;
    for (int k = 0; k < 3; ++k) {
      rs[RS_P + k] = p[k];
      rs[RS_D + k] = d[k];
      rs[RS_IN + k] = g[6 + k];
    }
    if (sphere) {
      // the point pulled inside the unit sphere, then the ray's exit point
      const float norm = sqrtf(dot3(p, p));
      float sp[3];
      for (int k = 0; k < 3; ++k)
        sp[k] = norm > 0.999f ? p[k] * 0.999f / fmaxf(norm, 1e-12f) : p[k];
      const float dtx = dot3(sp, d), xtx = dot3(sp, sp);
      const float disc = dtx * dtx - xtx + 1.0f;
      const float root = sqrtf(fmaxf(disc, 0.0f) + 1e-6f);
      const float dist = -dtx + root;
      for (int k = 0; k < 3; ++k) {
        rs[RS_SP + k] = sp[k];
        rs[RS_HP + k] = sp[k] + d[k] * dist;
      }
      rs[RS_DIST] = dist;
      rs[RS_ROOT] = root;
      rs[RS_NORM] = norm;
      rs[RS_DISC] = disc;
    }
    if (both) {
      float nlen;
      normalize3(g + 9, rs + RS_N, &nlen);
      const float negd[3] = {-d[0], -d[1], -d[2]};
      normalize3(negd, rs + RS_V, rs + RS_VLEN);
      const float nov = dot3(rs + RS_V, rs + RS_N);
      for (int k = 0; k < 3; ++k) rs[RS_R + k] = nov * rs[RS_N + k] * 2.0f - rs[RS_V + k];
    }
  }
  __syncthreads();

  // forward: outer head, then (mode both) inner head
  build_input<BWD>(s, a.outer, false, sphere, row0);
  head_fwd<BWD>(s, a.outer, row0);
  if (!BWD) {
    for (int idx = tid; idx < P * 3; idx += NTHREADS) {
      const int r = idx / 3, c = idx % 3;
      if (p0 + r < n) {
        out[(size_t)(p0 + r) * OUT + 3 + c] = s.C[r * LDC + c];
        if (!both) out[(size_t)(p0 + r) * OUT + c] = 0.0f;
      }
    }
    __syncthreads();
  }
  if (both) {
    build_input<BWD>(s, a.inner, true, sphere, row0);
    head_fwd<BWD>(s, a.inner, row0);
    if (!BWD) {
      for (int idx = tid; idx < P * 3; idx += NTHREADS) {
        const int r = idx / 3, c = idx % 3;
        if (p0 + r < n) out[(size_t)(p0 + r) * OUT + c] = s.C[r * LDC + c];
      }
    }
  }
  if (!BWD) return;

  // ---- backward ----
  for (int idx = tid; idx < P * 8; idx += NTHREADS) {
    const int r = idx / 8, c = idx % 8;
    s.G[idx] = (c < OUT && p0 + r < n) ? gout[(size_t)(p0 + r) * OUT + c] : 0.0f;
  }
  for (int idx = tid; idx < P * RG_W; idx += NTHREADS) s.rg[idx] = 0.0f;
  __syncthreads();

  const int r = tid / LANES, lane = tid % LANES;
  const float* rs = s.rs + r * RS_W;
  float* rg = s.rg + r * RG_W;

  head_bwd(s, a.outer, row0);
  {
    // IDE(direction) and IDE(sphere hit point) back to the row geometry
    float dd[3] = {0.0f, 0.0f, 0.0f}, dhp[3] = {0.0f, 0.0f, 0.0f};
    ide_row_bwd(s.tab, rs[RS_D], rs[RS_D + 1], rs[RS_D + 2], 0.0f, s.C + r * LDC, dd, lane,
                LANES);
    if (sphere)
      ide_row_bwd(s.tab, rs[RS_HP], rs[RS_HP + 1], rs[RS_HP + 2], 0.0f, s.C + r * LDC + NIDE,
                  dhp, lane, LANES);
    for (int k = 0; k < 3; ++k) {
      dd[k] = lane_sum(dd[k]);
      dhp[k] = lane_sum(dhp[k]);
    }
    if (lane == 0) {
      float dp[3] = {0.0f, 0.0f, 0.0f};
      if (sphere) {
        // hp = sp + d * dist, dist = -dtx + sqrt(max(disc, 0) + 1e-6),
        // disc = dtx^2 - xtx + 1, dtx = sp.d, xtx = sp.sp
        const float* d = rs + RS_D;
        const float* sp = rs + RS_SP;
        const float dist = rs[RS_DIST];
        const float d_dist = dot3(dhp, d);
        const float d_disc = rs[RS_DISC] > 0.0f ? d_dist / (2.0f * rs[RS_ROOT]) : 0.0f;
        const float dtx = dot3(sp, d);
        const float d_dtx = -d_dist + 2.0f * dtx * d_disc;
        float dsp[3];
        for (int k = 0; k < 3; ++k) {
          dd[k] += dhp[k] * dist + d_dtx * sp[k];
          dsp[k] = dhp[k] + d_dtx * d[k] - 2.0f * d_disc * sp[k];
        }
        // sp = p * 0.999 / |p| where |p| > 0.999, else p
        const float norm = rs[RS_NORM];
        if (norm > 0.999f) {
          const float* p = rs + RS_P;
          const float pd = dot3(p, dsp) / (norm * norm);
          for (int k = 0; k < 3; ++k) dp[k] = 0.999f * (dsp[k] - p[k] * pd) / norm;
        } else {
          for (int k = 0; k < 3; ++k) dp[k] = dsp[k];
        }
      }
      for (int k = 0; k < 3; ++k) {
        rg[RG_P + k] = dp[k];
        rg[RG_D + k] = dd[k];
      }
    }
  }
  __syncthreads();

  if (both) {
    head_bwd(s, a.inner, row0);
    // IDE(reflection) -> view -> direction; PE8(traced hit point) is detached
    float dr[3] = {0.0f, 0.0f, 0.0f};
    ide_row_bwd(s.tab, rs[RS_R], rs[RS_R + 1], rs[RS_R + 2], 0.0f, s.C + r * LDC + NPE8, dr,
                lane, LANES);
    for (int k = 0; k < 3; ++k) dr[k] = lane_sum(dr[k]);
    if (lane == 0) {
      // refl = 2 (v.n) n - v with n detached; v = normalize(-d)
      const float* nn = rs + RS_N;
      const float ndr = dot3(nn, dr);
      float dv[3], dneg[3];
      for (int k = 0; k < 3; ++k) dv[k] = 2.0f * ndr * nn[k] - dr[k];
      normalize3_bwd(rs + RS_V, rs[RS_VLEN], dv, dneg);
      for (int k = 0; k < 3; ++k) rg[RG_D + k] -= dneg[k];
    }
    __syncthreads();
  }

  for (int idx = tid; idx < P * DGEO; idx += NTHREADS) {
    const int rr = idx / DGEO, c = idx % DGEO;
    if (p0 + rr < n) dgeo[(size_t)(p0 + rr) * DGEO + c] = s.rg[rr * RG_W + c];
  }
}

int outer_di(int sphere) { return sphere ? DI_OUTER_SPH : DI_OUTER; }

// heads over the packed buffers: [inner (mode both)] [outer]
Args make_args(const bf16* W, const float* B, int n, int sphere, int both, bf16* scratch,
               size_t M) {
  Args a;
  a.n = n;
  a.sphere = sphere;
  a.both = both;
  const int di_o = outer_di(sphere);
  const bf16* Wo = W + (both ? head_welems(DI_INNER) : 0);
  const float* Bo = B + (both ? 4 * HID : 0);
  bf16* so = scratch ? scratch + (both ? head_scratch(DI_INNER, M) : 0) : nullptr;
  a.inner = make_head(W, B, DI_INNER, 0, both ? scratch : nullptr, M);
  a.outer = make_head(Wo, Bo, di_o, 3, so, M);
  return a;
}

}  // namespace

extern "C" {

int lights_tile() { return P; }
size_t lights_weight_elems(int sphere, int both) {
  return head_welems(outer_di(sphere)) + (both ? head_welems(DI_INNER) : 0);
}
size_t lights_scratch_elems(int m_rows, int sphere, int both) {
  return head_scratch(outer_di(sphere), (size_t)m_rows) +
         (both ? head_scratch(DI_INNER, (size_t)m_rows) : 0);
}
size_t lights_part_elems(int m_rows) {
  // the largest product of the reduction is a hidden layer's, 256 x 256
  return part_elems(m_rows, dw_chunks(m_rows, DW_CHUNK_MIN_ROWS), MAX_DI > HID ? MAX_DI : HID,
                    HID);
}

// geo [n,12] (points, directions, traced hit points, hit normals); W packed
// bf16 heads ([inner] outer); B [heads][4][256] f32; tab = IDE table;
// out [n,6] (inner_z, outer_z; inner_z zeros unless `both`).
int lights_fwd(const float* geo, int n, const bf16* W, const float* B, const float* tab,
               int sphere, int both, float* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(lights_rows_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + P - 1) / P;
  const Args a = make_args(W, B, n, sphere, both, nullptr, (size_t)tiles * P);
  lights_rows_kernel<false><<<tiles, NTHREADS, SMEM_BYTES, stream>>>(geo, a, tab, out, nullptr,
                                                                    nullptr);
  return (int)cudaGetLastError();
}

// gout [n,6] -> dgeo [n,6] (d points, d directions), dW (packed layout, f32),
// dB [heads][4][256] (zeroed by the caller). scratch: lights_scratch_elems
// bf16; part: lights_part_elems floats; m_rows = n rounded up to the tile.
int lights_bwd(const float* geo, int n, const bf16* W, const float* B, const float* tab,
               int sphere, int both, const float* gout, float* dgeo, bf16* scratch,
               float* part, float* dW, float* dB, cudaStream_t stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(lights_rows_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + P - 1) / P;
  const int M = tiles * P;
  const int n_chunks = dw_chunks(M, DW_CHUNK_MIN_ROWS);
  const Args a = make_args(W, B, n, sphere, both, scratch, (size_t)M);
  lights_rows_kernel<true><<<tiles, NTHREADS, SMEM_BYTES, stream>>>(geo, a, tab, nullptr, gout,
                                                                   dgeo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t LH = (size_t)M * HID;
  for (int k = both ? 0 : 1; k < 2; ++k) {
    const Head& h = k == 0 ? a.inner : a.outer;
    float* dw = dW + (h.W - W);
    float* db = dB + (h.B - B);
    const int di = h.di;
    weight_grad(h.X, di, h.DZ, HID, M, di, HID, n_chunks, part, dw, 0, stream);
    weight_grad(h.H, HID, h.DZ + LH, HID, M, HID, HID, n_chunks, part, dw + (size_t)di * HID, 0,
                stream);
    weight_grad(h.H + LH, HID, h.DZ + 2 * LH, HID, M, HID, HID, n_chunks, part,
                dw + (size_t)di * HID + HID * HID, 0, stream);
    weight_grad(h.H + 2 * LH, HID, h.DZ4, DO, M, HID, DO, n_chunks, part,
                dw + (size_t)di * HID + 2 * HID * HID, 0, stream);
    for (int l = 0; l < 3; ++l)
      bias_grad(h.DZ + l * LH, HID, M, HID, 1, 1, part, db + l * HID, 0, stream);
    bias_grad(h.DZ4, DO, M, DO, 1, 1, part, db + 3 * HID, 0, stream);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
