// Whole Stage-I appearance shader, forward and backward, for Hopper (sm_90a).
//
// Replaces nero_tpu/ops/pallas/shader_kernel.py::shader_fused_raw (:552),
// pallas_calls nero_shader_fwd_f* (:467) and nero_shader_bwd_f* (:494), in
// its default variant (no sphere_direction, no human_light).
//
// Forward (shader_rows_kernel<false>): one block per tile of P = 64 rows.
// Per row: normalize normal and view, NoV, reflective; IDE(normal, 1),
// IDE(reflective, sigmoid(roughness_z)) by the de-Moivre recurrence of
// utils/encodings.py (polynomial, NaN-free), PE(pts, 8), PE(reflective, 6);
// then the six 4-layer 256-wide ReLU heads (outer light twice) through
// block_mm, and the packed raw [N, 24] of shader_kernel.py:262-265. Rows past
// N are masked (never read, never written), not padded.
//
// Backward: the TPU kernel linearises its forward with jax.vjp inside the
// kernel body (shader_kernel.py:373); here the gradient is derived by hand.
// shader_rows_kernel<true> recomputes the tile's forward, writing each head
// evaluation's input X and hidden activations H1..H3 (bf16) to device
// memory, then back-propagates per tile: each head's ReLU chain (dZ stored
// for the weight gradients, dX = dZ1 @ W1^T for the inputs), then the
// encoding backward per row -- the IDE derivative in direction and in
// kappa (exp(-sigma kappa) with kappa = sigmoid(roughness_z), which feeds
// the outer/inner light gradient back into the roughness head), PE, the
// reflection, NoV and both normalizations. The occ head's inputs are
// stop-gradient (shader_kernel.py:321). Outputs: d_geo (pts, normals, view)
// and d_feats per row; the head parameter gradients come from the two-pass
// chunked reduction of common.cuh.
//
// Bound: tensor-core operations, 2,754,960 FLOP per row forward
// (shader_kernel.py::_flops_per_row) and 3x that backward. This first
// version runs the per-row encodings one thread per row and round-trips the
// backward's activations (about 1.5 GB at N = 65,536) through device memory.
#include "encode.cuh"

using namespace nero;

namespace {

constexpr int P = 64;
constexpr int NTHREADS = 512;
constexpr int HID = 256;
constexpr int DO = 16;       // head outputs padded
constexpr int OUT = 24;      // packed raw outputs
constexpr int GEO = 9;       // pts, normal, view
constexpr int NPE8 = 51, NPE6 = 39;
constexpr int LDX = 272 + 8, LDH = HID + 8, LDC = 272 + 4;
constexpr int NHEADS = 6;
constexpr int NEVAL = 7;

enum { H_MET = 0, H_ROUGH, H_ALB, H_OUTER, H_INNER, H_OCC };
// input width per head, padded to a tile multiple: [feats,pts] 259, IDE 72,
// [PE8(pts), IDE] 123, [PE8(pts), PE6(refl)] 90
__host__ __device__ constexpr int head_di(int h) {
  return h <= H_ALB ? 272 : h == H_OUTER ? 80 : h == H_INNER ? 128 : 96;
}
__host__ __device__ constexpr size_t head_elems(int h) {
  return (size_t)head_di(h) * HID + 2 * (size_t)HID * HID + (size_t)HID * DO;
}
__host__ __device__ constexpr size_t head_off(int h) {
  size_t off = 0;
  for (int i = 0; i < h; ++i) off += head_elems(i);
  return off;
}
constexpr size_t W_TOTAL = head_off(NHEADS);
constexpr int MAX_DI = head_di(H_MET);   // the widest head input
constexpr int DW_CHUNK_MIN_ROWS = 2048;  // rows per weight-gradient chunk, at least

// head evaluations: head, first packed output column, outputs, input slot
__host__ __device__ constexpr int ev_head(int e) {
  return e <= 2 ? e : e == 3 || e == 4 ? H_OUTER : e == 5 ? H_INNER : H_OCC;
}
__host__ __device__ constexpr int ev_col(int e) {
  return e == 0 ? 0 : e == 1 ? 1 : e == 2 ? 2 : e == 3 ? 5 : e == 4 ? 8 : e == 5 ? 11 : 14;
}
__host__ __device__ constexpr int ev_nout(int e) { return (e == 0 || e == 1 || e == 6) ? 1 : 3; }
__host__ __device__ constexpr int ev_slot(int e) { return e <= 2 ? 0 : e - 2; }
__host__ __device__ constexpr int slot_di(int s) {
  return s == 0 ? 272 : s <= 2 ? 80 : s == 3 ? 128 : 96;
}
__host__ __device__ constexpr size_t slot_off(int s) {  // per-row offset of slot s
  size_t off = 0;
  for (int i = 0; i < s; ++i) off += slot_di(i);
  return off;
}
constexpr size_t X_ROW = slot_off(5);

// scratch (bf16) for M rows: X[M][X_ROW], H[7*3][M][256], DZ[7*3][M][256], DZ4[7][M][16]
struct Scratch {
  bf16 *X, *H, *DZ, *DZ4;
  size_t M;
  __host__ __device__ Scratch(bf16* base, size_t m) : M(m) {
    X = base;
    H = X + M * X_ROW;
    DZ = H + NEVAL * 3 * M * HID;
    DZ4 = DZ + NEVAL * 3 * M * HID;
  }
  static size_t elems(size_t m) { return m * X_ROW + 2 * NEVAL * 3 * m * HID + NEVAL * m * DO; }
};

// per-row state in shared memory
enum { RS_PTS = 0, RS_N = 3, RS_V = 6, RS_R = 9, RS_NOV = 12, RS_KAPPA = 13, RS_NLEN = 14,
       RS_VLEN = 15, RS_W = 16 };
// per-row gradient accumulators
enum { RG_PTS = 0, RG_N = 3, RG_R = 6, RG_W = 9 };

struct Smem {
  bf16* X;       // [P][LDX]
  bf16* Hb;      // [P][LDH]
  float* C;      // [P][LDC]
  float* rs;     // [P][RS_W]
  float* G;      // [P][OUT]   cotangent of the packed outputs
  float* dIr;    // [P][NIDE]  cotangent of IDE(reflective)
  float* dIn;    // [P][NIDE]  cotangent of IDE(normal)
  float* rg;     // [P][RG_W]
  float* tab;    // IDE table: mat [(LMAX+1)][NML], sigma [NML], m [NML]
};
constexpr size_t SMEM_BYTES = (size_t)P * LDX * 2 + (size_t)P * LDH * 2 + (size_t)P * LDC * 4 +
                              (size_t)P * RS_W * 4 + (size_t)P * OUT * 4 +
                              2 * (size_t)P * NIDE * 4 + (size_t)P * RG_W * 4 + TAB * 4;

__device__ Smem carve(unsigned char* base) {
  Smem s;
  s.X = reinterpret_cast<bf16*>(base);
  s.Hb = s.X + P * LDX;
  s.C = reinterpret_cast<float*>(s.Hb + P * LDH);
  s.rs = s.C + P * LDC;
  s.G = s.rs + P * RS_W;
  s.dIr = s.G + P * OUT;
  s.dIn = s.dIr + P * NIDE;
  s.rg = s.dIn + P * NIDE;
  s.tab = s.rg + P * RG_W;
  return s;
}

// build head input slot s into X (and, for the backward, into the scratch)
template <bool BWD>
__device__ void build_input(const Smem& s, int slot, const float* feats, int p0, int n,
                            Scratch S, size_t row0) {
  const int tid = threadIdx.x;
  const int di = slot_di(slot);
  if (slot == 0) {
    for (int idx = tid; idx < P * di; idx += NTHREADS) {
      const int r = idx / di, c = idx % di;
      float v = 0.0f;
      if (p0 + r < n) {
        if (c < HID) v = feats[(size_t)(p0 + r) * HID + c];
        else if (c < HID + 3) v = s.rs[r * RS_W + RS_PTS + c - HID];
      }
      s.X[r * LDX + c] = to_bf(v);
    }
  } else {
    // zero, then per-row encodings
    for (int idx = tid; idx < P * di; idx += NTHREADS) s.X[(idx / di) * LDX + idx % di] = to_bf(0.0f);
    __syncthreads();
    if (slot >= 3) {
      for (int idx = tid; idx < P * NPE8; idx += NTHREADS) {
        const int r = idx / NPE8, c = idx % NPE8;
        s.X[r * LDX + c] = to_bf(pe_val(s.rs + r * RS_W + RS_PTS, c));
      }
    }
    if (slot == 4) {
      for (int idx = tid; idx < P * NPE6; idx += NTHREADS) {
        const int r = idx / NPE6, c = idx % NPE6;
        s.X[r * LDX + NPE8 + c] = to_bf(pe_val(s.rs + r * RS_W + RS_R, c));
      }
    } else if (tid < P) {
      const int r = tid;
      const float* rs = s.rs + r * RS_W;
      const bool normal = slot == 1;
      const float* d = rs + (normal ? RS_N : RS_R);
      float enc[NIDE];
      ide_row(s.tab, d[0], d[1], d[2], normal ? 1.0f : rs[RS_KAPPA], enc, 1);
      const int off = slot == 3 ? NPE8 : 0;
      for (int c = 0; c < NIDE; ++c) s.X[r * LDX + off + c] = to_bf(enc[c]);
    }
  }
  __syncthreads();
  if (BWD) {
    for (int idx = tid; idx < P * di; idx += NTHREADS) {
      const int r = idx / di, c = idx % di;
      S.X[(row0 + r) * X_ROW + slot_off(slot) + c] = s.X[r * LDX + c];
    }
  }
}

// one head evaluation forward; raw outputs go to C[:, 0:DO] (bias added)
template <bool BWD>
__device__ void head_fwd(const Smem& s, int e, const bf16* Wall, const float* Ball, Scratch S,
                         size_t row0) {
  const int h = ev_head(e), di = head_di(h);
  const bf16* W1 = Wall + head_off(h);
  const bf16* Wl[4] = {W1, W1 + (size_t)di * HID, W1 + (size_t)di * HID + HID * HID,
                       W1 + (size_t)di * HID + 2 * HID * HID};
  const float* b = Ball + h * 4 * HID;
  for (int l = 0; l < 3; ++l) {
    if (l == 0) block_mm<false>(s.X, LDX, Wl[0], HID, s.C, LDC, P, HID, di, false);
    else block_mm<false>(s.Hb, LDH, Wl[l], HID, s.C, LDC, P, HID, HID, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < P * HID; idx += NTHREADS) {
      const int r = idx / HID, c = idx % HID;
      const bf16 v = to_bf(fmaxf(s.C[r * LDC + c] + b[l * HID + c], 0.0f));
      s.Hb[r * LDH + c] = v;
      if (BWD) S.H[((size_t)(e * 3 + l) * S.M + row0 + r) * HID + c] = v;
    }
    __syncthreads();
  }
  block_mm<false>(s.Hb, LDH, Wl[3], DO, s.C, LDC, P, DO, HID, false);
  __syncthreads();
  for (int idx = threadIdx.x; idx < P * DO; idx += NTHREADS) {
    const int r = idx / DO, c = idx % DO;
    s.C[r * LDC + c] += b[3 * HID + c];
  }
  __syncthreads();
}

// one head evaluation backward from the cotangent in G (its output
// columns); dZ of every layer goes to the scratch; if want_dx, the input
// cotangent dX = dZ1 @ W1^T is left in C[:, 0:di].
__device__ void head_bwd(const Smem& s, int e, bool want_dx, const bf16* Wall, Scratch S,
                         size_t row0) {
  const int h = ev_head(e), di = head_di(h), col = ev_col(e), nout = ev_nout(e);
  const bf16* W1 = Wall + head_off(h);
  const bf16* Wl[4] = {W1, W1 + (size_t)di * HID, W1 + (size_t)di * HID + HID * HID,
                       W1 + (size_t)di * HID + 2 * HID * HID};
  for (int idx = threadIdx.x; idx < P * DO; idx += NTHREADS) {
    const int r = idx / DO, c = idx % DO;
    const bf16 v = to_bf(c < nout ? s.G[r * OUT + col + c] : 0.0f);
    s.Hb[r * LDH + c] = v;
    S.DZ4[((size_t)e * S.M + row0 + r) * DO + c] = v;
  }
  __syncthreads();
  block_mm<true>(s.Hb, LDH, Wl[3], DO, s.C, LDC, P, HID, DO, false);  // dH3
  __syncthreads();
  for (int l = 2; l >= 0; --l) {
    const bf16* H = S.H + (size_t)(e * 3 + l) * S.M * HID;
    bf16* DZ = S.DZ + (size_t)(e * 3 + l) * S.M * HID;
    for (int idx = threadIdx.x; idx < P * HID; idx += NTHREADS) {
      const int r = idx / HID, c = idx % HID;
      const bool on = from_bf(H[(row0 + r) * HID + c]) > 0.0f;
      const bf16 v = to_bf(on ? s.C[r * LDC + c] : 0.0f);
      s.Hb[r * LDH + c] = v;
      DZ[(row0 + r) * HID + c] = v;
    }
    __syncthreads();
    if (l > 0) block_mm<true>(s.Hb, LDH, Wl[l], HID, s.C, LDC, P, HID, HID, false);
    else if (want_dx) block_mm<true>(s.Hb, LDH, Wl[0], HID, s.C, LDC, P, di, HID, false);
    __syncthreads();
  }
}

template <bool BWD>
__global__ void __launch_bounds__(NTHREADS, 1)
shader_rows_kernel(const float* __restrict__ geo, const float* __restrict__ feats, int n,
                   const bf16* __restrict__ W, const float* __restrict__ B,
                   const float* __restrict__ ide_tab, float* __restrict__ out,
                   const float* __restrict__ gout, float* __restrict__ dgeo,
                   float* __restrict__ dfeats, bf16* __restrict__ scratch, int m_rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem s = carve(smem_raw);
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * P;
  const size_t row0 = (size_t)p0;
  Scratch S(scratch, (size_t)m_rows);

  for (int i = tid; i < TAB; i += NTHREADS) s.tab[i] = ide_tab[i];
  if (tid < P) {
    const int r = tid;
    float* rs = s.rs + r * RS_W;
    float g[GEO] = {0.0f};
    if (p0 + r < n)
      for (int k = 0; k < GEO; ++k) g[k] = geo[(size_t)(p0 + r) * GEO + k];
    for (int k = 0; k < 3; ++k) rs[RS_PTS + k] = g[k];
    normalize3(g + 3, rs + RS_N, rs + RS_NLEN);
    normalize3(g + 6, rs + RS_V, rs + RS_VLEN);
    const float* nn = rs + RS_N;
    const float* vv = rs + RS_V;
    const float nov = nn[0] * vv[0] + nn[1] * vv[1] + nn[2] * vv[2];
    rs[RS_NOV] = nov;
    for (int k = 0; k < 3; ++k) rs[RS_R + k] = nov * nn[k] * 2.0f - vv[k];
  }
  __syncthreads();

  // forward: materials, then the lights (IDE_r needs the roughness)
  build_input<BWD>(s, 0, feats, p0, n, S, row0);
  for (int e = 0; e < NEVAL; ++e) {
    if (e >= 3) build_input<BWD>(s, ev_slot(e), feats, p0, n, S, row0);
    head_fwd<BWD>(s, e, W, B, S, row0);
    if (!BWD) {
      for (int idx = tid; idx < P * ev_nout(e); idx += NTHREADS) {
        const int r = idx / ev_nout(e), c = idx % ev_nout(e);
        if (p0 + r < n) out[(size_t)(p0 + r) * OUT + ev_col(e) + c] = s.C[r * LDC + c];
      }
    }
    if (e == 1 && tid < P) s.rs[tid * RS_W + RS_KAPPA] = sigmoidf_(s.C[tid * LDC]);
    __syncthreads();
  }
  if (!BWD) {
    for (int idx = tid; idx < P * (OUT - 15); idx += NTHREADS) {
      const int r = idx / (OUT - 15), c = idx % (OUT - 15);
      if (p0 + r >= n) continue;
      const float* rs = s.rs + r * RS_W;
      const float v = c < 3 ? rs[RS_R + c] : c == 3 ? rs[RS_NOV] : 0.0f;
      out[(size_t)(p0 + r) * OUT + 15 + c] = v;
    }
    return;
  }

  // ---- backward ----
  for (int idx = tid; idx < P * OUT; idx += NTHREADS) {
    const int r = idx / OUT, c = idx % OUT;
    s.G[idx] = p0 + r < n ? gout[(size_t)(p0 + r) * OUT + c] : 0.0f;
  }
  for (int idx = tid; idx < P * NIDE; idx += NTHREADS) s.dIr[idx] = 0.0f;
  for (int idx = tid; idx < P * RG_W; idx += NTHREADS) s.rg[idx] = 0.0f;
  __syncthreads();

  head_bwd(s, 6, false, W, S, row0);  // occ: inputs are stop-gradient
  head_bwd(s, 5, true, W, S, row0);   // inner: [PE8(pts), IDE_r]
  if (tid < P) {
    const int r = tid;
    pe_bwd(s.rs + r * RS_W + RS_PTS, s.C + r * LDC, 1, 8, s.rg + r * RG_W + RG_PTS);
    for (int c = 0; c < NIDE; ++c) s.dIr[r * NIDE + c] += s.C[r * LDC + NPE8 + c];
  }
  __syncthreads();
  head_bwd(s, 4, true, W, S, row0);   // outer light on IDE_r
  for (int idx = tid; idx < P * NIDE; idx += NTHREADS) {
    const int r = idx / NIDE, c = idx % NIDE;
    s.dIr[idx] += s.C[r * LDC + c];
  }
  __syncthreads();
  head_bwd(s, 3, true, W, S, row0);   // outer light on IDE_n
  for (int idx = tid; idx < P * NIDE; idx += NTHREADS) {
    const int r = idx / NIDE, c = idx % NIDE;
    s.dIn[idx] = s.C[r * LDC + c];
  }
  __syncthreads();
  if (tid < P) {
    // IDE backward: directions, and kappa -> roughness_z
    const int r = tid;
    const float* rs = s.rs + r * RS_W;
    float* rg = s.rg + r * RG_W;
    const float kappa = rs[RS_KAPPA];
    const float gk = ide_row_bwd(s.tab, rs[RS_R], rs[RS_R + 1], rs[RS_R + 2], kappa,
                                 s.dIr + r * NIDE, rg + RG_R);
    s.G[r * OUT + 1] += kappa * (1.0f - kappa) * gk;
    ide_row_bwd(s.tab, rs[RS_N], rs[RS_N + 1], rs[RS_N + 2], 1.0f, s.dIn + r * NIDE, rg + RG_N);
  }
  __syncthreads();
  // materials: [feats, pts]; d_feats summed over the three heads
  const int mat_order[3] = {1, 0, 2};
  for (int i = 0; i < 3; ++i) {
    head_bwd(s, mat_order[i], true, W, S, row0);
    for (int idx = tid; idx < P * HID; idx += NTHREADS) {
      const int r = idx / HID, c = idx % HID;
      if (p0 + r >= n) continue;
      float* d = dfeats + (size_t)(p0 + r) * HID + c;
      *d = (i == 0 ? 0.0f : *d) + s.C[r * LDC + c];
    }
    if (tid < P)
      for (int k = 0; k < 3; ++k) s.rg[tid * RG_W + RG_PTS + k] += s.C[tid * LDC + HID + k];
    __syncthreads();
  }
  if (tid < P && p0 + tid < n) {
    // reflective = 2 NoV n - v, NoV = n.v, then both normalizations
    const int r = tid;
    const float* rs = s.rs + r * RS_W;
    const float* rg = s.rg + r * RG_W;
    const float* nn = rs + RS_N;
    const float* vv = rs + RS_V;
    float dr[3], dn[3], dv[3];
    for (int k = 0; k < 3; ++k) dr[k] = rg[RG_R + k] + s.G[r * OUT + 15 + k];
    const float nov = rs[RS_NOV];
    const float dnov = s.G[r * OUT + 18] + 2.0f * (dr[0] * nn[0] + dr[1] * nn[1] + dr[2] * nn[2]);
    for (int k = 0; k < 3; ++k) {
      dn[k] = rg[RG_N + k] + 2.0f * nov * dr[k] + dnov * vv[k];
      dv[k] = -dr[k] + dnov * nn[k];
    }
    float dn_raw[3], dv_raw[3];
    normalize3_bwd(nn, rs[RS_NLEN], dn, dn_raw);
    normalize3_bwd(vv, rs[RS_VLEN], dv, dv_raw);
    float* d = dgeo + (size_t)(p0 + r) * GEO;
    for (int k = 0; k < 3; ++k) {
      d[k] = rg[RG_PTS + k];
      d[3 + k] = dn_raw[k];
      d[6 + k] = dv_raw[k];
    }
  }
}

}  // namespace

extern "C" {

size_t shader_weight_elems() { return W_TOTAL; }
int shader_tile() { return P; }
size_t shader_scratch_elems(int m_rows) { return Scratch::elems((size_t)m_rows); }
size_t shader_part_elems(int m_rows) {
  return part_elems(m_rows, dw_chunks(m_rows, DW_CHUNK_MIN_ROWS), MAX_DI, HID);
}

// geo [n,9] (pts, normal, view), feats [n,256]; W packed bf16 heads;
// B [6,4,256] f32; tab = IDE table; out [n,24].
int shader_fwd(const float* geo, const float* feats, int n, const bf16* W, const float* B,
               const float* tab, float* out, cudaStream_t stream) {
  cudaFuncSetAttribute(shader_rows_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM_BYTES);
  const int tiles = (n + P - 1) / P;
  shader_rows_kernel<false><<<tiles, NTHREADS, SMEM_BYTES, stream>>>(
      geo, feats, n, W, B, tab, out, nullptr, nullptr, nullptr, nullptr, tiles * P);
  return (int)cudaGetLastError();
}

// gout [n,24] -> dgeo [n,9], dfeats [n,256], dW (packed layout, f32),
// dB [6,4,256] (zeroed by the caller). part: shader_part_elems(m_rows) floats,
// m_rows = n rounded up to the tile.
int shader_bwd(const float* geo, const float* feats, int n, const bf16* W, const float* B,
               const float* tab, const float* gout, float* dgeo, float* dfeats, bf16* scratch,
               float* part, float* dW, float* dB, cudaStream_t stream) {
  cudaFuncSetAttribute(shader_rows_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM_BYTES);
  const int tiles = (n + P - 1) / P;
  const int M = tiles * P;
  const int n_chunks = dw_chunks(M, DW_CHUNK_MIN_ROWS);
  shader_rows_kernel<true><<<tiles, NTHREADS, SMEM_BYTES, stream>>>(
      geo, feats, n, W, B, tab, nullptr, gout, dgeo, dfeats, scratch, M);
  Scratch S(scratch, (size_t)M);
  const size_t LH = (size_t)M * HID;
  for (int e = 0; e < NEVAL; ++e) {
    const int h = ev_head(e), di = head_di(h);
    const int acc = (e == 4);  // the outer-light head is evaluated twice
    float* dw = dW + head_off(h);
    float* db = dB + h * 4 * HID;
    const bf16* H = S.H + (size_t)e * 3 * LH;
    const bf16* DZ = S.DZ + (size_t)e * 3 * LH;
    const bf16* DZ4 = S.DZ4 + (size_t)e * M * DO;
    weight_grad(S.X + slot_off(ev_slot(e)), (int)X_ROW, DZ, HID, M, di, HID, n_chunks, part, dw,
                acc, stream);
    weight_grad(H, HID, DZ + LH, HID, M, HID, HID, n_chunks, part, dw + (size_t)di * HID, acc,
                stream);
    weight_grad(H + LH, HID, DZ + 2 * LH, HID, M, HID, HID, n_chunks, part,
                dw + (size_t)di * HID + HID * HID, acc, stream);
    weight_grad(H + 2 * LH, HID, DZ4, DO, M, HID, DO, n_chunks, part,
                dw + (size_t)di * HID + 2 * HID * HID, acc, stream);
    for (int l = 0; l < 3; ++l)
      bias_grad(DZ + l * LH, HID, M, HID, 1, 1, part, db + l * HID, acc, stream);
    bias_grad(DZ4, DO, M, DO, 1, 1, part, db + 3 * HID, acc, stream);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
