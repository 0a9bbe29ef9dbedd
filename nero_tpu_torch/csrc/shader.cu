// Whole Stage-I appearance shader, forward and backward, for Hopper (sm_90a).
//
// Replaces nero_tpu/ops/pallas/shader_kernel.py::shader_fused_raw (:552),
// pallas_calls nero_shader_fwd_f* (:467) and nero_shader_bwd_f* (:494), in
// all four variants: the kernels are templates on <SPHERE, HUMAN>
// (sphere_direction, :289-314; human_light, _human_block :219-255), so the
// default variant compiles to the code it had before the other three existed.
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
// SPHERE: the outer-light head reads [IDE(dir), IDE(hit)], 144 wide, where
// hit is the NORMALISED point at which the ray from the surface point
// (pulled inside radius 0.999) along dir leaves the unit sphere; evaluated
// for the normal (kappa = 1) and the reflective direction (kappa = the
// roughness). Its backward chains through the normalisation, the root
// sqrt(max(disc, 0) + 1e-6) and the 0.999 rescale to the point and the
// direction. (Stage II's light kernel, lights.cu, follows the other path of
// the JAX package and does not normalise the hit.)
//
// HUMAN: geometry rows carry the per-ray camera pose (R row-major, t: 21
// floats; data, no gradient). Per row: the rigid transform of point and
// reflective direction, the camera XoY-plane intersection, mean = 0.3 xy,
// var = roughness (0.3 dist)^2, the hit mask applied to both, the IPE of 6
// octaves (all sines, then all cosines), then a seventh head (24 -> 4,
// columns 19:23; column 23 is the hit mask). The backward goes through
// exp(-var s^2 / 2) sin/cos(mean s) to mean and var, from var to the
// roughness head and to dist, from dist and xy to the point and the
// reflective direction; the masks are constants.
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
constexpr int DGEO = 9;     // d pts, d normal, d view
constexpr int NPE8 = 51, NPE6 = 39;
constexpr int NIPE = 24;     // IPE of the 2-D plane hit, 6 octaves
constexpr int LDX = 272 + 8, LDH = HID + 8, LDC = 272 + 4;

enum { H_MET = 0, H_ROUGH, H_ALB, H_OUTER, H_INNER, H_OCC, H_HUMAN };
constexpr int DW_CHUNK_MIN_ROWS = 2048;  // rows per weight-gradient chunk, at least

// The layout of one variant: heads, head evaluations and input slots.
template <bool SPHERE, bool HUMAN>
struct Var {
  static constexpr bool sphere = SPHERE, human = HUMAN;
  static constexpr int NHEADS = HUMAN ? 7 : 6;
  static constexpr int NEVAL = HUMAN ? 8 : 7;
  static constexpr int NSLOT = HUMAN ? 6 : 5;
  static constexpr int GEO = HUMAN ? 21 : 9;  // pts, normal, view [, R row-major, t]
  static constexpr int RS_W = HUMAN ? 32 : 16;
  // input width per head, padded to a tile multiple: [feats,pts] 259, IDE 72
  // (twice with SPHERE), [PE8(pts), IDE] 123, [PE8(pts), PE6(refl)] 90, IPE 24
  __host__ __device__ static constexpr int head_di(int h) {
    return h <= H_ALB ? 272 : h == H_OUTER ? (SPHERE ? 144 : 80) : h == H_INNER ? 128
         : h == H_OCC ? 96 : 32;
  }
  __host__ __device__ static constexpr size_t head_elems(int h) {
    return (size_t)head_di(h) * HID + 2 * (size_t)HID * HID + (size_t)HID * DO;
  }
  __host__ __device__ static constexpr size_t head_off(int h) {
    size_t off = 0;
    for (int i = 0; i < h; ++i) off += head_elems(i);
    return off;
  }
  // head evaluations: head, first packed output column, outputs, input slot
  __host__ __device__ static constexpr int ev_head(int e) {
    return e <= 2 ? e : e == 3 || e == 4 ? H_OUTER : e == 5 ? H_INNER : e == 6 ? H_OCC : H_HUMAN;
  }
  __host__ __device__ static constexpr int ev_col(int e) {
    return e == 0 ? 0 : e == 1 ? 1 : e == 2 ? 2 : e == 3 ? 5 : e == 4 ? 8 : e == 5 ? 11
         : e == 6 ? 14 : 19;
  }
  __host__ __device__ static constexpr int ev_nout(int e) {
    return (e == 0 || e == 1 || e == 6) ? 1 : e == 7 ? 4 : 3;
  }
  __host__ __device__ static constexpr int ev_slot(int e) { return e <= 2 ? 0 : e - 2; }
  __host__ __device__ static constexpr int slot_di(int s) {
    return s == 0 ? 272 : s <= 2 ? (SPHERE ? 144 : 80) : s == 3 ? 128 : s == 4 ? 96 : 32;
  }
  __host__ __device__ static constexpr size_t slot_off(int s) {  // per-row offset of slot s
    size_t off = 0;
    for (int i = 0; i < s; ++i) off += slot_di(i);
    return off;
  }
  __host__ __device__ static constexpr size_t w_total() { return head_off(NHEADS); }
  __host__ __device__ static constexpr size_t x_row() { return slot_off(NSLOT); }
  static constexpr size_t smem_bytes() {
    return (size_t)P * LDX * 2 + (size_t)P * LDH * 2 + (size_t)P * LDC * 4 +
           (size_t)P * RS_W * 4 + (size_t)P * OUT * 4 + 2 * (size_t)P * NIDE * 4 +
           (size_t)P * 9 * 4 + TAB * 4;
  }
};

// scratch (bf16) for M rows: X[M][X_ROW], H[NEVAL*3][M][256], DZ[NEVAL*3][M][256],
// DZ4[NEVAL][M][16]
template <class L>
struct Scratch {
  bf16 *X, *H, *DZ, *DZ4;
  size_t M;
  __host__ __device__ Scratch(bf16* base, size_t m) : M(m) {
    X = base;
    H = X + M * L::x_row();
    DZ = H + L::NEVAL * 3 * M * HID;
    DZ4 = DZ + L::NEVAL * 3 * M * HID;
  }
  static size_t elems(size_t m) {
    return m * L::x_row() + 2 * L::NEVAL * 3 * m * HID + L::NEVAL * m * DO;
  }
};

// per-row state in shared memory (RS_POSE, RS_HIT: HUMAN only, rows 32 wide)
enum { RS_PTS = 0, RS_N = 3, RS_V = 6, RS_R = 9, RS_NOV = 12, RS_KAPPA = 13, RS_NLEN = 14,
       RS_VLEN = 15, RS_POSE = 16, RS_HIT = 28 };
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

template <class L>
__device__ Smem carve(unsigned char* base) {
  Smem s;
  s.X = reinterpret_cast<bf16*>(base);
  s.Hb = s.X + P * LDX;
  s.C = reinterpret_cast<float*>(s.Hb + P * LDH);
  s.rs = s.C + P * LDC;
  s.G = s.rs + P * L::RS_W;
  s.dIr = s.G + P * OUT;
  s.dIn = s.dIr + P * NIDE;
  s.rg = s.dIn + P * NIDE;
  s.tab = s.rg + P * RG_W;
  return s;
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// ---- sphere_direction: the normalised exit point of the ray on the unit sphere ----

// p pulled inside radius 0.999, then hit = normalize(sp + d * dist) with
// dist = -sp.d + sqrt(max((sp.d)^2 - sp.sp + 1, 0) + 1e-6).
struct SphereHit {
  float sp[3], u[3], norm, dtx, disc, root, dist, len;
};

__device__ void sphere_hit(const float* p, const float* d, SphereHit& h) {
  h.norm = sqrtf(dot3(p, p));
  for (int k = 0; k < 3; ++k)
    h.sp[k] = h.norm > 0.999f ? p[k] / fmaxf(h.norm, 1e-12f) * 0.999f : p[k];
  h.dtx = dot3(h.sp, d);
  h.disc = h.dtx * h.dtx - dot3(h.sp, h.sp) + 1.0f;
  h.root = sqrtf(fmaxf(h.disc, 0.0f) + 1e-6f);
  h.dist = -h.dtx + h.root;
  float raw[3];
  for (int k = 0; k < 3; ++k) raw[k] = h.sp[k] + d[k] * h.dist;
  normalize3(raw, h.u, &h.len);
}

// cotangent du of the unit hit -> dp, dd (both added to)
__device__ void sphere_hit_bwd(const float* p, const float* d, const SphereHit& h,
                               const float* du, float* dp, float* dd) {
  float dh[3];
  normalize3_bwd(h.u, h.len, du, dh);
  const float d_dist = dot3(dh, d);
  const float d_disc = h.disc > 0.0f ? d_dist / (2.0f * h.root) : 0.0f;
  const float d_dtx = -d_dist + 2.0f * h.dtx * d_disc;
  float dsp[3];
  for (int k = 0; k < 3; ++k) {
    dd[k] += dh[k] * h.dist + d_dtx * h.sp[k];
    dsp[k] = dh[k] + d_dtx * d[k] - 2.0f * d_disc * h.sp[k];
  }
  if (h.norm > 0.999f) {  // sp = 0.999 p / |p|
    const float pd = dot3(p, dsp) / (h.norm * h.norm);
    for (int k = 0; k < 3; ++k) dp[k] += 0.999f * (dsp[k] - p[k] * pd) / h.norm;
  } else {
    for (int k = 0; k < 3; ++k) dp[k] += dsp[k];
  }
}

// ---- human_light: camera-plane intersection and its IPE ----

struct HumanRow {
  float ph[3], dh[3], dz, dist, mean[2], var, hit;
  bool hits0;
};

// pose: R row-major [9], t [3]. p: the point, r: the reflective direction.
__device__ void human_row(const float* pose, const float* p, const float* r, float rough,
                          HumanRow& h) {
  for (int i = 0; i < 3; ++i) {
    h.ph[i] = dot3(pose + 3 * i, p) + pose[9 + i];
    h.dh[i] = dot3(pose + 3 * i, r);
  }
  h.hits0 = fabsf(h.dh[2]) > 1e-4f;
  h.dz = h.hits0 ? h.dh[2] : 1e-4f;
  h.dist = -h.ph[2] / h.dz;
  for (int k = 0; k < 2; ++k) h.mean[k] = (h.ph[k] + h.dist * h.dh[k]) * 0.3f;
  const float sd = h.dist * 0.3f;
  h.var = rough * sd * sd;
  const bool hit = h.hits0 && sqrtf(h.mean[0] * h.mean[0] + h.mean[1] * h.mean[1]) < 1.5f &&
                   h.dist > 0.0f;
  h.hit = hit ? 1.0f : 0.0f;
  h.mean[0] *= h.hit;
  h.mean[1] *= h.hit;
  h.var *= h.hit;
}

// IPE, octaves 0..5: enc[2 i + k] = E[sin], enc[12 + 2 i + k] = E[cos]
__device__ void human_ipe(const HumanRow& h, float* enc) {
  for (int i = 0; i < 6; ++i) {
    const float s = (float)(1 << i);
    const float att = expf(-0.5f * h.var * s * s);
    for (int k = 0; k < 2; ++k) {
      enc[2 * i + k] = att * sinf(h.mean[k] * s);
      enc[12 + 2 * i + k] = att * cosf(h.mean[k] * s);
    }
  }
}

// cotangent g [24] of the IPE -> dp, dr (added to) and d roughness (returned)
__device__ float human_bwd(const float* pose, const HumanRow& h, float rough, const float* g,
                           float* dp, float* dr) {
  if (h.hit == 0.0f) return 0.0f;  // mean and var are masked to constants
  float dmean[2] = {0.0f, 0.0f}, dvar = 0.0f;
  for (int i = 0; i < 6; ++i) {
    const float s = (float)(1 << i);
    const float att = expf(-0.5f * h.var * s * s);
    for (int k = 0; k < 2; ++k) {
      const float a = h.mean[k] * s;
      const float sn = sinf(a), cs = cosf(a);
      const float gs = g[2 * i + k], gc = g[12 + 2 * i + k];
      dmean[k] += s * att * (gs * cs - gc * sn);
      dvar += -0.5f * s * s * att * (gs * sn + gc * cs);
    }
  }
  const float sd = h.dist * 0.3f;
  const float drough = dvar * sd * sd;
  float d_dist = dvar * rough * 2.0f * 0.09f * h.dist;
  float dph[3] = {0.0f, 0.0f, 0.0f}, ddh[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < 2; ++k) {
    const float dxy = 0.3f * dmean[k];
    dph[k] += dxy;
    d_dist += dxy * h.dh[k];
    ddh[k] += h.dist * dxy;
  }
  // dist = -ph_z / dz, dz = dh_z where |dh_z| > 1e-4 (it is: the row hit)
  dph[2] += -d_dist / h.dz;
  ddh[2] += d_dist * h.ph[2] / (h.dz * h.dz);
  for (int j = 0; j < 3; ++j)
    for (int i = 0; i < 3; ++i) {
      dp[j] += pose[3 * i + j] * dph[i];
      dr[j] += pose[3 * i + j] * ddh[i];
    }
  return drough;
}

// build head input slot s into X (and, for the backward, into the scratch)
template <bool BWD, class L>
__device__ void build_input(const Smem& s, int slot, const float* feats, int p0, int n,
                            Scratch<L> S, size_t row0) {
  const int tid = threadIdx.x;
  const int di = L::slot_di(slot);
  if (slot == 0) {
    for (int idx = tid; idx < P * di; idx += NTHREADS) {
      const int r = idx / di, c = idx % di;
      float v = 0.0f;
      if (p0 + r < n) {
        if (c < HID) v = feats[(size_t)(p0 + r) * HID + c];
        else if (c < HID + 3) v = s.rs[r * L::RS_W + RS_PTS + c - HID];
      }
      s.X[r * LDX + c] = to_bf(v);
    }
  } else {
    // zero, then per-row encodings
    for (int idx = tid; idx < P * di; idx += NTHREADS) s.X[(idx / di) * LDX + idx % di] = to_bf(0.0f);
    __syncthreads();
    if (slot == 3 || slot == 4) {
      for (int idx = tid; idx < P * NPE8; idx += NTHREADS) {
        const int r = idx / NPE8, c = idx % NPE8;
        s.X[r * LDX + c] = to_bf(pe_val(s.rs + r * L::RS_W + RS_PTS, c));
      }
    }
    if (slot == 4) {
      for (int idx = tid; idx < P * NPE6; idx += NTHREADS) {
        const int r = idx / NPE6, c = idx % NPE6;
        s.X[r * LDX + NPE8 + c] = to_bf(pe_val(s.rs + r * L::RS_W + RS_R, c));
      }
    } else if (slot == 5) {
      if constexpr (L::human) if (tid < P) {
        const int r = tid;
        float* rs = s.rs + r * L::RS_W;
        HumanRow h;
        human_row(rs + RS_POSE, rs + RS_PTS, rs + RS_R, rs[RS_KAPPA], h);
        rs[RS_HIT] = h.hit;
        float enc[NIPE];
        human_ipe(h, enc);
        for (int c = 0; c < NIPE; ++c) s.X[r * LDX + c] = to_bf(enc[c]);
      }
    } else if (tid < P) {
      const int r = tid;
      const float* rs = s.rs + r * L::RS_W;
      const bool normal = slot == 1;
      const float* d = rs + (normal ? RS_N : RS_R);
      const float kappa = normal ? 1.0f : rs[RS_KAPPA];
      float enc[NIDE];
      ide_row(s.tab, d[0], d[1], d[2], kappa, enc, 1);
      const int off = slot == 3 ? NPE8 : 0;
      for (int c = 0; c < NIDE; ++c) s.X[r * LDX + off + c] = to_bf(enc[c]);
      if constexpr (L::sphere) if (slot <= 2) {
        SphereHit h;
        sphere_hit(rs + RS_PTS, d, h);
        ide_row(s.tab, h.u[0], h.u[1], h.u[2], kappa, enc, 1);
        for (int c = 0; c < NIDE; ++c) s.X[r * LDX + NIDE + c] = to_bf(enc[c]);
      }
    }
  }
  __syncthreads();
  if (BWD) {
    constexpr size_t X_ROW = L::x_row();
    for (int idx = tid; idx < P * di; idx += NTHREADS) {
      const int r = idx / di, c = idx % di;
      S.X[(row0 + r) * X_ROW + L::slot_off(slot) + c] = s.X[r * LDX + c];
    }
  }
}

// one head evaluation forward; raw outputs go to C[:, 0:DO] (bias added)
template <bool BWD, class L>
__device__ void head_fwd(const Smem& s, int e, const bf16* Wall, const float* Ball,
                         Scratch<L> S, size_t row0) {
  const int h = L::ev_head(e), di = L::head_di(h);
  const bf16* W1 = Wall + L::head_off(h);
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
template <class L>
__device__ void head_bwd(const Smem& s, int e, bool want_dx, const bf16* Wall, Scratch<L> S,
                         size_t row0) {
  const int h = L::ev_head(e), di = L::head_di(h), col = L::ev_col(e), nout = L::ev_nout(e);
  const bf16* W1 = Wall + L::head_off(h);
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

// the sphere part of an outer-light evaluation's input cotangent (C[:, 72:144])
// back to the point and the direction; returns d kappa
__device__ float sphere_enc_bwd(const Smem& s, int r, const float* p, const float* d,
                                float kappa, float* dp, float* dd) {
  SphereHit h;
  sphere_hit(p, d, h);
  float du[3] = {0.0f, 0.0f, 0.0f};
  const float gk = ide_row_bwd(s.tab, h.u[0], h.u[1], h.u[2], kappa, s.C + r * LDC + NIDE, du);
  sphere_hit_bwd(p, d, h, du, dp, dd);
  return gk;
}

template <bool BWD, class L>
__global__ void __launch_bounds__(NTHREADS, 1)
shader_rows_kernel(const float* __restrict__ geo, const float* __restrict__ feats, int n,
                   const bf16* __restrict__ W, const float* __restrict__ B,
                   const float* __restrict__ ide_tab, float* __restrict__ out,
                   const float* __restrict__ gout, float* __restrict__ dgeo,
                   float* __restrict__ dfeats, bf16* __restrict__ scratch, int m_rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem s = carve<L>(smem_raw);
  constexpr int RS_W = L::RS_W;
  constexpr int GEO = L::GEO;
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * P;
  const size_t row0 = (size_t)p0;
  Scratch<L> S(scratch, (size_t)m_rows);

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
    if constexpr (L::human)
      for (int k = 0; k < 12; ++k) rs[RS_POSE + k] = g[(GEO - 12) + k];
  }
  __syncthreads();

  // forward: materials, then the lights (IDE_r needs the roughness)
  build_input<BWD, L>(s, 0, feats, p0, n, S, row0);
  for (int e = 0; e < L::NEVAL; ++e) {
    if (e >= 3) build_input<BWD, L>(s, L::ev_slot(e), feats, p0, n, S, row0);
    head_fwd<BWD, L>(s, e, W, B, S, row0);
    if (!BWD) {
      for (int idx = tid; idx < P * L::ev_nout(e); idx += NTHREADS) {
        const int r = idx / L::ev_nout(e), c = idx % L::ev_nout(e);
        if (p0 + r < n) out[(size_t)(p0 + r) * OUT + L::ev_col(e) + c] = s.C[r * LDC + c];
      }
    }
    if (e == 1 && tid < P) s.rs[tid * RS_W + RS_KAPPA] = sigmoidf_(s.C[tid * LDC]);
    __syncthreads();
  }
  if (!BWD) {
    // reflective 15:18, NoV 18; then zeros, or (HUMAN) the hit mask in 23
    // behind the seventh head's 19:23
    for (int idx = tid; idx < P * (OUT - 15); idx += NTHREADS) {
      const int r = idx / (OUT - 15), c = idx % (OUT - 15);
      if (p0 + r >= n) continue;
      if (L::human && c >= 4 && c < 8) continue;
      const float* rs = s.rs + r * RS_W;
      const float v = c < 3 ? rs[RS_R + c] : c == 3 ? rs[RS_NOV]
                    : (L::human && c == 8) ? rs[RS_HIT] : 0.0f;
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

  if constexpr (L::human) {
    head_bwd<L>(s, 7, true, W, S, row0);  // human: IPE of the plane hit
    if (tid < P) {
      const int r = tid;
      const float* rs = s.rs + r * RS_W;
      float* rg = s.rg + r * RG_W;
      const float kappa = rs[RS_KAPPA];
      HumanRow h;
      human_row(rs + RS_POSE, rs + RS_PTS, rs + RS_R, kappa, h);
      const float drough = human_bwd(rs + RS_POSE, h, kappa, s.C + r * LDC, rg + RG_PTS,
                                     rg + RG_R);
      s.G[r * OUT + 1] += kappa * (1.0f - kappa) * drough;
    }
    __syncthreads();
  }
  head_bwd<L>(s, 6, false, W, S, row0);  // occ: inputs are stop-gradient
  head_bwd<L>(s, 5, true, W, S, row0);   // inner: [PE8(pts), IDE_r]
  if (tid < P) {
    const int r = tid;
    pe_bwd(s.rs + r * RS_W + RS_PTS, s.C + r * LDC, 1, 8, s.rg + r * RG_W + RG_PTS);
    for (int c = 0; c < NIDE; ++c) s.dIr[r * NIDE + c] += s.C[r * LDC + NPE8 + c];
  }
  __syncthreads();
  head_bwd<L>(s, 4, true, W, S, row0);   // outer light on IDE_r [, IDE(hit_r)]
  for (int idx = tid; idx < P * NIDE; idx += NTHREADS) {
    const int r = idx / NIDE, c = idx % NIDE;
    s.dIr[idx] += s.C[r * LDC + c];
  }
  if constexpr (L::sphere) if (tid < P) {
    const int r = tid;
    const float* rs = s.rs + r * RS_W;
    float* rg = s.rg + r * RG_W;
    const float kappa = rs[RS_KAPPA];
    const float gk = sphere_enc_bwd(s, r, rs + RS_PTS, rs + RS_R, kappa, rg + RG_PTS, rg + RG_R);
    s.G[r * OUT + 1] += kappa * (1.0f - kappa) * gk;
  }
  __syncthreads();
  head_bwd<L>(s, 3, true, W, S, row0);   // outer light on IDE_n [, IDE(hit_n)]
  for (int idx = tid; idx < P * NIDE; idx += NTHREADS) {
    const int r = idx / NIDE, c = idx % NIDE;
    s.dIn[idx] = s.C[r * LDC + c];
  }
  if constexpr (L::sphere) if (tid < P) {
    const int r = tid;
    const float* rs = s.rs + r * RS_W;
    float* rg = s.rg + r * RG_W;
    sphere_enc_bwd(s, r, rs + RS_PTS, rs + RS_N, 1.0f, rg + RG_PTS, rg + RG_N);
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
    head_bwd<L>(s, mat_order[i], true, W, S, row0);
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
    float* d = dgeo + (size_t)(p0 + r) * DGEO;
    for (int k = 0; k < 3; ++k) {
      d[k] = rg[RG_PTS + k];
      d[3 + k] = dn_raw[k];
      d[6 + k] = dv_raw[k];
    }
  }
}

template <class L>
int launch_fwd(const float* geo, const float* feats, int n, const bf16* W, const float* B,
               const float* tab, float* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(shader_rows_kernel<false, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::smem_bytes());
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + P - 1) / P;
  shader_rows_kernel<false, L><<<tiles, NTHREADS, L::smem_bytes(), stream>>>(
      geo, feats, n, W, B, tab, out, nullptr, nullptr, nullptr, nullptr, tiles * P);
  return (int)cudaGetLastError();
}

template <class L>
int launch_bwd(const float* geo, const float* feats, int n, const bf16* W, const float* B,
               const float* tab, const float* gout, float* dgeo, float* dfeats, bf16* scratch,
               float* part, float* dW, float* dB, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(shader_rows_kernel<true, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::smem_bytes());
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + P - 1) / P;
  const int M = tiles * P;
  const int n_chunks = dw_chunks(M, DW_CHUNK_MIN_ROWS);
  shader_rows_kernel<true, L><<<tiles, NTHREADS, L::smem_bytes(), stream>>>(
      geo, feats, n, W, B, tab, nullptr, gout, dgeo, dfeats, scratch, M);
  Scratch<L> S(scratch, (size_t)M);
  const size_t LH = (size_t)M * HID;
  for (int e = 0; e < L::NEVAL; ++e) {
    const int h = L::ev_head(e), di = L::head_di(h);
    const int acc = (e == 4);  // the outer-light head is evaluated twice
    float* dw = dW + L::head_off(h);
    float* db = dB + h * 4 * HID;
    const bf16* H = S.H + (size_t)e * 3 * LH;
    const bf16* DZ = S.DZ + (size_t)e * 3 * LH;
    const bf16* DZ4 = S.DZ4 + (size_t)e * M * DO;
    weight_grad(S.X + L::slot_off(L::ev_slot(e)), (int)L::x_row(), DZ, HID, M, di, HID, n_chunks,
                part, dw, acc, stream);
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

// call fn<Var<sphere, human>>(args...) for the runtime variant
#define SHADER_DISPATCH(fn, sphere, human, ...)                      \
  ((sphere) ? ((human) ? fn<Var<true, true>>(__VA_ARGS__)            \
                       : fn<Var<true, false>>(__VA_ARGS__))          \
            : ((human) ? fn<Var<false, true>>(__VA_ARGS__)           \
                       : fn<Var<false, false>>(__VA_ARGS__)))

template <class L> size_t weight_elems_of(int) { return L::w_total(); }
template <class L> size_t scratch_elems_of(size_t m) { return Scratch<L>::elems(m); }

}  // namespace

extern "C" {

size_t shader_weight_elems(int sphere, int human) {
  return SHADER_DISPATCH(weight_elems_of, sphere, human, 0);
}
int shader_tile() { return P; }
size_t shader_scratch_elems(int m_rows, int sphere, int human) {
  return SHADER_DISPATCH(scratch_elems_of, sphere, human, (size_t)m_rows);
}
size_t shader_part_elems(int m_rows) {
  // the widest product of any head: the first layer at 272 x 256, which also
  // covers the 256 x 256 hidden layers
  return part_elems(m_rows, dw_chunks(m_rows, DW_CHUNK_MIN_ROWS), 272, HID);
}

// geo [n,9] (pts, normal, view) or, with human, [n,21] (+ R row-major, t);
// feats [n,256]; W packed bf16 heads; B [6 or 7,4,256] f32; tab = IDE table;
// out [n,24].
int shader_fwd(const float* geo, const float* feats, int n, const bf16* W, const float* B,
               const float* tab, int sphere, int human, float* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  return SHADER_DISPATCH(launch_fwd, sphere, human, geo, feats, n, W, B, tab, out, stream);
}

// gout [n,24] -> dgeo [n,9], dfeats [n,256], dW (packed layout, f32),
// dB [6 or 7,4,256] (zeroed by the caller). part: shader_part_elems(m_rows)
// floats, m_rows = n rounded up to the tile.
int shader_bwd(const float* geo, const float* feats, int n, const bf16* W, const float* B,
               const float* tab, int sphere, int human, const float* gout, float* dgeo,
               float* dfeats, bf16* scratch, float* part, float* dW, float* dB,
               cudaStream_t stream) {
  if (n <= 0) return 0;
  return SHADER_DISPATCH(launch_bwd, sphere, human, geo, feats, n, W, B, tab, gout, dgeo,
                         dfeats, scratch, part, dW, dB, stream);
}

}  // extern "C"
