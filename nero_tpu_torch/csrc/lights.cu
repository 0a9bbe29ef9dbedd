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
// Heads are 4 layers, 256 wide, ReLU; weights bf16, sums f32. The IDE's
// degree is the build's (encode.cuh's NERO_IDE_DEG; ops/lights.py builds one
// library per degree a configuration asks for): at degree 5 the inputs are
// 80 (outer, 72 padded), 144 (outer with sphere_direction) and 128 (inner,
// 51 + 72), in general each width padded to 16; the inner PE stays at 8
// octaves, as in nero_tpu's kernel (light_kernel.py:334).
//
// Forward (lights_fwd_kernel): on the backward's engine (engine.cuh), one
// block of 16 warps per tile of PB = 128 rows (warp w: rows 32(w/4) .. +31,
// columns 64(w%4) .. +63, 64 f32 accumulators a lane). The outer head, then
// (mode both) the inner: the input built in the tile by the row's 4 lanes
// (IDE by the de-Moivre recurrence of encode.cuh, polynomial and NaN-free, so
// it evaluates the unnormalised hit point as the plain version does; PE8),
// W1-W4 streamed as slabs of up to 128 rows through the 2-stage cp.async
// ring, mma.sync, bias and ReLU in registers with each H once into the tile,
// bf16; the output layer on the warps of columns 0-63, its three raw
// outputs f32 straight to out. Rows past N are masked: never read, never
// written.
//
// Backward: the TPU kernel linearises its forward with jax.vjp inside its
// body (:154) and accumulates the parameter cotangents in VMEM across a
// sequential grid; here the gradient is derived by hand in three launches on
// the mma.sync engine of engine.cuh (the engine of csrc/shader.cu's
// backward):
//  * lights_bwd_sweep_kernel, one block of 16 warps per tile of PB = 128
//    rows (warp w: rows 32(w/4) .. +31, columns 64(w%4) .. +63). It
//    recomputes the outer head and then (mode `both`) the inner head: the
//    input built in the tile by the row's 4 lanes (IDE and PE8 of encode.cuh),
//    the products on weight slabs streamed through the 2-stage cp.async ring,
//    bias and ReLU in registers from the accumulators, X and H1-H3 to the
//    scratch once, bf16. Then the reverse sweep, head by head: GZ4 from the
//    head's three cotangent columns, GH = GZ W^T, the ReLU mask from the H
//    the lane wrote, each GZ to the scratch; then dX = GZ1 W1^T only over the
//    input columns that carry a gradient (the inner head's IDE, columns
//    51:123 as the n8-tiles 48:128 at degree 5: PE8 of the traced hit point is detached;
//    all of the outer head's), f32 in shared memory over the tile. dX goes
//    back through the IDE (4 lanes a row, their partial sums added in a fixed
//    order) and the row geometry to d points and d directions: the sphere
//    hit (through the root and the 0.999 clamp of the point), the
//    reflection and the normalisation of -direction. The traced hit points
//    and normals arrive detached and get no gradient.
//  * lights_bwd_params_kernel: every dW = X^T GZ and db (column sums of GZ)
//    of both heads in one launch over (head, layer, 128-row part of the
//    layer's input, row chunk), mma.sync on 128-row stages.
//  * lights_bwd_reduce_kernel adds the chunks' partials in chunk order (no
//    atomics): dW and dB are the same to the bit in every call.
// Rows past N carry zero cotangents: they add nothing.
//
// Bound: tensor-core operations, 2*(di*256 + 2*256*256 + 256*3) per row and
// head forward (0.249 ms in mode `both` at N = 393,216) and about 3x that
// backward (ops/lights.py::bwd_flops_per_row: 0.737 ms), against 72 bytes
// per row. What keeps the forward from it: its phases, one after another.
// Each 128-row tile streams both heads' weights (0.65 MB bf16) from L2 once,
// ~2 GB a launch at N = 393,216, slab by slab through a 2-stage ring that
// one block an SM refills; on the H100 the ring alone takes about 55% of
// the forward's time (kernel_variants.py's ring_only), the tile's inputs
// (the IDE, 4 lanes a row) about 25% (no_inputs), mma.sync and the
// epilogues about 20% (weights_only). What keeps the backward from it: the
// sweep streams the weights twice per 128-row tile, ~4 GB a launch, and
// writes the scratch (6.6 KB a row in mode `both`), which the parameter pass
// reads back (the GZ of a 256-wide layer twice, once for each 128-row part
// of its input).
#include "encode.cuh"
#include "engine.cuh"

using namespace nero;

namespace {

constexpr int HID = 256;
constexpr int DO = 16;   // head outputs padded
constexpr int GEO = 12;  // points, directions, traced hit points, hit normals
constexpr int OUT = 6;   // inner_z 0:3, outer_z 3:6
constexpr int DGEO = 6;  // d points, d directions
constexpr int NPE8 = 51;
constexpr int DI_INNER = (NPE8 + NIDE + 15) / 16 * 16;  // [PE8, IDE], padded
constexpr int DI_OUTER = (NIDE + 15) / 16 * 16;         // IDE, padded
constexpr int DI_OUTER_SPH = (2 * NIDE + 15) / 16 * 16; // 2 x IDE, padded
constexpr int DX0_INNER = NPE8 / 8 * 8;  // the inner head's IDE columns from this n8-tile on
static_assert(HID == LAYER_W, "the engine's layer width");

__host__ __device__ constexpr size_t head_welems(int di) {
  return (size_t)di * HID + 2 * (size_t)HID * HID + (size_t)HID * DO;
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// ---- the row geometry, shared by the forward and the backward ----

// sphere_direction: the point pulled inside the unit sphere (radius 0.999),
// then the ray's exit point hp = sp + d * dist, NOT normalised.
struct SphereRow {
  float sp[3], hp[3], dist, root, norm, disc;
};

__device__ __forceinline__ void sphere_row(const float* p, const float* d, SphereRow& h) {
  h.norm = sqrtf(dot3(p, p));
  for (int k = 0; k < 3; ++k)
    h.sp[k] = h.norm > 0.999f ? p[k] * 0.999f / fmaxf(h.norm, 1e-12f) : p[k];
  const float dtx = dot3(h.sp, d), xtx = dot3(h.sp, h.sp);
  h.disc = dtx * dtx - xtx + 1.0f;
  h.root = sqrtf(fmaxf(h.disc, 0.0f) + 1e-6f);
  h.dist = -dtx + h.root;
  for (int k = 0; k < 3; ++k) h.hp[k] = h.sp[k] + d[k] * h.dist;
}

// cotangent dhp of the exit point -> dp (set), dd (added to). hp = sp + d
// dist, dist = -dtx + sqrt(max(disc, 0) + 1e-6), disc = dtx^2 - xtx + 1,
// dtx = sp.d, xtx = sp.sp; sp = p * 0.999 / |p| where |p| > 0.999, else p.
__device__ __forceinline__ void sphere_row_bwd(const float* p, const float* d, const SphereRow& h,
                                               const float* dhp, float* dp, float* dd) {
  const float d_dist = dot3(dhp, d);
  const float d_disc = h.disc > 0.0f ? d_dist / (2.0f * h.root) : 0.0f;
  const float dtx = dot3(h.sp, d);
  const float d_dtx = -d_dist + 2.0f * dtx * d_disc;
  float dsp[3];
  for (int k = 0; k < 3; ++k) {
    dd[k] += dhp[k] * h.dist + d_dtx * h.sp[k];
    dsp[k] = dhp[k] + d_dtx * d[k] - 2.0f * d_disc * h.sp[k];
  }
  if (h.norm > 0.999f) {
    const float pd = dot3(p, dsp) / (h.norm * h.norm);
    for (int k = 0; k < 3; ++k) dp[k] = 0.999f * (dsp[k] - p[k] * pd) / h.norm;
  } else {
    for (int k = 0; k < 3; ++k) dp[k] = dsp[k];
  }
}

// mode both: n = normalize(hit normal), v = normalize(-d), |-d|, and the
// reflection r = 2 (v.n) n - v
__device__ __forceinline__ void inner_row(const float* normal, const float* d, float* n, float* v,
                                          float* vlen, float* r) {
  float nlen;
  normalize3(normal, n, &nlen);
  const float negd[3] = {-d[0], -d[1], -d[2]};
  normalize3(negd, v, vlen);
  const float nov = dot3(v, n);
  for (int k = 0; k < 3; ++k) r[k] = nov * n[k] * 2.0f - v[k];
}

// ---------------------------------------------------------------------------
// the tile of the engine, the forward's and the backward's
// ---------------------------------------------------------------------------

constexpr int PB = 128;        // rows per tile
constexpr int BTHREADS = 512;  // 16 warps: PB / 32 row groups x NQ column groups
constexpr int LDA = HID + 8;   // input / activation / cotangent tile [PB][LDA] bf16
constexpr int RSB = 28;        // row state floats
static_assert(BTHREADS == 4 * PB, "the per-row phases run 4 lanes a row");
static_assert(BTHREADS / 32 == PB / 32 * NQ, "warps tile the rows and the columns");
static_assert(PW_RS % PB == 0, "the scratch's rows are whole tiles");

// per-row state: geometry, then the backward's gradient accumulators (d
// points, d directions)
enum { B_P = 0, B_D = 3, B_IN = 6, B_N = 9, B_V = 12, B_VLEN = 15, B_R = 16, B_GP = 19,
       B_GD = 22 };

// The layout of one variant: the heads in the packed buffers (inner 0 in
// mode both, outer last), their widths and the columns of their input
// cotangents.
template <bool SPHERE, bool BOTH>
struct LV {
  static constexpr bool sphere = SPHERE, both = BOTH;
  static constexpr int NH = BOTH ? 2 : 1;
  static constexpr int OUTER = NH - 1;
  __host__ __device__ static constexpr bool is_inner(int h) { return BOTH && h == 0; }
  __host__ __device__ static constexpr int di(int h) {
    return is_inner(h) ? DI_INNER : SPHERE ? DI_OUTER_SPH : DI_OUTER;
  }
  __host__ __device__ static constexpr size_t woff(int h) { return h == 0 ? 0 : head_welems(di(0)); }
  __host__ __device__ static constexpr size_t w_total() { return woff(OUTER) + head_welems(di(OUTER)); }
  // first packed output column of the head's raw outputs
  __host__ __device__ static constexpr int col(int h) { return is_inner(h) ? 0 : 3; }
  // input columns dx0 .. dx0 + dxw - 1 get a cotangent: the inner head's IDE
  // (51:123 as the n8-tiles 48:128 at degree 5), all of the outer head's
  __host__ __device__ static constexpr int dx0(int h) { return is_inner(h) ? DX0_INNER : 0; }
  __host__ __device__ static constexpr int dxw(int h) {
    return is_inner(h) ? DI_INNER - DX0_INNER : di(h);
  }
  // the recompute's and the sweep's order: outer, then inner
  __host__ __device__ static constexpr int ev(int i) { return i == 0 ? OUTER : 0; }
  __host__ __device__ static constexpr size_t x_off(int h) { return h == 0 ? 0 : di(0); }
  __host__ __device__ static constexpr size_t x_row() { return x_off(OUTER) + di(OUTER); }
  // the widest dxw (the inner head's is never wider at degrees 1-5)
  static constexpr int DX_OUTER = SPHERE ? DI_OUTER_SPH : DI_OUTER;
  static constexpr int DX_MAX =
      BOTH && DI_INNER - DX0_INNER > DX_OUTER ? DI_INNER - DX0_INNER : DX_OUTER;
  // shared memory of the sweep: the tile (or the f32 dX over it), the ring,
  // row state, IDE table, then the slab table
  static constexpr size_t TILE_BYTES = (size_t)PB * LDA * 2 > (size_t)PB * DX_MAX * 4
                                           ? (size_t)PB * LDA * 2 : (size_t)PB * DX_MAX * 4;
};

// Scratch of the backward (bf16, in pieces) for M rows: X of every head
// (width di), H[head][3][M][256] (layers 1-3 as the recompute formed them),
// GZ[head][3][M][256], GZ4[head][M][16].
template <class L>
struct Scratch {
  bf16* base;
  size_t M;
  __host__ __device__ Scratch(bf16* b, size_t m) : base(b), M(m) {}
  __host__ __device__ bf16* x(int h) const { return base + M * L::x_off(h); }
  __host__ __device__ bf16* hid(int h, int l) const {
    return base + M * L::x_row() + ((size_t)h * 3 + l) * M * HID;
  }
  __host__ __device__ bf16* gz(int h, int l) const { return hid(L::NH + h, l); }
  __host__ __device__ bf16* gz4(int h) const { return hid(2 * L::NH, 0) + (size_t)h * M * DO; }
  __host__ __device__ static size_t elems(size_t m) {
    return m * L::x_row() + 6 * (size_t)L::NH * m * HID + (size_t)L::NH * m * DO;
  }
};

// Slab s of the stream: the recompute's W1 W2 W3 of every head in order, in
// slabs of SLAB_K rows (the output layer's product is not needed); then the
// sweep's W4^T, W3^T, W2^T and W1^T (its rows dx0 .. dx0 + dxw - 1) of each
// head, in slabs of SLAB_K of their output columns (W4: its 16) with all
// their input rows. rows = 0 past the end.
template <class L>
__device__ __forceinline__ Slab slab_at(int s) {
#pragma unroll
  for (int i = 0; i < L::NH; ++i) {
    const int h = L::ev(i), di = L::di(h);
    const int n1 = (di + SLAB_K - 1) / SLAB_K;
    const size_t w = L::woff(h);
    if (s < n1) return {w + (size_t)s * SLAB_K * HID, min(SLAB_K, di - s * SLAB_K), HID, HID, LDB};
    if (s < n1 + 2 * HS) {
      const int l = 1 + (s - n1) / HS, j = (s - n1) % HS;
      return {layer_woff(w, di, l) + (size_t)j * SLAB_K * HID, SLAB_K, HID, HID, LDB};
    }
    s -= n1 + 2 * HS;
  }
#pragma unroll
  for (int i = 0; i < L::NH; ++i) {
    const int h = L::ev(i), di = L::di(h);
    const size_t w = L::woff(h);
    if (s == 0) return {layer_woff(w, di, 3), HID, DO, DO, LDT};
    if (s < 1 + 3 * HS) {
      const int l = 2 - (s - 1) / HS, j = (s - 1) % HS;  // W3, W2, W1
      if (l == 0)
        return {w + (size_t)L::dx0(h) * HID + (size_t)j * SLAB_K, L::dxw(h), SLAB_K, HID, LDT};
      return {layer_woff(w, di, l) + (size_t)j * SLAB_K, HID, SLAB_K, HID, LDT};
    }
    s -= 1 + 3 * HS;
  }
  return {0, 0, 0, 0, 0};
}

template <class L>
__host__ __device__ constexpr int n_slabs() {
  int c = 0;
  for (int h = 0; h < L::NH; ++h) c += (L::di(h) + SLAB_K - 1) / SLAB_K + 2 * HS + 1 + 3 * HS;
  return c;
}

template <class L>
constexpr size_t b_smem() {
  return L::TILE_BYTES + (size_t)STAGES * STAGE_ELEMS * 2 + (size_t)PB * RSB * 4 + TAB * 4 +
         (size_t)n_slabs<L>() * sizeof(SlabRec);
}

// Slab s of the forward's stream: W1-W4 of every head in the recompute's
// order, in slabs of up to SLAB_K rows (W4: two of SLAB_K rows x its 16
// columns). Not a prefix of slab_at's, whose recompute has no W4. rows = 0
// past the end.
template <class L>
__device__ __forceinline__ Slab fwd_slab_at(int s) {
#pragma unroll
  for (int i = 0; i < L::NH; ++i) {
    const int h = L::ev(i), di = L::di(h);
    const int n1 = (di + SLAB_K - 1) / SLAB_K;
    const size_t w = L::woff(h);
    if (s < n1) return {w + (size_t)s * SLAB_K * HID, min(SLAB_K, di - s * SLAB_K), HID, HID, LDB};
    if (s < n1 + 3 * HS) {
      const int l = 1 + (s - n1) / HS, j = (s - n1) % HS, nc = l == 3 ? DO : HID;
      return {layer_woff(w, di, l) + (size_t)j * SLAB_K * nc, SLAB_K, nc, nc, LDB};
    }
    s -= n1 + 3 * HS;
  }
  return {0, 0, 0, 0, 0};
}

template <class L>
__host__ __device__ constexpr int n_fwd_slabs() {
  int c = 0;
  for (int h = 0; h < L::NH; ++h) c += (L::di(h) + SLAB_K - 1) / SLAB_K + 3 * HS;
  return c;
}

// shared memory of the forward: the tile, the ring, row state, IDE table,
// then its slab table
template <class L>
constexpr size_t f_smem() {
  return (size_t)PB * LDA * 2 + (size_t)STAGES * STAGE_ELEMS * 2 + (size_t)PB * RSB * 4 +
         TAB * 4 + (size_t)n_fwd_slabs<L>() * sizeof(SlabRec);
}

// The tile's row state, one thread a row: points, directions, traced hit
// points (zeros past n), the gradient accumulators zeroed, and (mode both)
// the inner head's normal, view and reflection.
template <class L>
__device__ __forceinline__ void load_rows(float* rs, const float* __restrict__ geo, int p0, int n) {
  if (threadIdx.x >= PB) return;
  const int r = threadIdx.x;
  float* s = rs + r * RSB;
  float gg[GEO];
  for (int k = 0; k < GEO; ++k) gg[k] = p0 + r < n ? geo[(size_t)(p0 + r) * GEO + k] : 0.0f;
  for (int k = 0; k < 3; ++k) {
    s[B_P + k] = gg[k];
    s[B_D + k] = gg[3 + k];
    s[B_IN + k] = gg[6 + k];
    s[B_GP + k] = 0.0f;
    s[B_GD + k] = 0.0f;
  }
  if (L::both) inner_row(gg + 9, gg + 3, s + B_N, s + B_V, s + B_VLEN, s + B_R);
}

// Head h's input into the tile A, 4 lanes a row: [PE8(traced hit point),
// IDE(reflection)] for the inner head, IDE(direction) [, IDE(sphere exit
// point)] for the outer; zeros in the padding. The forward's and the
// recompute's. Not inlined, as enc_bwd: the per-row phases get registers of
// their own, and the products keep theirs.
template <class L>
__device__ __noinline__ void build_input(int h, bf16* A, const float* rs, const float* tab) {
  const int tid = threadIdx.x, r = tid >> 2, q = tid & 3;
  const float* s = rs + r * RSB;
  bf16* x = A + r * LDA;
  int used;
  if (L::is_inner(h)) {
    for (int c = q; c < NPE8; c += 4) x[c] = to_bf(pe_val(s + B_IN, c));
    ide_row(tab, s[B_R], s[B_R + 1], s[B_R + 2], 0.0f, x + NPE8, 1, q, 4);
    used = NPE8 + NIDE;
  } else {
    ide_row(tab, s[B_D], s[B_D + 1], s[B_D + 2], 0.0f, x, 1, q, 4);
    if (L::sphere) {
      SphereRow sh;
      sphere_row(s + B_P, s + B_D, sh);
      ide_row(tab, sh.hp[0], sh.hp[1], sh.hp[2], 0.0f, x + NIDE, 1, q, 4);
    }
    used = (L::sphere ? 2 : 1) * NIDE;
  }
  for (int c = used + q; c < L::di(h); c += 4) x[c] = to_bf(0.0f);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Both heads on the tile, the outer and then (mode both) the inner: the
// input built in the tile, the four products from the ring, bias and ReLU
// in registers with each H once, bf16, into the tile (the recompute's
// epilogue without its scratch stores: one shared loop made shader.cu's
// sweep spill); the output layer on the warps of columns 0-63, whose
// n8-tiles 0 and 1 hold the 16 padded outputs: z4 + b4 of columns 0-2 to
// the head's raw outputs, f32. Mode outer writes zeros as inner_z. Rows past
// n are read as zeros and never written.
template <class L>
__global__ void __launch_bounds__(BTHREADS, 1)
lights_fwd_kernel(const float* __restrict__ geo, int n, const bf16* __restrict__ W,
                  const float* __restrict__ B, const float* __restrict__ ide_tab,
                  float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int NS = n_fwd_slabs<L>();
  bf16* A = reinterpret_cast<bf16*>(smem_raw);  // inputs, activations [PB][LDA]
  bf16* ring_base = A + PB * LDA;
  float* rs = reinterpret_cast<float*>(ring_base + STAGES * STAGE_ELEMS);  // [PB][RSB]
  float* tab = rs + PB * RSB;
  SlabRec* recs = reinterpret_cast<SlabRec*>(tab + TAB);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp / NQ, cq = warp % NQ;  // row group, column group
  const int g = lane >> 2, t = lane & 3;      // accumulator row and column pair
  const int p0 = blockIdx.x * PB;

  for (int i = tid; i < NS; i += BTHREADS) recs[i] = slab_rec(fwd_slab_at<L>(i));
  for (int i = tid; i < TAB; i += BTHREADS) tab[i] = ide_tab[i];
  load_rows<L>(rs, geo, p0, n);
  __syncthreads();
  Ring ring{ring_base, W, recs, NS, 0};
  for (int st = 0; st < STAGES - 1; ++st) ring.load(st);

  const unsigned a_x = smem_u32(A + (grp * 32 + (lane & 15)) * LDA + (lane >> 4) * 8);
  const int col0 = cq * WN * 8;
  bf16* arow = A + (grp * 32 + g) * LDA + col0 + 2 * t;
  float acc[2][WN][4];

  for (int i = 0; i < L::NH; ++i) {
    const int h = L::ev(i);
    build_input<L>(h, A, rs, tab);
    const float* bh = B + h * 4 * HID;
    for (int l = 0; l < 3; ++l) {
      zero(acc);
      product<false>(acc, ring, a_x, LDA, l == 0 ? L::di(h) : HID, col0, HID - col0);
      __syncthreads();  // every warp is done reading the tile
      // H = relu(z + b) to the tile
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const float2 b2 = *reinterpret_cast<const float2*>(bh + l * HID + col0 + j * 8 + 2 * t);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<__nv_bfloat162*>(arow + (16 * m + 8 * hf) * LDA + j * 8) =
                __floats2bfloat162_rn(fmaxf(acc[m][j][2 * hf] + b2.x, 0.0f),
                                      fmaxf(acc[m][j][2 * hf + 1] + b2.y, 0.0f));
      }
    }
    zero(acc);
    product<false>(acc, ring, a_x, LDA, HID, col0, DO - col0);
    __syncthreads();  // every warp is done reading H3: the next head's input goes over it
    if (cq == 0 && t < 2) {  // columns c, c + 1 of the head's three
      const int c = 2 * t;
      const float b0 = bh[3 * HID + c], b1 = bh[3 * HID + c + 1];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = p0 + grp * 32 + 16 * m + 8 * hf + g;
          if (row >= n) continue;
          float* o = out + (size_t)row * OUT;
          o[L::col(h) + c] = acc[m][0][2 * hf] + b0;
          if (c + 1 < 3) o[L::col(h) + c + 1] = acc[m][0][2 * hf + 1] + b1;
          if (!L::both) {
            o[c] = 0.0f;
            if (c + 1 < 3) o[c + 1] = 0.0f;
          }
        }
    }
  }
}

template <class L>
int launch_fwd(const float* geo, int n, const bf16* W, const float* B, const float* tab,
               float* out, cudaStream_t stream) {
  static_assert(f_smem<L>() <= b_smem<L>() && b_smem<L>() <= 232448, "forward shared memory");
  const cudaError_t err = cudaFuncSetAttribute(
      lights_fwd_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)f_smem<L>());
  if (err != cudaSuccess) return (int)err;
  lights_fwd_kernel<L><<<(n + PB - 1) / PB, BTHREADS, f_smem<L>(), stream>>>(geo, n, W, B, tab,
                                                                             out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward: recompute and reverse sweep
// ---------------------------------------------------------------------------

// The tile's input to the scratch, 16 bytes a copy.
__device__ __forceinline__ void store_x(const bf16* A, bf16* Xg, int di, size_t row0) {
  const int cb = di / 8;
  for (int v = threadIdx.x; v < PB * cb; v += BTHREADS) {
    const int r = v / cb, c = (v % cb) * 8;
    *reinterpret_cast<uint4*>(Xg + piece_off(row0 + r, c, di)) =
        *reinterpret_cast<const uint4*>(A + r * LDA + c);
  }
}

// The backward of head h's encodings from its input cotangent D [PB][dxw]
// (f32, columns dx0 ..), 4 lanes a row, into the row's gradient
// accumulators (added by the row's lane 0: the outer head's first, then the
// inner head's).
template <class L>
__device__ __noinline__ void enc_bwd(int h, const float* D, float* rs, const float* tab) {
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  float* s = rs + r * RSB;
  const float* g = D + r * L::dxw(h);
  if (L::is_inner(h)) {
    // IDE(reflection) -> view -> direction; r = 2 (v.n) n - v, n detached,
    // v = normalize(-d)
    float dr[3] = {0.0f, 0.0f, 0.0f};
    ide_row_bwd(tab, s[B_R], s[B_R + 1], s[B_R + 2], 0.0f, g + (NPE8 - L::dx0(h)), dr, q, 4);
    row_sum3(dr);
    if (q == 0) {
      const float* nn = s + B_N;
      const float ndr = dot3(nn, dr);
      float dv[3], dneg[3];
      for (int k = 0; k < 3; ++k) dv[k] = 2.0f * ndr * nn[k] - dr[k];
      normalize3_bwd(s + B_V, s[B_VLEN], dv, dneg);
      for (int k = 0; k < 3; ++k) s[B_GD + k] -= dneg[k];
    }
  } else {
    // IDE(direction) and IDE(sphere exit point) back to the point and the direction
    float dd[3] = {0.0f, 0.0f, 0.0f}, dp[3] = {0.0f, 0.0f, 0.0f};
    ide_row_bwd(tab, s[B_D], s[B_D + 1], s[B_D + 2], 0.0f, g, dd, q, 4);
    row_sum3(dd);
    if (L::sphere) {
      SphereRow sh;
      sphere_row(s + B_P, s + B_D, sh);
      float dhp[3] = {0.0f, 0.0f, 0.0f};
      ide_row_bwd(tab, sh.hp[0], sh.hp[1], sh.hp[2], 0.0f, g + NIDE, dhp, q, 4);
      row_sum3(dhp);
      sphere_row_bwd(s + B_P, s + B_D, sh, dhp, dp, dd);
    }
    if (q == 0)
      for (int k = 0; k < 3; ++k) {
        s[B_GP + k] += dp[k];
        s[B_GD + k] += dd[k];
      }
  }
}

template <class L>
__global__ void __launch_bounds__(BTHREADS, 1)
lights_bwd_sweep_kernel(const float* __restrict__ geo, int n, const bf16* __restrict__ W,
                        const float* __restrict__ B, const float* __restrict__ ide_tab,
                        const float* __restrict__ gout, float* __restrict__ dgeo,
                        bf16* __restrict__ scratch, int m_rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* A = reinterpret_cast<bf16*>(smem_raw);  // inputs, activations, cotangents [PB][LDA]
  float* D = reinterpret_cast<float*>(smem_raw);  // a head's input cotangent [PB][dxw], over A
  bf16* ring_base = reinterpret_cast<bf16*>(smem_raw + L::TILE_BYTES);
  float* rs = reinterpret_cast<float*>(ring_base + STAGES * STAGE_ELEMS);  // [PB][RSB]
  float* tab = rs + PB * RSB;
  SlabRec* recs = reinterpret_cast<SlabRec*>(tab + TAB);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp / NQ, cq = warp % NQ;  // row group, column group
  const int g = lane >> 2, t = lane & 3;      // accumulator row and column pair
  const int p0 = blockIdx.x * PB;
  const size_t row0 = (size_t)p0;
  const Scratch<L> S(scratch, (size_t)m_rows);

  for (int i = tid; i < n_slabs<L>(); i += BTHREADS) recs[i] = slab_rec(slab_at<L>(i));
  for (int i = tid; i < TAB; i += BTHREADS) tab[i] = ide_tab[i];
  load_rows<L>(rs, geo, p0, n);
  __syncthreads();
  Ring ring{ring_base, W, recs, n_slabs<L>(), 0};
  for (int st = 0; st < STAGES - 1; ++st) ring.load(st);

  const unsigned a_x = smem_u32(A + (grp * 32 + (lane & 15)) * LDA + (lane >> 4) * 8);
  const int col0 = cq * WN * 8;
  const size_t go = piece_off(row0 + grp * 32 + g, col0 + 2 * t, HID);
  bf16* arow = A + (grp * 32 + g) * LDA + col0 + 2 * t;
  float acc[2][WN][4];

  // ---- recompute: both heads forward, X and H to the scratch ----
  for (int i = 0; i < L::NH; ++i) {
    const int h = L::ev(i), di = L::di(h);
    build_input<L>(h, A, rs, tab);
    store_x(A, S.x(h), di, row0);
    const float* bh = B + h * 4 * HID;
    for (int l = 0; l < 3; ++l) {
      zero(acc);
      product<false>(acc, ring, a_x, LDA, l == 0 ? di : HID, col0, HID - col0);
      __syncthreads();  // every warp is done reading the tile
      // H = relu(z + b): to the tile and the scratch
      bf16* hg = S.hid(h, l) + go;
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const float2 b2 = *reinterpret_cast<const float2*>(bh + l * HID + col0 + j * 8 + 2 * t);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const __nv_bfloat162 v =
                __floats2bfloat162_rn(fmaxf(acc[m][j][2 * hf] + b2.x, 0.0f),
                                      fmaxf(acc[m][j][2 * hf + 1] + b2.y, 0.0f));
            *reinterpret_cast<__nv_bfloat162*>(arow + (16 * m + 8 * hf) * LDA + j * 8) = v;
            *reinterpret_cast<__nv_bfloat162*>(hg + (2 * m + hf) * F_S + j * F_J) = v;
          }
      }
    }
  }
  __syncthreads();  // the last H is in the tile: the sweep's GZ4 goes over it

  // ---- reverse sweep, head by head ----
  for (int i = 0; i < L::NH; ++i) {
    const int h = L::ev(i);
    {  // GZ4: the cotangent of the head's three packed outputs
      const int r = tid >> 2, c = (tid & 3) * 4;
      float v[4];
      for (int k = 0; k < 4; ++k)
        v[k] = p0 + r < n && c + k < 3 ? gout[(size_t)(p0 + r) * OUT + L::col(h) + c + k] : 0.0f;
      const __nv_bfloat162 v01 = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 v23 = __floats2bfloat162_rn(v[2], v[3]);
      __nv_bfloat162* a2 = reinterpret_cast<__nv_bfloat162*>(A + r * LDA + c);
      a2[0] = v01;
      a2[1] = v23;
      __nv_bfloat162* g2 = reinterpret_cast<__nv_bfloat162*>(S.gz4(h) + piece_off(row0 + r, c, DO));
      g2[0] = v01;
      g2[1] = v23;
    }
    for (int l = 2; l >= 0; --l) {
      // the cotangent of H_l: GH = GZ_{l+1} @ W_{l+1}^T; then the ReLU mask
      zero(acc);
      product<true>(acc, ring, a_x, LDA, l == 2 ? DO : HID, col0, HID - col0);
      __syncthreads();  // every warp is done reading the cotangent tile
      const bf16* hl = S.hid(h, l) + go;
      bf16* gzl = S.gz(h, l) + go;
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float2 hv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(hl + (2 * m + hf) * F_S + j * F_J));
            const __nv_bfloat162 v =
                __floats2bfloat162_rn(hv.x > 0.0f ? acc[m][j][2 * hf] : 0.0f,
                                      hv.y > 0.0f ? acc[m][j][2 * hf + 1] : 0.0f);
            *reinterpret_cast<__nv_bfloat162*>(gzl + (2 * m + hf) * F_S + j * F_J) = v;
            *reinterpret_cast<__nv_bfloat162*>(arow + (16 * m + 8 * hf) * LDA + j * 8) = v;
          }
    }
    // dX = GZ1 @ W1^T over the input columns dx0 .. dx0 + dxw - 1
    const int dxw = L::dxw(h);
    zero(acc);
    product<true>(acc, ring, a_x, LDA, HID, col0, dxw - col0);
    __syncthreads();  // every warp is done reading GZ1: the tile becomes D
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      const int c = col0 + j * 8 + 2 * t;
      if (c >= dxw) break;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(D + (grp * 32 + 16 * m + 8 * hf + g) * dxw + c) =
              make_float2(acc[m][j][2 * hf], acc[m][j][2 * hf + 1]);
    }
    __syncthreads();
    enc_bwd<L>(h, D, rs, tab);
    __syncthreads();  // before the next head's GZ4 goes over the tile
  }

  if (tid < PB && p0 + tid < n) {
    const float* s = rs + tid * RSB;
    float* d = dgeo + (size_t)(p0 + tid) * DGEO;
    for (int k = 0; k < 3; ++k) {
      d[k] = s[B_GP + k];
      d[3 + k] = s[B_GD + k];
    }
  }
}

// ---------------------------------------------------------------------------
// backward: weight and bias gradients
// ---------------------------------------------------------------------------

// The parameter pass's table: per head its layer-1 input in 128-row parts,
// then two each of layers 2-4; X and GZ from the scratch.
template <class L>
struct PwTab {
  __host__ __device__ static constexpr int head_items(int h) { return (L::di(h) + 127) / 128 + 6; }
  __host__ __device__ static constexpr int n_items() {
    int c = 0;
    for (int h = 0; h < L::NH; ++h) c += head_items(h);
    return c;
  }
  __host__ __device__ static constexpr size_t w_total() { return L::w_total(); }
  // floats of one chunk's partials: dW (packed), then dB [heads][4][256]
  __host__ __device__ static constexpr size_t part_row() {
    return L::w_total() + (size_t)L::NH * 4 * HID;
  }
  __device__ static PwTile tile(int t, bf16* scratch, size_t M) {
    const Scratch<L> S(scratch, M);
#pragma unroll
    for (int h = 0; h < L::NH; ++h) {
      const int n = head_items(h);
      if (t < n) {
        const int di = L::di(h), n1 = n - 6;
        const int l = t < n1 ? 0 : 1 + (t - n1) / 2, it = t < n1 ? t : (t - n1) % 2;
        const int xw = l == 0 ? di : HID, ldo = l == 3 ? DO : HID;
        return {l == 0 ? S.x(h) : S.hid(h, l - 1), l == 3 ? S.gz4(h) : S.gz(h, l), xw, 16 * it,
                min(16, xw / 8 - 16 * it), ldo / 8,
                layer_woff(L::woff(h), di, l) + (size_t)it * 128 * ldo, ldo,
                it == 0 ? h * 4 + l : -1};
      }
      t -= n;
    }
    return {};
  }
};

template <class L>
__global__ void __launch_bounds__(PW_THREADS, 1)
lights_bwd_params_kernel(bf16* __restrict__ scratch, int m_rows, int rows_per_chunk,
                         float* __restrict__ part) {
  param_pass(PwTab<L>{}, scratch, m_rows, rows_per_chunk, part);
}

template <class L>
__global__ void lights_bwd_reduce_kernel(const float* __restrict__ part, int n_chunks,
                                         float* __restrict__ dW, float* __restrict__ dB) {
  reduce_chunks(PwTab<L>{}, part, n_chunks, dW, dB);
}

// rows of the backward's scratch: n rounded up to the parameter pass's stage
inline int bwd_rows(int n) { return (n + PW_RS - 1) / PW_RS * PW_RS; }

template <class L>
int launch_bwd_sweep(const float* geo, int n, const bf16* W, const float* B, const float* tab,
                     const float* gout, float* dgeo, bf16* scratch, cudaStream_t stream) {
  static_assert(b_smem<L>() <= 232448, "sweep shared memory");
  const cudaError_t err = cudaFuncSetAttribute(
      lights_bwd_sweep_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b_smem<L>());
  if (err != cudaSuccess) return (int)err;
  const int m = bwd_rows(n);
  lights_bwd_sweep_kernel<L><<<m / PB, BTHREADS, b_smem<L>(), stream>>>(
      geo, n, W, B, tab, gout, dgeo, scratch, m);
  return (int)cudaGetLastError();
}

template <class L>
int launch_bwd_params(int n, bf16* scratch, float* part, float* dW, float* dB,
                      cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      lights_bwd_params_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)PW_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int m = bwd_rows(n), n_chunks = pw_chunks(m);
  lights_bwd_params_kernel<L><<<dim3(PwTab<L>::n_items(), n_chunks), PW_THREADS, PW_SMEM, stream>>>(
      scratch, m, pw_chunk_rows(m), part);
  lights_bwd_reduce_kernel<L><<<(unsigned)((PwTab<L>::part_row() + 255) / 256), 256, 0, stream>>>(
      part, n_chunks, dW, dB);
  return (int)cudaGetLastError();
}

// call fn<LV<sphere, both>>(args...) for the runtime variant
#define LIGHTS_DISPATCH(fn, sphere, both, ...)                    \
  ((sphere) ? ((both) ? fn<LV<true, true>>(__VA_ARGS__)           \
                      : fn<LV<true, false>>(__VA_ARGS__))         \
            : ((both) ? fn<LV<false, true>>(__VA_ARGS__)          \
                      : fn<LV<false, false>>(__VA_ARGS__)))

template <class L> size_t scratch_elems_of(int n) {
  return Scratch<L>::elems((size_t)bwd_rows(n));
}
template <class L> size_t part_elems_of(int n) {
  return (size_t)pw_chunks(bwd_rows(n)) * PwTab<L>::part_row();
}

}  // namespace

extern "C" {

int lights_tile() { return PB; }
size_t lights_weight_elems(int sphere, int both) {
  return head_welems(sphere ? DI_OUTER_SPH : DI_OUTER) + (both ? head_welems(DI_INNER) : 0);
}
// bf16 elements of the backward's scratch, floats of its partials, for n rows
size_t lights_scratch_elems(int n, int sphere, int both) {
  return LIGHTS_DISPATCH(scratch_elems_of, sphere, both, n);
}
size_t lights_part_elems(int n, int sphere, int both) {
  return LIGHTS_DISPATCH(part_elems_of, sphere, both, n);
}

// geo [n,12] (points, directions, traced hit points, hit normals); W packed
// bf16 heads ([inner] outer); B [heads][4][256] f32; tab = IDE table;
// out [n,6] (inner_z, outer_z; inner_z zeros unless `both`).
int lights_fwd(const float* geo, int n, const bf16* W, const float* B, const float* tab,
               int sphere, int both, float* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  return LIGHTS_DISPATCH(launch_fwd, sphere, both, geo, n, W, B, tab, out, stream);
}

// The backward's first part: recompute and reverse sweep, gout [n,6] ->
// dgeo [n,6] (d points, d directions), and the scratch
// (lights_scratch_elems bf16) for the second.
int lights_bwd_sweep(const float* geo, int n, const bf16* W, const float* B, const float* tab,
                     int sphere, int both, const float* gout, float* dgeo, bf16* scratch,
                     cudaStream_t stream) {
  if (n <= 0) return 0;
  return LIGHTS_DISPATCH(launch_bwd_sweep, sphere, both, geo, n, W, B, tab, gout, dgeo, scratch,
                         stream);
}

// The second: dW (packed layout, f32) and dB [heads][4][256] from the
// scratch; part holds lights_part_elems floats.
int lights_bwd_params(int n, int sphere, int both, bf16* scratch, float* part, float* dW,
                      float* dB, cudaStream_t stream) {
  if (n <= 0) return 0;
  return LIGHTS_DISPATCH(launch_bwd_params, sphere, both, n, scratch, part, dW, dB, stream);
}

// Both parts, three launches. With no rows nothing is launched: dW and dB
// stay as the caller made them.
int lights_bwd(const float* geo, int n, const bf16* W, const float* B, const float* tab,
               int sphere, int both, const float* gout, float* dgeo, bf16* scratch, float* part,
               float* dW, float* dB, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int rc = lights_bwd_sweep(geo, n, W, B, tab, sphere, both, gout, dgeo, scratch, stream);
  if (rc) return rc;
  return lights_bwd_params(n, sphere, both, scratch, part, dW, dB, stream);
}

}  // extern "C"
