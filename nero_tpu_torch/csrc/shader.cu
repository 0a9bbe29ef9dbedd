// Whole Stage-I appearance shader, forward and backward, for Hopper (sm_90a).
//
// Replaces nero_tpu/ops/pallas/shader_kernel.py::shader_fused_raw (:552),
// pallas_calls nero_shader_fwd_f* (:467) and nero_shader_bwd_f* (:494), in
// all four variants: the kernels are templates on <SPHERE, HUMAN>
// (sphere_direction, :289-314; human_light, _human_block :219-255), so the
// default variant compiles to the code it had before the other three existed.
//
// Forward (shader_fwd_kernel): one block of 16 warps per tile of PB = 128
// rows; warp w owns rows 32(w/4) .. +31 and columns 64(w%4) .. +63 as two
// m16n8k16 row tiles and 8 n8-tiles (64 f32 accumulators a lane). Per row:
// normalize normal and view, NoV, reflective. Then the 7 (human: 8) head
// evaluations in order (materials, outer light on the normal and on the
// reflective direction, inner light, occ [, human]), each with
// the evaluation's input built in the activation tile by build_slot, 4 lanes
// a row (IDE(normal, 1), IDE(reflective, sigmoid(roughness_z)) by the
// de-Moivre recurrence of utils/encodings.py, polynomial and NaN-free;
// PE(pts, 8), PE(reflective, 6), the sphere hit, the human IPE; the material
// input's 3 point columns in a narrow points tile), the four 256-wide layers
// on mma.sync with B fragments by ldmatrix.trans from weight slabs of up to
// 128 rows that a 2-stage cp.async ring brings from L2 (the slab table holds
// W1-W4 of every evaluation in order), bias and ReLU in registers with each H
// written once, bf16, into the tile; layer 4 on the warps of columns 0-63,
// whose first 16 are the padded outputs: f32 bias added, the evaluation's
// raw outputs to the packed [N, 24] of shader_kernel.py:262-265, and after the
// roughness head kappa = sigmoid(z) into the row state. The tail writes
// reflective, NoV and zeros, or (human) the hit mask in column 23. Rows past
// N are masked (never read, never written), not padded.
//
// Backward: the TPU kernel linearises its forward with jax.vjp inside the
// kernel body (shader_kernel.py:373) and keeps the tile's activations in
// VMEM; a Hopper block has 227 KB and blocks run in no order, so the
// gradient is derived by hand in two kernels and a reduction, three launches,
// on the mma.sync engine of csrc/sdf_grad.cu:
//  * shader_bwd_sweep_kernel, one block of 16 warps per tile of PB = 128
//    rows; warp w owns rows 32(w/4) .. +31 and columns 64(w%4) .. +63 as two
//    m16n8k16 row tiles and 8 n8-tiles (64 f32 accumulators a lane). The
//    weights are one stream of [in, out] bf16 slabs of up to 128 rows (the
//    recompute, B fragments by ldmatrix.trans) or of 128 output columns with
//    all input rows (the sweep: plain ldmatrix gives W^T's fragments),
//    staged by 16-byte cp.async copies through a 2-stage ring. The recompute
//    runs the 7 (human: 8) head evaluations forward, each head's input built
//    in place in the activation tile (the 272-wide [feats, pts] as the feats
//    there and the 3 point columns, padded to 16, in a narrow tile: two
//    products into the same sums); bias and ReLU in registers, each H once,
//    bf16, into the tile and to the scratch, and each input slot X to the
//    scratch. The reverse sweep, in the order human, occ, inner, outer_r,
//    outer_n, materials 1, 0, 2: GZ4 from the cotangent of the packed
//    outputs, GH = GZ @ W^T, the ReLU mask from the H the lane wrote, GZ to
//    the scratch and to the tile, then dX = GZ1 @ W1^T (not for the occ head,
//    whose inputs are stop-gradient, shader_kernel.py:321). A dX of the light
//    heads goes, f32, over the activation and points tiles, and its
//    encodings' backward runs on all 512 threads, 4 lanes a row (IDE in
//    direction and kappa, PE, the sphere hit, the human IPE), the lanes'
//    partial sums added in a fixed order. The kappa cotangents are summed
//    before the roughness head's sweep; d_feats adds the material heads' dX
//    in the order 1, 0, 2 (the same every run), their point columns on the
//    CUDA cores. Then the reflection, NoV and both normalisations per row.
//  * shader_bwd_params_kernel: every dW = X^T GZ and db (column sums of GZ)
//    in one launch over (head, layer, 128-row part of the layer's input, row
//    chunk), mma.sync on stages of 128 rows through a 2-stage cp.async ring;
//    the outer head's two evaluations go into one partial, db rides in the
//    blocks of an input's first part.
//  * shader_bwd_reduce_kernel adds the chunks' partials in chunk order (no
//    atomics: the same gradients every run) into dW and dB.
// The scratch lies in pieces of 8 rows x 8 columns (piece_off), so the
// sweep's stores and loads and the parameter pass's copies are whole
// 128-byte runs. Rows past N carry zero cotangents: they add nothing.
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
// (shader_kernel.py::_flops_per_row) and 3x that backward: 0.16-0.18 ms
// forward and 0.48-0.55 ms backward at N = 65,536. What keeps them from it
// (PERF.md, kernel_variants.py --kernel shader): every tile streams all the
// head weights from L2 through the ring (2.5 MB a tile in the default
// variant, the backward twice), so a 128-row tile halves the stream per row
// against 64; in the forward the ring alone takes a third of the launch, and
// the block's phases (input slot, products, epilogue) run one after another
// in a block that fills the SM. The backward also moves the scratch (X, H,
// GZ: 1.5 GB at N = 65,536, 1.7 GB with the human head), which the parameter
// pass reads back (X and H once, GZ once for each 128-row part of a layer's
// input).
//
// Two loops on one engine: the forward's head loop is the backward's
// recompute without the scratch stores of X and H, plus the packed outputs.
// As one force-inlined function templated on the stores, the sphere
// variants' sweep spilled (ptxas -v); with a loop of its own in each kernel,
// and the lane's scratch offset in 32 bits, no kernel spills. The per-row
// phases (build_slot, enc_bwd) are calls of their own for the same reason:
// inlined, the sphere variants' sweep spilled.
//
// Encoding widths: the IDE degree (ide_deg, encode.cuh's NERO_IDE_DEG) and
// the octaves of the light points' PE (light_pos_freq, NERO_LIGHT_PE, 8
// unless given; 0-128, octave i's frequency an exact f32 2^i) are the
// build's; ops/shader.py builds one library per pair that a configuration
// asks for. At degree 5 and PE 8 the head inputs are 80 (outer, 72 padded;
// 144 with SPHERE), 128 (inner, 51 + 72) and 96 (occ, 51 + 39); in general
// each is its width padded to 16. Where the widest light input cotangent
// exceeds 144 columns (degree 5 with PE 12-30) its f32 staging outgrows the
// activation and points tiles: the tile region grows to hold it and the ring
// takes 64-row slabs to make room. Where a light head's input outgrows the
// 256-column activation tile (WIDE: degree 5 from PE 31 on, 464 columns at
// PE 64), every encoding column being a function of its own row, the inner
// and occ heads' inputs are built in 256-column windows of the tile, each
// window against its W1 slabs as the ring brings them (build_window; the
// recompute stores each window to the scratch), and the inner head's dX
// comes DXP = 128 columns at a time: a piece of W1^T from the ring, its f32
// staging over the tiles, the PE and IDE backward of its columns added into
// the row state in piece order (enc_bwd_piece), GZ1 reloaded from the
// scratch for the next piece. Shared memory is then what it is at PE 8:
// 128-row slabs, the tile region of the activation and points tiles.
#include "encode.cuh"
#include "mma.cuh"

#ifndef NERO_LIGHT_PE
#define NERO_LIGHT_PE 8
#endif

using namespace nero;

namespace {

constexpr int NTHREADS = 512;
constexpr int HID = 256;
constexpr int DO = 16;       // head outputs padded
constexpr int OUT = 24;      // packed raw outputs
constexpr int DGEO = 9;     // d pts, d normal, d view
constexpr int LIGHT_PE = NERO_LIGHT_PE;  // PE octaves of the light points (light_pos_freq)
constexpr int NPEL = 3 + 6 * LIGHT_PE;
constexpr int NPE6 = 39;
// the light heads' padded input widths, and the widest input cotangent of a
// light head (f32)
constexpr int DI_OUTER = (NIDE + 15) / 16 * 16;
constexpr int DI_OUTER_SPH = (2 * NIDE + 15) / 16 * 16;
constexpr int DI_INNER = (NPEL + NIDE + 15) / 16 * 16;
constexpr int DI_OCC = (NPEL + NPE6 + 15) / 16 * 16;
constexpr int DX_MAX = DI_OUTER_SPH > DI_INNER ? DI_OUTER_SPH : DI_INNER;
// WIDE: a light head's input outgrows the activation tile; the inner head's
// input cotangent is then staged DXP columns at a time
constexpr int DI_LIGHT = DI_INNER > DI_OCC ? DI_INNER : DI_OCC;
constexpr bool WIDE = DI_LIGHT > HID;
constexpr int DXP = 128;
constexpr int DX_WIDE = DI_OUTER_SPH > DXP ? DI_OUTER_SPH : DXP;
// the f32 input cotangent staged at once (a light head's, or a DXP piece)
constexpr int DX_STAGE = DI_LIGHT > HID ? DX_WIDE : DX_MAX;
// past octave 127 the frequency 2^i is no finite f32
static_assert(LIGHT_PE >= 0 && LIGHT_PE <= 128, "light PE octaves 0-128");

enum { H_MET = 0, H_ROUGH, H_ALB, H_OUTER, H_INNER, H_OCC, H_HUMAN };

// The layout of one variant: heads, head evaluations and input slots.
template <bool SPHERE, bool HUMAN>
struct Var {
  static constexpr bool sphere = SPHERE, human = HUMAN;
  static constexpr int NHEADS = HUMAN ? 7 : 6;
  static constexpr int NEVAL = HUMAN ? 8 : 7;
  static constexpr int NSLOT = HUMAN ? 6 : 5;
  static constexpr int GEO = HUMAN ? 21 : 9;  // pts, normal, view [, R row-major, t]
  // input width per head, padded to a tile multiple: [feats,pts] 259, IDE
  // (twice with SPHERE), [PE(pts), IDE], [PE(pts), PE6(refl)], IPE 24
  __host__ __device__ static constexpr int head_di(int h) {
    return h <= H_ALB ? 272 : h == H_OUTER ? (SPHERE ? DI_OUTER_SPH : DI_OUTER)
         : h == H_INNER ? DI_INNER : h == H_OCC ? DI_OCC : 32;
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
    return s == 0 ? 272 : s <= 2 ? (SPHERE ? DI_OUTER_SPH : DI_OUTER) : s == 3 ? DI_INNER
         : s == 4 ? DI_OCC : 32;
  }
  __host__ __device__ static constexpr size_t slot_off(int s) {  // per-row offset of slot s
    size_t off = 0;
    for (int i = 0; i < s; ++i) off += slot_di(i);
    return off;
  }
  __host__ __device__ static constexpr size_t w_total() { return head_off(NHEADS); }
  __host__ __device__ static constexpr size_t x_row() { return slot_off(NSLOT); }
};

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

// IPE, octaves lane, lane + nlanes, ... of 0..5: enc[2 i + k] = E[sin],
// enc[12 + 2 i + k] = E[cos]
template <typename T>
__device__ void human_ipe(const HumanRow& h, T* enc, int lane, int nlanes) {
  for (int i = lane; i < 6; i += nlanes) {
    const float s = pow2f(i);
    const float att = expf(-0.5f * h.var * s * s);
    for (int k = 0; k < 2; ++k) {
      store_as(enc + 2 * i + k, att * sinf(h.mean[k] * s));
      store_as(enc + 12 + 2 * i + k, att * cosf(h.mean[k] * s));
    }
  }
}

// ---------------------------------------------------------------------------
// the engine of both directions: 128-row tiles, the weight ring, mma.sync
// ---------------------------------------------------------------------------

constexpr int PB = 128;                  // rows per tile
constexpr int WN = 8;                    // n8-tiles a warp holds: 64 columns
constexpr int NQ = HID / (8 * WN);       // column groups
constexpr int LDA = HID + 8;             // activation / cotangent tile [PB][LDA] bf16
constexpr int PTW = 16;                  // the material input's columns 256-271: 3 points, padded
constexpr int LDP = PTW + 8;             // points tile [PB][LDP] bf16
constexpr int SLAB_K = DX_STAGE > 144 ? 64 : 128;  // weight rows (recompute) or columns (sweep) per slab
constexpr int LDB = HID + 8;             // recompute slab [SLAB_K][LDB] bf16
constexpr int LDT = SLAB_K + 8;          // sweep slab [HID][LDT] bf16
constexpr int STAGES = 2;
constexpr int STAGE_ELEMS = SLAB_K * LDB > HID * LDT ? SLAB_K * LDB : HID * LDT;
constexpr int HS = HID / SLAB_K;         // slabs of a 256-row (recompute) or -column (sweep) layer
constexpr int RSB = 28;                  // row state floats
// the activation and points tiles, or (the sweep) a light head's f32 dX
// over them: bf16 elements
constexpr int TILE_ELEMS = PB * (LDA + LDP) > PB * DX_STAGE * 2 ? PB * (LDA + LDP) : PB * DX_STAGE * 2;
// shared memory of both kernels: tiles, ring, row state, IDE table, then the slab table
constexpr size_t B_SMEM0 = ((size_t)TILE_ELEMS + (size_t)STAGES * STAGE_ELEMS) * 2 +
                           (size_t)PB * RSB * 4 + TAB * 4;
static_assert(NTHREADS == 4 * PB, "the per-row phases run 4 lanes a row");

// per-row state: geometry, then the backward's gradient accumulators (d pts,
// d normal, d reflective, d kappa) and the forward's human hit mask
enum { B_PTS = 0, B_N = 3, B_V = 6, B_R = 9, B_NOV = 12, B_KAPPA = 13, B_NLEN = 14,
       B_VLEN = 15, B_GPTS = 16, B_GN = 19, B_GR = 22, B_GKAPPA = 25, B_HIT = 26 };

// The scratch lies in device memory in pieces, not rows: a piece is 8 rows x
// 8 columns (128 bytes), a group of 32 rows of width W is its W / 8 column
// blocks of four pieces (rows 0-7, 8-15, 16-23, 24-31) in order, the groups
// in row order. Element (row r, column c) of a width-W array is at
// piece_off(r, c, W). A warp's accumulators hold whole pieces, so its stores
// and loads of one (n8-tile, 8 rows) are 128 contiguous bytes; a stage of
// the parameter pass is four contiguous runs, copied as they lie, and
// ldmatrix reads its 8 x 8 matrices as whole pieces.
constexpr int F_S = 64, F_J = 4 * F_S;  // a piece; a column block of 4 pieces
__host__ __device__ constexpr size_t piece_off(size_t r, int c, int W) {
  return ((r >> 5) * (W / 8) + (c >> 3)) * F_J + ((r >> 3) & 3) * F_S + (r & 7) * 8 + (c & 7);
}

// Scratch of the backward (bf16, in pieces) for M rows: X of every input slot
// (width slot_di), H[NEVAL][3][M][256] (the activations of layers 1-3 as the
// recompute formed them), GZ[NEVAL][3][M][256], GZ4[NEVAL][M][16].
template <class L>
struct BwdScratch {
  bf16* base;
  size_t M;
  __host__ __device__ BwdScratch(bf16* b, size_t m) : base(b), M(m) {}
  __host__ __device__ bf16* x(int slot) const { return base + M * L::slot_off(slot); }
  __host__ __device__ bf16* h(int e, int l) const {
    return base + M * L::x_row() + ((size_t)e * 3 + l) * M * HID;
  }
  __host__ __device__ bf16* gz(int e, int l) const { return h(L::NEVAL + e, l); }
  __host__ __device__ bf16* gz4(int e) const { return h(2 * L::NEVAL, 0) + (size_t)e * M * DO; }
  __host__ __device__ static size_t elems(size_t m) {
    return m * L::x_row() + 6 * (size_t)L::NEVAL * m * HID + (size_t)L::NEVAL * m * DO;
  }
};

// the i-th head evaluation of the reverse sweep: human, occ, inner, outer_r,
// outer_n, then the materials 1, 0, 2 (the roughness head takes the kappa
// cotangents of the lights)
template <class L>
__host__ __device__ constexpr int bwd_eval(int i) {
  if (L::human) {
    if (i == 0) return 7;
    --i;
  }
  return i == 0 ? 6 : i == 1 ? 5 : i == 2 ? 4 : i == 3 ? 3 : i == 4 ? 1 : i == 5 ? 0 : 2;
}

// A slab of the weight stream: `rows` rows of `cols` columns at element
// offset `off` of the packed weights, row stride ldg there and lds in the ring.
struct Slab {
  size_t off;
  int rows, cols, ldg, lds;
};

// The groups of HS slabs of the sweep's W1^T of evaluation e: none (occ),
// one (its input rows, at most 256) or, WIDE, the inner head's in pieces of
// DXP input rows.
template <class L>
__host__ __device__ constexpr int dx_pieces(int e) {
  return e == 6 ? 0 : WIDE && e == 5 ? (L::head_di(H_INNER) + DXP - 1) / DXP : 1;
}

// Slab s of the stream: the recompute's W1 W2 W3 W4 of every evaluation in
// order, in slabs of SLAB_K rows (W1: 272 as 256 in SLAB_K-row slabs + 16,
// the last on the points tile); then the sweep's W4^T, W3^T, W2^T and, where dX is wanted,
// W1^T of each evaluation in the sweep's order, in slabs of SLAB_K of their
// output columns (W4: its 16) with all input rows (W1: at most 256, or
// dx_pieces of them). rows = 0 past the end.
template <class L>
__device__ __forceinline__ Slab slab_at(int s) {
#pragma unroll
  for (int e = 0; e < L::NEVAL; ++e) {
    const int h = L::ev_head(e), di = L::head_di(h);
    const int n1 = (di + SLAB_K - 1) / SLAB_K;
    const size_t w = L::head_off(h);
    if (s < n1) return {w + (size_t)s * SLAB_K * HID, min(SLAB_K, di - s * SLAB_K), HID, HID, LDB};
    if (s < n1 + 3 * HS) {
      const int l = 1 + (s - n1) / HS, j = (s - n1) % HS, nc = l == 3 ? DO : HID;
      return {w + (size_t)di * HID + (size_t)(l - 1) * HID * HID + (size_t)j * SLAB_K * nc, SLAB_K,
              nc, nc, LDB};
    }
    s -= n1 + 3 * HS;
  }
#pragma unroll
  for (int i = 0; i < L::NEVAL; ++i) {
    const int e = bwd_eval<L>(i), h = L::ev_head(e), di = L::head_di(h);
    const size_t w = L::head_off(h), w2 = w + (size_t)di * HID;
    if (s == 0) return {w2 + 2 * (size_t)HID * HID, HID, DO, DO, LDT};
    const int cnt = 1 + (2 + dx_pieces<L>(e)) * HS;
    if (s < cnt) {
      if (WIDE && e == 5 && s > 2 * HS) {  // W1^T, piece p: input rows p DXP ..
        const int p = (s - 1 - 2 * HS) / HS, j = (s - 1 - 2 * HS) % HS;
        return {w + (size_t)p * DXP * HID + (size_t)j * SLAB_K, min(DXP, di - p * DXP), SLAB_K,
                HID, LDT};
      }
      const int l = 2 - (s - 1) / HS, j = (s - 1) % HS;  // W3, W2, W1
      return {(l == 0 ? w : w2 + (size_t)(l - 1) * HID * HID) + (size_t)j * SLAB_K,
              l == 0 ? min(di, HID) : HID, SLAB_K, HID, LDT};
    }
    s -= cnt;
  }
  return {0, 0, 0, 0, 0};
}

// The slabs of the stream in slab_at's order; the block keeps them as a
// table in shared memory, so that refilling the ring holds no registers
// beside the accumulators.
struct SlabRec {
  unsigned off;
  unsigned short rows, cols, ldg, lds;
};

// the forward's stream: the recompute prefix of slab_at's, W1-W4 of every
// evaluation in order
template <class L>
__host__ __device__ constexpr int n_fwd_slabs() {
  int c = 0;
  for (int e = 0; e < L::NEVAL; ++e) c += (L::head_di(L::ev_head(e)) + SLAB_K - 1) / SLAB_K + 3 * HS;
  return c;
}

// the sweep's: the recompute, then the reverse sweep
template <class L>
__host__ __device__ constexpr int n_slabs() {
  int c = n_fwd_slabs<L>();
  for (int e = 0; e < L::NEVAL; ++e) c += 1 + (2 + dx_pieces<L>(e)) * HS;
  return c;
}

// shared memory of a kernel whose slab table holds ns slabs
constexpr size_t b_smem(int ns) { return B_SMEM0 + (size_t)ns * sizeof(SlabRec); }

// The ring of the first NS slabs of the stream. next() waits for the oldest
// slab, makes it (and every shared-memory write before the call) visible to
// the block, refills the stage that the block finished with, and returns the
// slab's shared-memory address.
template <int NS>
struct Ring {
  bf16* base;
  const bf16* W;
  const SlabRec* recs;
  int slab;

  __device__ __forceinline__ void load(int s) const {
    if (s < NS) {
      const SlabRec sl = recs[s];
      bf16* st = base + (s % STAGES) * STAGE_ELEMS;
      const int cpr = sl.cols / 8;  // 16-byte chunks per row
      for (int v = threadIdx.x; v < sl.rows * cpr; v += NTHREADS) {
        const int r = v / cpr, c = (v - r * cpr) * 8;
        cp_async16(st + r * sl.lds + c, W + sl.off + (size_t)r * sl.ldg + c);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  }

  __device__ __forceinline__ unsigned next() {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    load(slab + STAGES - 1);
    const unsigned a = smem_u32(base) + (slab % STAGES) * STAGE_ELEMS * 2;
    ++slab;
    return a;
  }
};

// acc[m][j] += X[rows of m-tile m, 0:K] @ B[:, n8-tile j of the warp's
// columns] for the warp's first `ncols` columns (a multiple of 16; none: the
// warp only keeps the ring's pace), k in steps of 16 from 0 up, B from the
// ring: the recompute's slabs [k][n] (ldmatrix.trans) or, WT, the sweep's
// [n][k], which are W^T's fragments without .trans. x: this lane's ldmatrix
// address in the warp's first row of X (leading dim ldx); col0: the warp's
// first column.
template <bool WT, class R>
__device__ __forceinline__ void product(float (&acc)[2][WN][4], R& ring, unsigned x, int ldx,
                                        int K, int col0, int ncols) {
  const int lane = threadIdx.x & 31;
  const unsigned lane_b = WT ? (x4_lane(lane, LDT) + col0 * LDT) * 2
                             : ((lane & 15) * LDB + (lane >> 4) * 8 + col0) * 2;
  const int jn = min(WN / 2, max(ncols, 0) / 16);
  for (int k0 = 0; k0 < K; k0 += SLAB_K) {
    const unsigned b = ring.next() + lane_b;
    if (jn == 0) continue;
    const int ksteps = min(SLAB_K, K - k0) / 16;
#pragma unroll 1
    for (int kk = 0; kk < ksteps; ++kk) {
      unsigned a[2][4];
      ldsm_x4(a[0], x + (k0 + kk * 16) * 2);
      ldsm_x4(a[1], x + (16 * ldx + k0 + kk * 16) * 2);
#pragma unroll
      for (int j = 0; j < WN / 2; ++j) {
        if (j < jn) {
          unsigned bb[4];
          if (WT) ldsm_x4(bb, b + (j * 16 * LDT + kk * 16) * 2);
          else ldsm_x4_t(bb, b + (kk * 16 * LDB + j * 16) * 2);
          mma_bf16(acc[0][2 * j], a[0], bb[0], bb[1]);
          mma_bf16(acc[1][2 * j], a[1], bb[0], bb[1]);
          mma_bf16(acc[0][2 * j + 1], a[0], bb[2], bb[3]);
          mma_bf16(acc[1][2 * j + 1], a[1], bb[2], bb[3]);
        }
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[2][WN][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
}

// the sum over the 4 lanes of a row (adjacent threads); every lane gets the
// same bits
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void row_sum3(float* v) {
  for (int k = 0; k < 3; ++k) v[k] = row_sum(v[k]);
}

// d PE(nfreq) / d x of this lane's octaves (lane 0 also the identity
// columns), added to dx; g: the cotangent of the encoding
__device__ void pe_bwd_lane(const float* x, const float* g, int nfreq, float* dx, int lane) {
  if (lane == 0)
    for (int k = 0; k < 3; ++k) dx[k] += g[k];
  for (int i = lane; i < nfreq; i += 4)
    for (int k = 0; k < 3; ++k) {
      const float f = pow2f(i), a = x[k] * f;
      dx[k] += f * (g[3 + 6 * i + k] * cosf(a) - g[6 + 6 * i + k] * sinf(a));
    }
}

// cotangent g [24] of the IPE -> dp, dr (added to) and d roughness
// (returned), the octaves shared by the 4 lanes of the row; every lane
// returns the same values
__device__ float human_bwd(const float* pose, const HumanRow& h, float rough, const float* g,
                           float* dp, float* dr, int lane) {
  float dmean[2] = {0.0f, 0.0f}, dvar = 0.0f;
  for (int i = lane; i < 6; i += 4) {
    const float s = pow2f(i);
    const float att = expf(-0.5f * h.var * s * s);
    for (int k = 0; k < 2; ++k) {
      const float a = h.mean[k] * s;
      const float sn = sinf(a), cs = cosf(a);
      const float gs = g[2 * i + k], gc = g[12 + 2 * i + k];
      dmean[k] += s * att * (gs * cs - gc * sn);
      dvar += -0.5f * s * s * att * (gs * sn + gc * cs);
    }
  }
  dmean[0] = row_sum(dmean[0]);
  dmean[1] = row_sum(dmean[1]);
  dvar = row_sum(dvar);
  if (h.hit == 0.0f) return 0.0f;  // mean and var are masked to constants
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

__device__ __forceinline__ void load_pose(const float* geo, int row, int n, int geo_w,
                                          float* pose) {
  for (int k = 0; k < 12; ++k) pose[k] = row < n ? geo[(size_t)row * geo_w + 9 + k] : 0.0f;
}

// WIDE: columns c0 .. c0 + 255 (at most) of light input slot 3 (inner:
// [PE(pts), IDE(reflective, kappa)]) or 4 (occ: [PE(pts), PE6(reflective)])
// into the activation tile, 4 lanes a row; every column is a function of its
// own row. Not inlined, as build_slot.
template <class L>
__device__ __noinline__ void build_window(int slot, int c0, bf16* A, float* rs, const float* tab) {
  const int tid = threadIdx.x, r = tid >> 2, q = tid & 3;
  const int w = min(HID, L::slot_di(slot) - c0);
  for (int v = tid; v < PB * (w / 8); v += NTHREADS)
    *reinterpret_cast<uint4*>(A + (v / (w / 8)) * LDA + (v % (w / 8)) * 8) = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const float* s = rs + r * RSB;
  bf16* x = A + r * LDA;
  for (int c = c0 + q; c < min(NPEL, c0 + w); c += 4) x[c - c0] = to_bf(pe_val(s + B_PTS, c));
  if (slot == 4) {
    for (int c = q; c < NPE6; c += 4)
      if (NPEL + c >= c0 && NPEL + c < c0 + w) x[NPEL + c - c0] = to_bf(pe_val(s + B_R, c));
  } else if (NPEL < c0 + w && NPEL + NIDE > c0) {
    ide_row(tab, s[B_R], s[B_R + 1], s[B_R + 2], s[B_KAPPA], Window{x, NPEL - c0, w}, 1, q, 4);
  }
  __syncthreads();
}

// Head input slot `slot` of the tile into the activation tile A (slot 0:
// feats there, the points in the points tile Pt), 4 lanes a row; the human
// slot also keeps the row's hit mask in the row state. Not
// inlined, as enc_bwd: the per-row phases get registers of their own, and
// the sweep's products keep theirs (inlined, the sphere variants spill).
template <class L>
__device__ __noinline__ void build_slot(int slot, bf16* A, bf16* Pt, float* rs, const float* tab,
                           const float* __restrict__ feats, const float* __restrict__ geo,
                           int p0, int n) {
  const int tid = threadIdx.x, r = tid >> 2, q = tid & 3;
  if (slot == 0) {
    for (int v = tid; v < PB * (HID / 4); v += NTHREADS) {
      const int rr = v / (HID / 4), c = (v % (HID / 4)) * 4;
      float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (p0 + rr < n) f = *reinterpret_cast<const float4*>(feats + (size_t)(p0 + rr) * HID + c);
      __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(A + rr * LDA + c);
      d[0] = __floats2bfloat162_rn(f.x, f.y);
      d[1] = __floats2bfloat162_rn(f.z, f.w);
    }
    for (int c = q; c < PTW; c += 4) Pt[r * LDP + c] = to_bf(c < 3 ? rs[r * RSB + B_PTS + c] : 0.0f);
    __syncthreads();
    return;
  }
  if (WIDE && (slot == 3 || slot == 4)) {  // its first window
    build_window<L>(slot, 0, A, rs, tab);
    return;
  }
  const int di = L::slot_di(slot);
  for (int v = tid; v < PB * (di / 8); v += NTHREADS)
    *reinterpret_cast<uint4*>(A + (v / (di / 8)) * LDA + (v % (di / 8)) * 8) = make_uint4(0, 0, 0, 0);
  __syncthreads();
  float* s = rs + r * RSB;
  bf16* x = A + r * LDA;
  if (slot == 5) {
    if constexpr (L::human) {
      float pose[12];
      load_pose(geo, p0 + r, n, L::GEO, pose);
      HumanRow h;
      human_row(pose, s + B_PTS, s + B_R, s[B_KAPPA], h);
      human_ipe(h, x, q, 4);
      if (q == 0) s[B_HIT] = h.hit;
    }
  } else if (slot == 4) {
    for (int c = q; c < NPEL; c += 4) x[c] = to_bf(pe_val(s + B_PTS, c));
    for (int c = q; c < NPE6; c += 4) x[NPEL + c] = to_bf(pe_val(s + B_R, c));
  } else {
    const bool normal = slot == 1;
    const float* d = s + (normal ? B_N : B_R);
    const float kappa = normal ? 1.0f : s[B_KAPPA];
    if (slot == 3)
      for (int c = q; c < NPEL; c += 4) x[c] = to_bf(pe_val(s + B_PTS, c));
    ide_row(tab, d[0], d[1], d[2], kappa, x + (slot == 3 ? NPEL : 0), 1, q, 4);
    if constexpr (L::sphere) if (slot <= 2) {
      SphereHit hh;
      sphere_hit(s + B_PTS, d, hh);
      ide_row(tab, hh.u[0], hh.u[1], hh.u[2], kappa, x + NIDE, 1, q, 4);
    }
  }
  __syncthreads();
}

// The slot's input (the tile, and for slot 0 the points tile) to the
// scratch, 16 bytes a copy.
__device__ void store_slot(const bf16* A, const bf16* Pt, bf16* Xg, int di, size_t row0) {
  const int cb = di / 8;
  for (int v = threadIdx.x; v < PB * cb; v += NTHREADS) {
    const int r = v / cb, c = (v % cb) * 8;
    const bf16* src = c < HID ? A + r * LDA + c : Pt + r * LDP + (c - HID);
    *reinterpret_cast<uint4*>(Xg + piece_off(row0 + r, c, di)) =
        *reinterpret_cast<const uint4*>(src);
  }
}

// WIDE: window columns c0 .. c0 + w - 1 of a light input slot (width di),
// from the activation tile to the scratch. Not inlined, as build_slot.
__device__ __noinline__ void store_window(const bf16* A, bf16* Xg, int di, int c0, int w,
                                          size_t row0) {
  const int cb = w / 8;
  for (int v = threadIdx.x; v < PB * cb; v += NTHREADS) {
    const int r = v / cb, c = (v % cb) * 8;
    *reinterpret_cast<uint4*>(Xg + piece_off(row0 + r, c0 + c, di)) =
        *reinterpret_cast<const uint4*>(A + r * LDA + c);
  }
}

// WIDE: a 256-wide scratch array's rows of the tile (GZ1) back into the
// activation tile. Not inlined, as build_slot.
__device__ __noinline__ void load_tile(bf16* A, const bf16* Xg, size_t row0) {
  for (int v = threadIdx.x; v < PB * (HID / 8); v += NTHREADS) {
    const int r = v / (HID / 8), c = (v % (HID / 8)) * 8;
    *reinterpret_cast<uint4*>(A + r * LDA + c) =
        *reinterpret_cast<const uint4*>(Xg + piece_off(row0 + r, c, HID));
  }
}

// The block's prologue: the first ns slabs of the stream as the slab table,
// the IDE table, and each row's geometry (normalised normal and view, NoV,
// reflective; the rest of the row state zero).
template <class L>
__device__ __forceinline__ void tile_setup(int ns, SlabRec* recs, float* tab,
                                           const float* __restrict__ ide_tab, float* rs,
                                           const float* __restrict__ geo, int p0, int n) {
  const int tid = threadIdx.x;
  for (int i = tid; i < ns; i += NTHREADS) {
    const Slab sl = slab_at<L>(i);
    recs[i] = {(unsigned)sl.off, (unsigned short)sl.rows, (unsigned short)sl.cols,
               (unsigned short)sl.ldg, (unsigned short)sl.lds};
  }
  for (int i = tid; i < TAB; i += NTHREADS) tab[i] = ide_tab[i];
  if (tid < PB) {
    const int r = tid;
    float* s = rs + r * RSB;
    float gg[9];
    for (int k = 0; k < 9; ++k) gg[k] = p0 + r < n ? geo[(size_t)(p0 + r) * L::GEO + k] : 0.0f;
    for (int k = 0; k < 3; ++k) s[B_PTS + k] = gg[k];
    normalize3(gg + 3, s + B_N, s + B_NLEN);
    normalize3(gg + 6, s + B_V, s + B_VLEN);
    const float nov = dot3(s + B_N, s + B_V);
    s[B_NOV] = nov;
    for (int k = 0; k < 3; ++k) s[B_R + k] = nov * s[B_N + k] * 2.0f - s[B_V + k];
    for (int k = B_GPTS; k < RSB; ++k) s[k] = 0.0f;
  }
  __syncthreads();
}

// shared memory: activations [PB][LDA], the material input's points
// [PB][LDP], the ring, the row state [PB][RSB], the IDE table, the slab table
struct Tiles {
  bf16 *A, *Pt, *ring;
  float *rs, *tab;
  SlabRec* recs;
  __device__ explicit Tiles(unsigned char* base) {
    A = reinterpret_cast<bf16*>(base);
    Pt = A + PB * LDA;
    ring = A + TILE_ELEMS;
    rs = reinterpret_cast<float*>(ring + STAGES * STAGE_ELEMS);
    tab = rs + PB * RSB;
    recs = reinterpret_cast<SlabRec*>(tab + TAB);
  }
};

// The forward: every head evaluation in order on the tile, its input slot
// built in the activation tile, the four products from the ring, bias and
// ReLU in registers with each H once, bf16, into the tile; layer 4 on the
// warps of columns 0-63, whose n8-tile 0 holds the padded outputs: z4 + b4 to
// out [n, 24], and after the roughness head kappa = sigmoid(z) into the row
// state. The backward's recompute runs the same loop with the scratch stores.
// The scene of a block is blockIdx.y: its row arrays (geometry, feats and
// `rows`, [n, 24] each) start n rows a scene further on, its weights and
// biases a weight set further on.
#define SCENE_OFFSETS(rows)                              \
  do {                                                   \
    const size_t sc_ = blockIdx.y;                       \
    geo += sc_ * n * L::GEO;                             \
    feats += sc_ * n * HID;                              \
    rows += sc_ * n * OUT;                               \
    W += sc_ * L::w_total();                             \
    B += sc_ * L::NHEADS * 4 * HID;                      \
  } while (0)

template <class L>
__global__ void __launch_bounds__(NTHREADS, 1)
shader_fwd_kernel(const float* __restrict__ geo, const float* __restrict__ feats, int n,
                  const bf16* __restrict__ W, const float* __restrict__ B,
                  const float* __restrict__ ide_tab, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int NS = n_fwd_slabs<L>();
  const Tiles T(smem_raw);
  bf16* A = T.A;
  bf16* Pt = T.Pt;
  float* rs = T.rs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp / NQ, cq = warp % NQ;  // row group, column group
  const int g = lane >> 2, t = lane & 3;      // accumulator row and column pair
  const int p0 = blockIdx.x * PB;
  SCENE_OFFSETS(out);
  tile_setup<L>(NS, T.recs, T.tab, ide_tab, rs, geo, p0, n);
  Ring<NS> ring{T.ring, W, T.recs, 0};
  for (int st = 0; st < STAGES - 1; ++st) ring.load(st);
  const unsigned a_x = smem_u32(A + (grp * 32 + (lane & 15)) * LDA + (lane >> 4) * 8);
  const unsigned p_x = smem_u32(Pt + (grp * 32 + (lane & 15)) * LDP + (lane >> 4) * 8);
  const int col0 = cq * WN * 8;
  bf16* arow = A + (grp * 32 + g) * LDA + col0 + 2 * t;
  float acc[2][WN][4];

  for (int e = 0; e < L::NEVAL; ++e) {
    const int h = L::ev_head(e), slot = L::ev_slot(e), di = L::head_di(h);
    build_slot<L>(slot, A, Pt, rs, T.tab, feats, geo, p0, n);
    const float* bh = B + h * 4 * HID;
    for (int l = 0; l < 4; ++l) {
      zero(acc);
      if (WIDE && l == 0 && (slot == 3 || slot == 4)) {
        // the light input in 256-column windows, each against its W1 slabs
        for (int c0 = 0; c0 < di; c0 += HID) {
          if (c0 > 0) {
            __syncthreads();  // every warp is done reading the previous window
            build_window<L>(slot, c0, A, rs, T.tab);
          }
          product<false>(acc, ring, a_x, LDA, min(HID, di - c0), col0, HID - col0);
        }
      } else if (l == 0) {
        product<false>(acc, ring, a_x, LDA, min(di, HID), col0, HID - col0);
        if (di > HID) product<false>(acc, ring, p_x, LDP, di - HID, col0, HID - col0);
      } else {
        product<false>(acc, ring, a_x, LDA, HID, col0, (l == 3 ? DO : HID) - col0);
      }
      __syncthreads();  // every warp is done reading the tile
      if (l < 3) {  // H = relu(z + b) to the tile
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
        continue;
      }
      if (cq == 0 && 2 * t < L::ev_nout(e)) {  // the outputs: columns 2t, 2t + 1
        const int nout = L::ev_nout(e);
        float* o = out + L::ev_col(e) + 2 * t;
        const float b0 = bh[3 * HID + 2 * t], b1 = bh[3 * HID + 2 * t + 1];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = p0 + grp * 32 + 16 * m + 8 * hf + g;
            if (row >= n) continue;
            o[(size_t)row * OUT] = acc[m][0][2 * hf] + b0;
            if (2 * t + 1 < nout) o[(size_t)row * OUT + 1] = acc[m][0][2 * hf + 1] + b1;
          }
      }
      if (e == 1 && cq == 0 && t == 0) {  // kappa = sigmoid(roughness_z)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            rs[(grp * 32 + 16 * m + 8 * hf + g) * RSB + B_KAPPA] =
                sigmoidf_(acc[m][0][2 * hf] + bh[3 * HID]);
      }
    }
  }
  // reflective 15:18, NoV 18; then zeros, or (HUMAN) the hit mask in 23
  // behind the seventh head's 19:23
  for (int idx = tid; idx < PB * (OUT - 15); idx += NTHREADS) {
    const int r = idx / (OUT - 15), c = idx % (OUT - 15);
    if (p0 + r >= n) continue;
    if (L::human && c >= 4 && c < 8) continue;
    const float* s = rs + r * RSB;
    const float v = c < 3 ? s[B_R + c] : c == 3 ? s[B_NOV] : (L::human && c == 8) ? s[B_HIT] : 0.0f;
    out[(size_t)(p0 + r) * OUT + 15 + c] = v;
  }
}

// The backward of the encodings of light evaluation e, from its input
// cotangent D [PB][di] (f32), 4 lanes a row, into the row's gradient
// accumulators (added by the row's lane 0, in a fixed order).
template <class L>
__device__ __noinline__ void enc_bwd(int e, const float* D, int di, float* rs, const float* tab,
                        const float* __restrict__ geo, int p0, int n) {
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  float* s = rs + r * RSB;
  const float* g = D + r * di;
  const float kappa = s[B_KAPPA];
  float dp[3] = {0.0f, 0.0f, 0.0f}, dd[3] = {0.0f, 0.0f, 0.0f};  // d pts; d direction
  float dk = 0.0f;                                                // d kappa
  if (e == 7) {  // human: IPE of the camera-plane hit of the point and reflective
    if constexpr (L::human) {
      float pose[12];
      load_pose(geo, p0 + r, n, L::GEO, pose);
      HumanRow h;
      human_row(pose, s + B_PTS, s + B_R, kappa, h);
      dk = human_bwd(pose, h, kappa, g, dp, dd, q);
    }
  } else if (e == 5) {  // inner: [PE8(pts), IDE(reflective, kappa)]
    pe_bwd_lane(s + B_PTS, g, LIGHT_PE, dp, q);
    dk = ide_row_bwd(tab, s[B_R], s[B_R + 1], s[B_R + 2], kappa, g + NPEL, dd, q, 4);
    row_sum3(dp);
    row_sum3(dd);
    dk = row_sum(dk);
  } else {  // outer light on the reflective (e = 4) or the normal (e = 3)
    const bool refl = e == 4;
    const float* d = s + (refl ? B_R : B_N);
    const float kap = refl ? kappa : 1.0f;
    dk = ide_row_bwd(tab, d[0], d[1], d[2], kap, g, dd, q, 4);
    row_sum3(dd);
    dk = row_sum(dk);
    if constexpr (L::sphere) {
      SphereHit h;
      sphere_hit(s + B_PTS, d, h);
      float du[3] = {0.0f, 0.0f, 0.0f};
      const float gk = row_sum(ide_row_bwd(tab, h.u[0], h.u[1], h.u[2], kap, g + NIDE, du, q, 4));
      row_sum3(du);
      sphere_hit_bwd(s + B_PTS, d, h, du, dp, dd);
      dk += gk;
    }
    if (!refl) dk = 0.0f;
  }
  if (q == 0) {
    const int gd = e == 3 ? B_GN : B_GR;
    for (int k = 0; k < 3; ++k) {
      s[B_GPTS + k] += dp[k];
      s[gd + k] += dd[k];
    }
    s[B_GKAPPA] += dk;
  }
}

// WIDE: the backward of the inner head's encodings [PE(pts), IDE(reflective,
// kappa)] for its input columns c0 .. c0 + w - 1, from their cotangent D
// [PB][DXP] (f32), 4 lanes a row, added into the row's gradient accumulators
// by its lane 0; the pieces come in column order.
template <class L>
__device__ __noinline__ void enc_bwd_piece(const float* D, int c0, int w, float* rs,
                                           const float* tab) {
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  float* s = rs + r * RSB;
  const float* g = D + r * DXP;
  float dp[3] = {0.0f, 0.0f, 0.0f}, dd[3] = {0.0f, 0.0f, 0.0f}, dk = 0.0f;
  if (c0 == 0 && q == 0)
    for (int k = 0; k < 3; ++k) dp[k] += g[k];
  // the octaves whose columns 3 + 6i .. 8 + 6i meet the piece
  const int i0 = c0 < 9 ? 0 : (c0 - 9) / 6 + 1, i1 = min(LIGHT_PE, (c0 + w + 2) / 6);
  for (int i = i0 + q; i < i1; i += 4)
    for (int k = 0; k < 3; ++k) {
      const int cs = 3 + 6 * i + k - c0, cc = cs + 3;
      const float gs = cs >= 0 && cs < w ? g[cs] : 0.0f, gc = cc >= 0 && cc < w ? g[cc] : 0.0f;
      const float f = pow2f(i), a = s[B_PTS + k] * f;
      dp[k] += f * (gs * cosf(a) - gc * sinf(a));
    }
  if (NPEL < c0 + w && NPEL + NIDE > c0)
    dk = ide_row_bwd(tab, s[B_R], s[B_R + 1], s[B_R + 2], s[B_KAPPA], WindowIn{g, NPEL - c0, w},
                     dd, q, 4);
  row_sum3(dp);
  row_sum3(dd);
  dk = row_sum(dk);
  if (q == 0) {
    for (int k = 0; k < 3; ++k) {
      s[B_GPTS + k] += dp[k];
      s[B_GR + k] += dd[k];
    }
    s[B_GKAPPA] += dk;
  }
}

template <class L>
__global__ void __launch_bounds__(NTHREADS, 1)
shader_bwd_sweep_kernel(const float* __restrict__ geo, const float* __restrict__ feats, int n,
                        const bf16* __restrict__ W, const float* __restrict__ B,
                        const float* __restrict__ ide_tab, const float* __restrict__ gout,
                        float* __restrict__ dgeo, float* __restrict__ dfeats,
                        bf16* __restrict__ scratch, int m_rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int NS = n_slabs<L>();
  const Tiles T(smem_raw);
  bf16* A = T.A;  // activations, then cotangents
  bf16* Pt = T.Pt;
  float* rs = T.rs;
  const float* tab = T.tab;
  float* D = reinterpret_cast<float*>(smem_raw);  // a light head's dX [PB][di], over A and Pt
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp / NQ, cq = warp % NQ;  // row group, column group
  const int g = lane >> 2, t = lane & 3;      // accumulator row and column pair
  const int p0 = blockIdx.x * PB;
  const size_t row0 = (size_t)p0;
  SCENE_OFFSETS(gout);
  dgeo += blockIdx.y * (size_t)n * DGEO;
  dfeats += blockIdx.y * (size_t)n * HID;
  const BwdScratch<L> S(scratch + blockIdx.y * BwdScratch<L>::elems(m_rows), (size_t)m_rows);

  tile_setup<L>(NS, T.recs, T.tab, ide_tab, rs, geo, p0, n);
  Ring<NS> ring{T.ring, W, T.recs, 0};
  for (int st = 0; st < STAGES - 1; ++st) ring.load(st);

  const unsigned a_x = smem_u32(A + (grp * 32 + (lane & 15)) * LDA + (lane >> 4) * 8);
  const unsigned p_x = smem_u32(Pt + (grp * 32 + (lane & 15)) * LDP + (lane >> 4) * 8);
  const int col0 = cq * WN * 8;
  // this lane's first element in a 256-wide scratch array (32 bits: the sweep
  // spills with it in 64)
  const unsigned go = (unsigned)piece_off(row0 + grp * 32 + g, col0 + 2 * t, HID);
  bf16* arow = A + (grp * 32 + g) * LDA + col0 + 2 * t;
  float acc[2][WN][4];

  // ---- recompute: every evaluation forward, X and H to the scratch ----
  for (int e = 0; e < L::NEVAL; ++e) {
    const int h = L::ev_head(e), slot = L::ev_slot(e), di = L::head_di(h);
    build_slot<L>(slot, A, Pt, rs, tab, feats, geo, p0, n);
    if (WIDE && (slot == 3 || slot == 4)) store_window(A, S.x(slot), di, 0, min(di, HID), row0);
    else if (e == 0 || e >= 3) store_slot(A, Pt, S.x(slot), di, row0);
    const float* bh = B + h * 4 * HID;
    for (int l = 0; l < 4; ++l) {
      zero(acc);
      if (WIDE && l == 0 && (slot == 3 || slot == 4)) {
        // the light input in 256-column windows, each to the scratch and
        // against its W1 slabs
        for (int c0 = 0; c0 < di; c0 += HID) {
          if (c0 > 0) {
            __syncthreads();  // every warp is done reading the previous window
            build_window<L>(slot, c0, A, rs, tab);
            store_window(A, S.x(slot), di, c0, min(HID, di - c0), row0);
          }
          product<false>(acc, ring, a_x, LDA, min(HID, di - c0), col0, HID - col0);
        }
      } else if (l == 0) {
        product<false>(acc, ring, a_x, LDA, min(di, HID), col0, HID - col0);
        if (di > HID) product<false>(acc, ring, p_x, LDP, di - HID, col0, HID - col0);
      } else {
        product<false>(acc, ring, a_x, LDA, HID, col0, (l == 3 ? DO : HID) - col0);
      }
      __syncthreads();  // every warp is done reading the tile
      if (l < 3) {  // H = relu(z + b): to the tile and the scratch
        bf16* hg = S.h(e, l) + go;
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
      } else if (e == 1 && cq == 0 && t == 0) {  // kappa = sigmoid(roughness_z)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            rs[(grp * 32 + 16 * m + 8 * hf + g) * RSB + B_KAPPA] =
                sigmoidf_(acc[m][0][2 * hf] + bh[3 * HID]);
      }
    }
  }

  // ---- reverse sweep ----
  for (int i = 0; i < L::NEVAL; ++i) {
    const int e = bwd_eval<L>(i), h = L::ev_head(e), di = L::head_di(h);
    const int col = L::ev_col(e), nout = L::ev_nout(e);
    const bool want_dx = e != 6;  // the occ head's inputs are stop-gradient
    {  // GZ4: the cotangent of the evaluation's packed outputs (the roughness
       // head's with the kappa cotangents of the lights)
      const int r = tid >> 2, c = (tid & 3) * 4;
      float v[4];
      for (int k = 0; k < 4; ++k) {
        v[k] = 0.0f;
        if (p0 + r < n && c + k < nout) {
          v[k] = gout[(size_t)(p0 + r) * OUT + col + c + k];
          if (e == 1) {
            const float kap = rs[r * RSB + B_KAPPA];
            v[k] += kap * (1.0f - kap) * rs[r * RSB + B_GKAPPA];
          }
        }
      }
      const __nv_bfloat162 v01 = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 v23 = __floats2bfloat162_rn(v[2], v[3]);
      __nv_bfloat162* a2 = reinterpret_cast<__nv_bfloat162*>(A + r * LDA + c);
      a2[0] = v01;
      a2[1] = v23;
      __nv_bfloat162* g2 = reinterpret_cast<__nv_bfloat162*>(S.gz4(e) + piece_off(row0 + r, c, DO));
      g2[0] = v01;
      g2[1] = v23;
    }
    for (int l = 2; l >= 0; --l) {
      // the cotangent of H_l: GH = GZ_{l+1} @ W_{l+1}^T; then the ReLU mask
      zero(acc);
      product<true>(acc, ring, a_x, LDA, l == 2 ? DO : HID, col0, HID - col0);
      __syncthreads();  // every warp is done reading the cotangent tile
      const bf16* hl = S.h(e, l) + go;
      bf16* gzl = S.gz(e, l) + go;
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
            if (l > 0 || want_dx)
              *reinterpret_cast<__nv_bfloat162*>(arow + (16 * m + 8 * hf) * LDA + j * 8) = v;
          }
    }
    if (WIDE && e == 5) {
      // dX = GZ1 @ W1^T in pieces of DXP columns: each staged in f32 over the
      // tiles, its encodings' backward added into the row state, then GZ1
      // back from the scratch for the next piece (its width and evaluation
      // as constants, and the loop kept rolled: the sphere and human
      // variant's sweep spills otherwise)
      constexpr int di_in = L::head_di(H_INNER);
#pragma unroll 1
      for (int c0 = 0; c0 < di_in; c0 += DXP) {
        const int w = min(DXP, di_in - c0);
        // the ring's next barrier comes before any warp reads it
        if (c0 > 0) load_tile(A, S.gz(5, 0), row0);
        zero(acc);
        product<true>(acc, ring, a_x, LDA, HID, col0, w - col0);
        __syncthreads();  // every warp is done reading GZ1: the tile becomes D
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const int c = col0 + j * 8 + 2 * t;
          if (c >= w) break;
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
              *reinterpret_cast<float2*>(D + (grp * 32 + 16 * m + 8 * hf + g) * DXP + c) =
                  make_float2(acc[m][j][2 * hf], acc[m][j][2 * hf + 1]);
        }
        __syncthreads();
        enc_bwd_piece<L>(D, c0, w, rs, tab);
        __syncthreads();  // D is read before GZ1 comes back over it
      }
    } else if (want_dx) {
      // dX = GZ1 @ W1^T, at most 256 columns
      const int dxw = min(di, HID);
      zero(acc);
      product<true>(acc, ring, a_x, LDA, HID, col0, dxw - col0);
      if (e <= 2) {
        // the material input's point columns 256-258 on the CUDA cores: the
        // row's 4 lanes take every fourth column pair of GZ1
        const int r = tid >> 2, q = tid & 3;
        const bf16* w1p = W + L::head_off(h) + (size_t)HID * HID;
        float dp[3] = {0.0f, 0.0f, 0.0f};
        for (int c = 2 * q; c < HID; c += 8) {
          const float2 gz = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(A + r * LDA + c));
          for (int k = 0; k < 3; ++k) {
            const float2 w2 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(w1p + k * HID + c));
            dp[k] += gz.x * w2.x + gz.y * w2.y;
          }
        }
        row_sum3(dp);
        if (q == 0)
          for (int k = 0; k < 3; ++k) rs[r * RSB + B_GPTS + k] += dp[k];
        // d_feats: the material heads' dX added in the sweep's order 1, 0, 2
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = p0 + grp * 32 + 16 * m + 8 * hf + g;
            if (row >= n) continue;
            float* df = dfeats + (size_t)row * HID + col0 + 2 * t;
#pragma unroll
            for (int j = 0; j < WN; ++j) {
              float2 v = make_float2(acc[m][j][2 * hf], acc[m][j][2 * hf + 1]);
              if (e != 1) {
                const float2 o = *reinterpret_cast<const float2*>(df + j * 8);
                v.x = o.x + v.x;
                v.y = o.y + v.y;
              }
              *reinterpret_cast<float2*>(df + j * 8) = v;
            }
          }
      } else {
        __syncthreads();  // every warp is done reading GZ1: the tile becomes D
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const int c = col0 + j * 8 + 2 * t;
          if (c >= dxw) break;
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
              *reinterpret_cast<float2*>(D + (grp * 32 + 16 * m + 8 * hf + g) * di + c) =
                  make_float2(acc[m][j][2 * hf], acc[m][j][2 * hf + 1]);
        }
        __syncthreads();
        enc_bwd<L>(e, D, di, rs, tab, geo, p0, n);
      }
    }
    __syncthreads();  // before the next evaluation's GZ4 goes over the tile
  }

  // ---- reflective = 2 NoV n - v, NoV = n.v, then both normalizations ----
  if (tid < PB && p0 + tid < n) {
    const int r = tid;
    const float* s = rs + r * RSB;
    const float* nn = s + B_N;
    const float* vv = s + B_V;
    const float* go_r = gout + (size_t)(p0 + r) * OUT;
    float dr[3], dn[3], dv[3];
    for (int k = 0; k < 3; ++k) dr[k] = s[B_GR + k] + go_r[15 + k];
    const float nov = s[B_NOV];
    const float dnov = go_r[18] + 2.0f * dot3(dr, nn);
    for (int k = 0; k < 3; ++k) {
      dn[k] = s[B_GN + k] + 2.0f * nov * dr[k] + dnov * vv[k];
      dv[k] = -dr[k] + dnov * nn[k];
    }
    float dn_raw[3], dv_raw[3];
    normalize3_bwd(nn, s[B_NLEN], dn, dn_raw);
    normalize3_bwd(vv, s[B_VLEN], dv, dv_raw);
    float* d = dgeo + (size_t)(p0 + r) * DGEO;
    for (int k = 0; k < 3; ++k) {
      d[k] = s[B_GPTS + k];
      d[3 + k] = dn_raw[k];
      d[6 + k] = dv_raw[k];
    }
  }
}

// ---------------------------------------------------------------------------
// backward: weight and bias gradients
// ---------------------------------------------------------------------------

constexpr int PW_THREADS = 512;  // 16 warps: a 128 x 256 tile of dW, 32 x 64 a warp
constexpr int PW_RS = 128;       // rows per stage
constexpr int PW_STAGES = 2;
constexpr int PW_STAGE = PW_RS * (128 + HID);  // X's 128 columns at most, G's 256
constexpr size_t PW_SMEM = (size_t)PW_STAGES * PW_STAGE * 2;
constexpr int PW_MIN_ROWS = 2048;  // rows per chunk, at least
constexpr int PW_MAX_CHUNKS = 64;
static_assert(PW_SMEM <= 232448, "parameter pass shared memory");

// floats of one chunk's partials: dW (packed), then dB [NHEADS][4][256]
template <class L>
__host__ __device__ constexpr size_t part_row() {
  return L::w_total() + (size_t)L::NHEADS * 4 * HID;
}

// parts of a head's products: its layer-1 input in 128-row parts, then two
// each of layers 2-4
template <class L>
__host__ __device__ constexpr int head_items(int h) {
  return (L::head_di(h) + 127) / 128 + 6;
}

template <class L>
__host__ __device__ constexpr int n_items() {
  int c = 0;
  for (int h = 0; h < L::NHEADS; ++h) c += head_items<L>(h);
  return c;
}

// One block's share of the parameter gradients: dW[out + k * ldo + n] for
// k < 8 xn, n < 8 gn = the sum over the chunk's rows of X[row][8 xp + k]
// G[row][n], X and G in pieces of widths xw and gw; the outer head's second
// evaluation (X2, G2) adds its rows to the same sums.
struct PwTile {
  const bf16 *X, *G, *X2, *G2;
  int xw, xp, xn, gn;
  size_t out;
  int ldo;
  int db;  // db row (head * 4 + layer), its column sums of G; < 0: none
};

template <class L>
__device__ __forceinline__ PwTile pw_tile(int t, const BwdScratch<L>& S) {
#pragma unroll
  for (int h = 0; h < L::NHEADS; ++h) {
    const int n = head_items<L>(h);
    if (t < n) {
      const int di = L::head_di(h), n1 = n - 6;
      int e = 0;
      while (L::ev_head(e) != h) ++e;
      const int e2 = h == H_OUTER ? e + 1 : -1;
      const int l = t < n1 ? 0 : 1 + (t - n1) / 2, it = t < n1 ? t : (t - n1) % 2;
      const int xw = l == 0 ? di : HID, ldo = l == 3 ? DO : HID;
      const size_t out = L::head_off(h) + (l == 0 ? 0 : (size_t)di * HID + (size_t)(l - 1) * HID * HID)
                       + (size_t)it * 128 * ldo;
      auto xof = [&](int ev) { return l == 0 ? S.x(L::ev_slot(ev)) : S.h(ev, l - 1); };
      auto gof = [&](int ev) { return l == 3 ? S.gz4(ev) : S.gz(ev, l); };
      return {xof(e), gof(e), e2 >= 0 ? xof(e2) : nullptr, e2 >= 0 ? gof(e2) : nullptr, xw,
              16 * it, min(16, xw / 8 - 16 * it), ldo / 8, out, ldo, it == 0 ? h * 4 + l : -1};
    }
    t -= n;
  }
  return {};
}

template <class L>
__global__ void __launch_bounds__(PW_THREADS, 1)
shader_bwd_params_kernel(bf16* __restrict__ scratch, int m_rows, int rows_per_chunk,
                         float* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* stages = reinterpret_cast<bf16*>(smem_raw);  // per stage X then G, each in pieces
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ig = warp / 4, og = warp % 4;  // the warp's 32 input rows and 64 output columns
  const int g = lane >> 2, t = lane & 3;
  const size_t M = (size_t)m_rows;
  // blockIdx.z is the scene: its scratch and its chunks' partials
  const PwTile T =
      pw_tile<L>(blockIdx.x, BwdScratch<L>(scratch + blockIdx.z * BwdScratch<L>::elems(M), M));
  const int m0 = blockIdx.y * rows_per_chunk;
  const int n_st = max(0, min((int)M - m0, rows_per_chunk)) / PW_RS;  // stages per evaluation
  const int n_all = T.X2 ? 2 * n_st : n_st;
  constexpr int GROUPS = PW_RS / 32;

  // the stage's 32-row groups, pieces p .. p + n - 1 of each: GROUPS runs of
  // n * F_J elements in device memory, 16 bytes a copy
  auto copy = [&](bf16* dst, const bf16* src, int w, int p, int n, size_t m) {
    const int run = n * F_J / 8;
    for (int v = tid; v < GROUPS * run; v += PW_THREADS) {
      const int q = v / run, c = (v - q * run) * 8;
      cp_async16(dst + q * n * F_J + c, src + (m / 32 + q) * (w / 8) * F_J + p * F_J + c);
    }
  };
  auto load = [&](int i) {
    if (i < n_all) {
      bf16* xs = stages + (i % PW_STAGES) * PW_STAGE;
      const bool second = i >= n_st;
      const size_t m = (size_t)m0 + (size_t)(second ? i - n_st : i) * PW_RS;
      copy(xs, second ? T.X2 : T.X, T.xw, T.xp, T.xn, m);
      copy(xs + PW_RS * T.xn * 8, second ? T.G2 : T.G, T.gn * 8, 0, T.gn, m);
    }
    cp_async_commit();
  };

  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
  float dbs = 0.0f;
  const bool rows_here = ig * 4 < T.xn && og * 8 < T.gn;
  // ldmatrix: lanes 8q .. 8q + 7 give the rows of matrix q. A = X^T (.trans):
  // matrices (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15);
  // B = G (.trans): (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
  const int a_k8 = lane >> 4, a_m8 = (lane >> 3) & 1, b_k8 = (lane >> 3) & 1, b_n8 = lane >> 4;

  for (int s = 0; s < PW_STAGES - 1; ++s) load(s);
  for (int i = 0; i < n_all; ++i) {
    cp_async_wait<PW_STAGES - 2>();
    __syncthreads();
    load(i + PW_STAGES - 1);  // into the stage the block finished with
    bf16* xs = stages + (i % PW_STAGES) * PW_STAGE;
    const bf16* gs = xs + PW_RS * T.xn * 8;
    if (T.db >= 0 && tid < T.gn * 8) {  // every row of the stage
#pragma unroll
      for (int q = 0; q < GROUPS; ++q)
#pragma unroll 8
        for (int r = 0; r < 32; ++r)
          dbs += from_bf(gs[(q * T.gn + (tid >> 3)) * F_J + r * 8 + (tid & 7)]);
    }
    if (rows_here) {
      const unsigned xa = smem_u32(xs), ga = smem_u32(gs);
#pragma unroll
      for (int kk = 0; kk < PW_RS / 16; ++kk) {
        const int q = kk >> 1;  // the 32-row group of rows 16 kk .. 16 kk + 15
        unsigned a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int piece = ig * 4 + mt * 2 + a_m8, kind = (2 * kk + a_k8) & 3;
          ldsm_x4_t(a[mt], xa + ((q * T.xn + piece) * F_J + kind * F_S + (lane & 7) * 8) * 2);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (og * 8 + j * 2 >= T.gn) break;
          const int piece = og * 8 + j * 2 + b_n8, kind = (2 * kk + b_k8) & 3;
          unsigned bb[4];
          ldsm_x4_t(bb, ga + ((q * T.gn + piece) * F_J + kind * F_S + (lane & 7) * 8) * 2);
          mma_bf16(acc[0][2 * j], a[0], bb[0], bb[1]);
          mma_bf16(acc[1][2 * j], a[1], bb[0], bb[1]);
          mma_bf16(acc[0][2 * j + 1], a[0], bb[2], bb[3]);
          mma_bf16(acc[1][2 * j + 1], a[1], bb[2], bb[3]);
        }
      }
    }
  }

  float* out = part + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * part_row<L>();
  if (rows_here) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = ig * 32 + m * 16 + g + h * 8, n = og * 64 + j * 8 + 2 * t;
          if (k < T.xn * 8 && n < T.gn * 8)
            *reinterpret_cast<float2*>(out + T.out + (size_t)k * T.ldo + n) =
                make_float2(acc[m][j][2 * h], acc[m][j][2 * h + 1]);
        }
  }
  if (T.db >= 0 && tid < HID) out[L::w_total() + T.db * HID + tid] = tid < T.gn * 8 ? dbs : 0.0f;
}

// dW, dB = the chunks' partials added in chunk order; blockIdx.y is the scene
template <class L>
__global__ void shader_bwd_reduce_kernel(const float* __restrict__ part, int n_chunks,
                                         float* __restrict__ dW, float* __restrict__ dB) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= part_row<L>()) return;
  part += (size_t)blockIdx.y * n_chunks * part_row<L>();
  dW += blockIdx.y * L::w_total();
  dB += blockIdx.y * (size_t)L::NHEADS * 4 * HID;
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c) s += part[(size_t)c * part_row<L>() + i];
  if (i < L::w_total()) dW[i] = s;
  else dB[i - L::w_total()] = s;
}

// rows of the backward's scratch: n rounded up to the tile
inline int bwd_rows(int n) { return (n + PB - 1) / PB * PB; }

// Row chunks of the parameter pass: at least PW_MIN_ROWS rows each, at most
// PW_MAX_CHUNKS, PW_RS-row stages.
inline int pw_chunks(int m_rows) {
  const int c = m_rows / PW_MIN_ROWS;
  return c < 1 ? 1 : c > PW_MAX_CHUNKS ? PW_MAX_CHUNKS : c;
}

inline int pw_chunk_rows(int m_rows) {
  const int c = pw_chunks(m_rows);
  return ((m_rows + c - 1) / c + PW_RS - 1) / PW_RS * PW_RS;
}

// The launches take S scenes (grid dimension y; z for the parameter pass):
// scene s's rows are rows s n .. (s + 1) n - 1 of every row array, its
// weights W + s w_total, its biases B + s NHEADS 4 256, its scratch and
// partials the s-th of S equal parts, its dW and dB the s-th rows. Each
// scene's blocks run the one-scene code on its own pointers (scene_offsets),
// so a scene's outputs and gradients are those of its one-scene launch to
// the bit.
template <class L>
int launch_fwd(const float* geo, const float* feats, int n, int n_scenes, const bf16* W,
               const float* B, const float* tab, float* out, cudaStream_t stream) {
  constexpr size_t smem = b_smem(n_fwd_slabs<L>());
  static_assert(smem <= 232448, "forward shared memory");
  const cudaError_t err = cudaFuncSetAttribute(
      shader_fwd_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  shader_fwd_kernel<L><<<dim3((n + PB - 1) / PB, n_scenes), NTHREADS, smem, stream>>>(
      geo, feats, n, W, B, tab, out);
  return (int)cudaGetLastError();
}

template <class L>
int launch_bwd_sweep(const float* geo, const float* feats, int n, int n_scenes, const bf16* W,
                     const float* B, const float* tab, const float* gout, float* dgeo,
                     float* dfeats, bf16* scratch, cudaStream_t stream) {
  constexpr size_t smem = b_smem(n_slabs<L>());
  static_assert(smem <= 232448, "sweep shared memory");
  const cudaError_t err = cudaFuncSetAttribute(
      shader_bwd_sweep_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int m = bwd_rows(n);
  shader_bwd_sweep_kernel<L><<<dim3(m / PB, n_scenes), NTHREADS, smem, stream>>>(
      geo, feats, n, W, B, tab, gout, dgeo, dfeats, scratch, m);
  return (int)cudaGetLastError();
}

template <class L>
int launch_bwd_params(int n, int n_scenes, bf16* scratch, float* part, float* dW, float* dB,
                      cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      shader_bwd_params_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)PW_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int m = bwd_rows(n), n_chunks = pw_chunks(m);
  shader_bwd_params_kernel<L>
      <<<dim3(n_items<L>(), n_chunks, n_scenes), PW_THREADS, PW_SMEM, stream>>>(
          scratch, m, pw_chunk_rows(m), part);
  shader_bwd_reduce_kernel<L>
      <<<dim3((unsigned)((part_row<L>() + 255) / 256), n_scenes), 256, 0, stream>>>(
          part, n_chunks, dW, dB);
  return (int)cudaGetLastError();
}

// call fn<Var<sphere, human>>(args...) for the runtime variant
#define SHADER_DISPATCH(fn, sphere, human, ...)                      \
  ((sphere) ? ((human) ? fn<Var<true, true>>(__VA_ARGS__)            \
                       : fn<Var<true, false>>(__VA_ARGS__))          \
            : ((human) ? fn<Var<false, true>>(__VA_ARGS__)           \
                       : fn<Var<false, false>>(__VA_ARGS__)))

template <class L> size_t weight_elems_of(int) { return L::w_total(); }
template <class L> size_t scratch_elems_of(int n) {
  return BwdScratch<L>::elems((size_t)bwd_rows(n));
}
template <class L> size_t part_elems_of(int n) {
  return (size_t)pw_chunks(bwd_rows(n)) * part_row<L>();
}

}  // namespace

extern "C" {

size_t shader_weight_elems(int sphere, int human) {
  return SHADER_DISPATCH(weight_elems_of, sphere, human, 0);
}
int shader_tile() { return PB; }  // rows per block, both directions
// bf16 elements of the backward's scratch, floats of its partials, for n rows
// of one scene (S scenes take S times as many)
size_t shader_scratch_elems(int n, int sphere, int human) {
  return SHADER_DISPATCH(scratch_elems_of, sphere, human, n);
}
size_t shader_part_elems(int n, int sphere, int human) {
  return SHADER_DISPATCH(part_elems_of, sphere, human, n);
}

// S scenes of n rows each (S = 1: one weight set). geo [S,n,9] (pts,
// normal, view) or, with human, [S,n,21] (+ R row-major, t); feats
// [S,n,256]; W [S, w_total] packed bf16 heads; B [S,6 or 7,4,256] f32; tab =
// the IDE table, shared; out [S,n,24].
int shader_fwd_scenes(const float* geo, const float* feats, int n, int n_scenes, const bf16* W,
                      const float* B, const float* tab, int sphere, int human, float* out,
                      cudaStream_t stream) {
  if (n <= 0 || n_scenes <= 0) return 0;
  return SHADER_DISPATCH(launch_fwd, sphere, human, geo, feats, n, n_scenes, W, B, tab, out,
                         stream);
}

// The backward's first part: recompute and reverse sweep, gout [S,n,24] ->
// dgeo [S,n,9], dfeats [S,n,256], and the scratch (S shader_scratch_elems
// bf16) for the second.
int shader_bwd_sweep_scenes(const float* geo, const float* feats, int n, int n_scenes,
                            const bf16* W, const float* B, const float* tab, int sphere,
                            int human, const float* gout, float* dgeo, float* dfeats,
                            bf16* scratch, cudaStream_t stream) {
  if (n <= 0 || n_scenes <= 0) return 0;
  return SHADER_DISPATCH(launch_bwd_sweep, sphere, human, geo, feats, n, n_scenes, W, B, tab,
                         gout, dgeo, dfeats, scratch, stream);
}

// The second: dW [S, w_total] (packed layout, f32) and dB [S,6 or 7,4,256]
// from the scratch; part holds S shader_part_elems floats.
int shader_bwd_params_scenes(int n, int n_scenes, int sphere, int human, bf16* scratch,
                             float* part, float* dW, float* dB, cudaStream_t stream) {
  if (n <= 0 || n_scenes <= 0) return 0;
  return SHADER_DISPATCH(launch_bwd_params, sphere, human, n, n_scenes, scratch, part, dW, dB,
                         stream);
}

// Both parts, three launches. With no rows nothing is launched: dW and dB
// stay as the caller made them.
int shader_bwd_scenes(const float* geo, const float* feats, int n, int n_scenes, const bf16* W,
                      const float* B, const float* tab, int sphere, int human, const float* gout,
                      float* dgeo, float* dfeats, bf16* scratch, float* part, float* dW,
                      float* dB, cudaStream_t stream) {
  if (n <= 0 || n_scenes <= 0) return 0;
  const int rc = shader_bwd_sweep_scenes(geo, feats, n, n_scenes, W, B, tab, sphere, human,
                                         gout, dgeo, dfeats, scratch, stream);
  if (rc) return rc;
  return shader_bwd_params_scenes(n, n_scenes, sphere, human, scratch, part, dW, dB, stream);
}

// One scene: the entries above at S = 1.
int shader_fwd(const float* geo, const float* feats, int n, const bf16* W, const float* B,
               const float* tab, int sphere, int human, float* out, cudaStream_t stream) {
  return shader_fwd_scenes(geo, feats, n, 1, W, B, tab, sphere, human, out, stream);
}

int shader_bwd_sweep(const float* geo, const float* feats, int n, const bf16* W, const float* B,
                     const float* tab, int sphere, int human, const float* gout, float* dgeo,
                     float* dfeats, bf16* scratch, cudaStream_t stream) {
  return shader_bwd_sweep_scenes(geo, feats, n, 1, W, B, tab, sphere, human, gout, dgeo, dfeats,
                                 scratch, stream);
}

int shader_bwd_params(int n, int sphere, int human, bf16* scratch, float* part, float* dW,
                      float* dB, cudaStream_t stream) {
  return shader_bwd_params_scenes(n, 1, sphere, human, scratch, part, dW, dB, stream);
}

int shader_bwd(const float* geo, const float* feats, int n, const bf16* W, const float* B,
               const float* tab, int sphere, int human, const float* gout, float* dgeo,
               float* dfeats, bf16* scratch, float* part, float* dW, float* dB,
               cudaStream_t stream) {
  return shader_bwd_scenes(geo, feats, n, 1, W, B, tab, sphere, human, gout, dgeo, dfeats,
                           scratch, part, dW, dB, stream);
}

}  // extern "C"
