// The SDF network's layout, leaf functions and forward engine, shared by the
// SDF-with-gradient kernel (sdf_grad.cu, B1) and the value-only kernel
// (sdf_fwd.cu, B6): PE(multires) on the scaled point (NPE = 3 + 6 multires
// channels, padded to PEW, a multiple of 16), nine weight-norm layers 256
// wide (layer 3 is 256 - NPE wide and feeds the skip; layer 4 reads [h3, PE]
// as two products, w4a and w4b, both pre-scaled by 1/sqrt(2) when packed),
// 257 outputs (padded to 272), softplus(beta x)/beta between the layers.
// ops/sdf_grad.py::pack_weights writes this layout.
//
// The PE's octaves are the build's: -DNERO_SDF_MULTIRES=1..20 (6 unless
// given: 39 channels padded to 48, layer 3 217 wide), the range of
// nero_tpu's kernels (3 + 6 multires <= PE_PAD 128). Up to PEW 64 (multires
// 10) the block's shared memory holds the PE tile beside 128-row weight
// slabs; above it the slabs are 64 rows (the ring then halves), since a
// 128-wide PE tile and 128-row slabs exceed the 227 KB of a block. The slab
// size changes neither the order of the sums (k from 0 up in steps of 16)
// nor any bit.
//
// The engine (sdf_grad.cu's header comment gives its design and what the
// card said of it): a block of 16 warps, warp w on row group w / NQ and
// columns 64 (w % NQ) .. +63 of a layer, MT m16n8k16 row tiles a warp
// (64 MT f32 accumulators a lane); the weights stream through a 2-stage ring
// of bf16 slabs in shared memory, filled by 16-byte cp.async copies; the
// epilogue runs in registers and writes each layer once, bf16, into the
// activation tile. It is templated on the row kinds of a tile:
//  * KINDS = 4 (B1): a row group is 8 points, each with its primal row and
//    its three tangent rows (MT = 2: tile 0 holds primal then d/dx, tile 1
//    d/dy then d/dz), so a lane holds z_primal and the three z_tangent of one
//    point at the same columns: the bias on the primal row, the tangent rule
//    u' = sigmoid(beta z) * (u @ W), the mask;
//  * KINDS = 1 (B6): every row is a point's primal row (16 MT points a
//    group); the sigmoid is not formed.
// The primal arithmetic is the same code in both (PE, k from 0 up in steps
// of 16, w4a before w4b into the same sums, the bias after the product,
// div_beta), so B6's sdf equals B1's to the bit. What keeps the engine from
// the bound: every block streams all its weights from L2 through the ring,
// a block barrier a slab, and the epilogue runs between the products, not
// beside them (with one kind, a softplus on every element); mma.sync, not
// the warpgroup products.
#pragma once

#include "mma.cuh"

namespace nero {
namespace sdfnet {

#ifndef NERO_SDF_MULTIRES
#define NERO_SDF_MULTIRES 6
#endif

constexpr int HID = 256;
constexpr int MULTIRES = NERO_SDF_MULTIRES;  // PE octaves
constexpr int NPE = 3 + 6 * MULTIRES;        // PE channels
constexpr int PEW = (NPE + 15) / 16 * 16;    // padded to a k step
constexpr int OUTW = 272;                    // 257 outputs padded
constexpr int MASK_W = HID - NPE;            // layer-3 width
static_assert(MULTIRES >= 1 && PEW <= 128, "the kernels take multires 1-20");

// packed bf16 weights, [in, out] row-major each, in this order
constexpr size_t SZ_PE = (size_t)PEW * HID, SZ_H = (size_t)HID * HID;
constexpr size_t OFF_W0 = 0;
constexpr size_t OFF_W1 = OFF_W0 + SZ_PE;
constexpr size_t OFF_W2 = OFF_W1 + SZ_H;
constexpr size_t OFF_W3 = OFF_W2 + SZ_H;
constexpr size_t OFF_W4A = OFF_W3 + SZ_H;
constexpr size_t OFF_W4B = OFF_W4A + SZ_H;
constexpr size_t OFF_W5 = OFF_W4B + SZ_PE;
constexpr size_t OFF_W6 = OFF_W5 + SZ_H;
constexpr size_t OFF_W7 = OFF_W6 + SZ_H;
constexpr size_t OFF_W8 = OFF_W7 + SZ_H;
constexpr size_t W_TOTAL = OFF_W8 + (size_t)HID * OUTW;

__host__ __device__ constexpr size_t layer_off(int l) {
  return l == 0 ? OFF_W0 : l == 1 ? OFF_W1 : l == 2 ? OFF_W2 : l == 3 ? OFF_W3
       : l == 4 ? OFF_W4A : l == 5 ? OFF_W5 : l == 6 ? OFF_W6 : l == 7 ? OFF_W7 : OFF_W8;
}

// softplus(beta z) / beta in its overflow-safe form, with the IEEE division
// (the engine takes div_beta: the same bits without the division's branch)
__device__ __forceinline__ float softplus_b(float z, float beta) {
  const float x = beta * z;
  return (fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)))) / beta;
}

// ---------------------------------------------------------------------------
// the forward engine
// ---------------------------------------------------------------------------

constexpr int WN = 8;           // n8-tiles a warp holds in layers 0-7: 64 columns
constexpr int NQ = HID / (8 * WN);             // column groups: warps per row group
constexpr int F_THREADS = 4 * NQ * 32;         // 4 row groups
constexpr int LDP = PEW + 8;    // PE tile [rows][LDP] bf16 (bank skew)
constexpr int LDH = HID + 8;    // activation tile [rows][LDH] bf16
constexpr int SLAB_K = PEW > 64 ? 64 : 128;  // weight rows (forward) or columns (sweep) per slab
constexpr int LDB = OUTW + 8;   // forward slab [SLAB_K][LDB] bf16
constexpr int LDT = SLAB_K + 8; // sweep slab [HID][LDT] bf16
constexpr int STAGES = 2;
constexpr int STAGE_ELEMS = SLAB_K * LDB > HID * LDT ? SLAB_K * LDB : HID * LDT;
constexpr int PE_SLABS = (PEW + SLAB_K - 1) / SLAB_K, H_SLABS = HID / SLAB_K;
constexpr int HIDDEN_SLABS = 2 * PE_SLABS + 7 * H_SLABS;  // w0, w1-w4a, w4b, w5-w7
constexpr int N_SLABS = HIDDEN_SLABS + H_SLABS;           // the forwards': and w8
constexpr int W8_KSLABS = (OUTW + SLAB_K - 1) / SLAB_K;
constexpr int B_SLABS = HIDDEN_SLABS + W8_KSLABS + 7 * H_SLABS;  // the backward's: W8^T .. W1^T
constexpr int SDF_COLS = 8;     // B6's part of w8: the n8-tile of the sdf column

// The backward's scratch lies in device memory in pieces, not rows: a piece
// is one kind's 8 rows x 8 columns of a point group (128 bytes), and a point
// group of width W is its W / 8 column pieces in order, the groups in the
// tile order. Element (row r, column c) of a width-W array is at
// piece_off(r, c, W). A warp's accumulators hold whole pieces, so its stores
// and loads of one (n8-tile, kind) are 128 contiguous bytes; a stage of the
// parameter pass is two contiguous runs, copied as they lie, and ldmatrix
// reads its 8 x 8 matrices as whole pieces.
constexpr int F_S = 64, F_J = 4 * F_S;  // a kind's 8 x 8 block; a column piece of 4 kinds
__host__ __device__ constexpr size_t piece_off(size_t r, int c, int W) {
  return ((r >> 5) * (W / 8) + (c >> 3)) * F_J + ((r >> 3) & 3) * F_S + (r & 7) * 8 + (c & 7);
}

// A slab of a weight stream: `rows` rows of `cols` columns at element offset
// `off` of the packed weights, row stride ldg there and lds in the ring.
struct Slab {
  size_t off;
  int rows, cols, ldg, lds;
};

// The weight streams: B1's forward, B1's backward, B6's.
enum Stream { FWD_STREAM, BWD_STREAM, VALUE_STREAM };

// Slab s of a stream. FWD_STREAM: w0 w1 w2 w3 w4a w4b w5 w6 w7 w8 in
// SLAB_K-row slabs, the packed order. BWD_STREAM: the same up to w7 (the
// recompute), then the reverse sweep's W8, W7, W6, W5, W4a, W3, W2, W1, each
// in slabs of SLAB_K of its output columns with all 256 input rows.
// VALUE_STREAM: the same up to w7, then of w8 the sdf column's n8-tile alone
// (SDF_COLS columns of every row), so it is no prefix of the others.
template <int S>
__device__ __forceinline__ Slab slab_at(int s) {
  if (S == BWD_STREAM && s >= HIDDEN_SLABS) {
    s -= HIDDEN_SLABS;
    const int l = s < W8_KSLABS ? 8 : 7 - (s - W8_KSLABS) / H_SLABS;
    const int j = s < W8_KSLABS ? s : (s - W8_KSLABS) % H_SLABS;
    const int n = l == 8 ? OUTW : HID;
    return {layer_off(l) + (size_t)j * SLAB_K, HID, min(SLAB_K, n - j * SLAB_K), n, LDT};
  }
  if (S == VALUE_STREAM && s >= HIDDEN_SLABS)
    return {OFF_W8 + (size_t)(s - HIDDEN_SLABS) * SLAB_K * OUTW, SLAB_K, SDF_COLS, OUTW, LDB};
  int p, j;  // product (0 = w0, 1-4 = w1 w2 w3 w4a, 5 = w4b, 6-9 = w5 w6 w7 w8), slab in it
  constexpr int E = PE_SLABS, Hs = H_SLABS;
  if (s < E) { p = 0; j = s; }
  else if (s < E + 4 * Hs) { p = 1 + (s - E) / Hs; j = (s - E) % Hs; }
  else if (s < 2 * E + 4 * Hs) { p = 5; j = s - E - 4 * Hs; }
  else { p = 6 + (s - 2 * E - 4 * Hs) / Hs; j = (s - 2 * E - 4 * Hs) % Hs; }
  const size_t off = p == 0 ? OFF_W0 : p == 5 ? OFF_W4B
                   : p < 5 ? OFF_W1 + (p - 1) * SZ_H : OFF_W5 + (p - 6) * SZ_H;
  const int k = (p == 0 || p == 5) ? PEW : HID;
  const int n = p == 9 ? OUTW : HID;
  return {off + (size_t)j * SLAB_K * n, min(SLAB_K, k - j * SLAB_K), n, n, LDB};
}

// The ring of weight slabs. next() waits for the oldest slab, makes it (and
// every shared-memory write before the call) visible to the block, refills
// the stage that the block finished with, and returns the slab's
// shared-memory address.
template <int S>
struct Ring {
  static constexpr int COUNT = S == BWD_STREAM ? B_SLABS : N_SLABS;
  bf16* base;
  const bf16* W;
  int slab;

  __device__ __forceinline__ void load(int s) const {
    if (s < COUNT) {
      const Slab sl = slab_at<S>(s);
      bf16* st = base + (s % STAGES) * STAGE_ELEMS;
      const int cpr = sl.cols / 8;  // 16-byte chunks per row
      for (int v = threadIdx.x; v < sl.rows * cpr; v += F_THREADS) {
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
// columns] for the warp's MT row tiles, k in steps of 16 from 0 up, B from
// the ring: the forward's slabs [k][n] (ldmatrix.trans) or, WT, the sweep's
// [n][k], which are W^T's fragments without .trans. x: this lane's ldmatrix
// address in the warp's first row of X (leading dim ldx); col0: the warp's
// first column.
template <bool WT, int MT, class R>
__device__ __forceinline__ void product(float (&acc)[MT][WN][4], R& ring, unsigned x, int ldx,
                                        int K, int col0) {
  const int lane = threadIdx.x & 31;
  const unsigned lane_b = WT ? (x4_lane(lane, LDT) + col0 * LDT) * 2
                             : ((lane & 15) * LDB + (lane >> 4) * 8 + col0) * 2;
  for (int k0 = 0; k0 < K; k0 += SLAB_K) {
    const unsigned b = ring.next() + lane_b;
    const int ksteps = min(SLAB_K, K - k0) / 16;
#pragma unroll 1  // unrolled, the k steps spill at the 128 registers of 512 threads
    for (int kk = 0; kk < ksteps; ++kk) {
      unsigned a[MT][4];
      ldsm_x4(a[0], x + (k0 + kk * 16) * 2);
      if constexpr (MT == 2) ldsm_x4(a[1], x + (16 * ldx + k0 + kk * 16) * 2);
#pragma unroll
      for (int j = 0; j < WN / 2; ++j) {
        unsigned bb[4];
        if (WT) ldsm_x4(bb, b + (j * 16 * LDT + kk * 16) * 2);
        else ldsm_x4_t(bb, b + (kk * 16 * LDB + j * 16) * 2);
        mma_bf16(acc[0][2 * j], a[0], bb[0], bb[1]);
        if constexpr (MT == 2) mma_bf16(acc[1][2 * j], a[1], bb[0], bb[1]);
        mma_bf16(acc[0][2 * j + 1], a[0], bb[2], bb[3]);
        if constexpr (MT == 2) mma_bf16(acc[1][2 * j + 1], a[1], bb[2], bb[3]);
      }
    }
  }
}

// x / beta rounded to nearest, given inv = 1/beta rounded to nearest: q is
// within an ulp of the quotient, r = x - q beta is exact, and q + r inv
// rounds to the correctly rounded quotient (Markstein's theorem), so this is
// softplus_b's IEEE division bit for bit wherever no value is subnormal,
// without the branch to the division's slow path that keeps the compiler
// from interleaving the epilogue's elements.
__device__ __forceinline__ float div_beta(float x, float beta, float inv) {
  const float q = x * inv;
  const float r = fmaf(-q, beta, x);
  return fmaf(r, inv, q);
}

// The PE tile of 64 MT rows. KINDS = 4: PE(multires) of the scaled points and its
// tangents w.r.t. the unscaled points, rows in the tile order (row 32g + 8s
// + i: kind s of point 8g + i), and to PEg (device memory, in pieces) where
// it is given; the tile's points all exist (B1's wrapper pads n), so n is
// not read. KINDS = 1: row r is PE(multires) of point p0 + r, zero (and the
// point never read) past n. Octave i is sin / cos of 2^i x, 2^i exact in f32
// as in nero_tpu's constant table (sdf_grad_kernel.py::_pe_consts).
template <int KINDS, int MT>
__device__ __forceinline__ void pe_tile(bf16* PEb, const float* __restrict__ pts, int p0, int n,
                                        float scale, bf16* PEg) {
  constexpr int ROWS = 4 * 16 * MT;
  for (int idx = threadIdx.x; idx < ROWS * PEW; idx += F_THREADS) {
    const int row = idx / PEW, c = idx % PEW;
    if constexpr (KINDS == 4) {
      const int s = (row >> 3) & 3, r = (row >> 5) * 8 + (row & 7);
      float v = 0.0f;
      if (c < 3) {
        v = s == 0 ? pts[(p0 + r) * 3 + c] * scale : (c == s - 1 ? scale : 0.0f);
      } else if (c < NPE) {
        const int i = (c - 3) / 6, q = (c - 3) % 6, k = q % 3;
        const bool is_cos = q >= 3;
        const float f = (float)(1 << i);
        const float x = pts[(p0 + r) * 3 + k] * scale * f;
        if (s == 0) v = is_cos ? cosf(x) : sinf(x);
        else if (k == s - 1) v = scale * f * (is_cos ? -sinf(x) : cosf(x));
      }
      PEb[row * LDP + c] = to_bf(v);
      if (PEg) PEg[piece_off(row, c, PEW)] = to_bf(v);
    } else {
      float v = 0.0f;
      if (p0 + row < n) {
        if (c < 3) {
          v = pts[(p0 + row) * 3 + c] * scale;
        } else if (c < NPE) {
          const int i = (c - 3) / 6, q = (c - 3) % 6, k = q % 3;
          const float f = (float)(1 << i);
          const float x = pts[(p0 + row) * 3 + k] * scale * f;
          v = q >= 3 ? cosf(x) : sinf(x);
        }
      }
      PEb[row * LDP + c] = to_bf(v);
    }
  }
}

// Layers 0-7 of the tile, each layer's activations into the activation tile
// H (bf16). Hg (B1's backward recompute): also to device memory, from the
// accumulators, layer l at Hg + l * lstride in pieces.
template <int KINDS, int MT, class R>
__device__ __forceinline__ void hidden_layers(bf16* H, const bf16* PEb, R& ring,
                                              const float* __restrict__ bias, float beta,
                                              bf16* Hg, size_t lstride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = warp / NQ, cq = warp % NQ;  // row group, column group
  const int g = lane >> 2, t = lane & 3;      // accumulator row and column pair
  const float inv_beta = __frcp_rn(beta);
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;  // ldmatrix addressing
  const unsigned h_x = smem_u32(H + (grp * 16 * MT + lrow) * LDH + lcol);
  const unsigned pe_x = smem_u32(PEb + (grp * 16 * MT + lrow) * LDP + lcol);
  const int col0 = cq * WN * 8;
  const int goff = (int)piece_off(grp * 32 + g, col0 + 2 * t, HID);

  for (int l = 0; l < 8; ++l) {
    float acc[MT][WN][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
    if (l == 0) {
      product<false>(acc, ring, pe_x, LDP, PEW, col0);
    } else {
      product<false>(acc, ring, h_x, LDH, HID, col0);
      if (l == 4) product<false>(acc, ring, pe_x, LDP, PEW, col0);
    }
    __syncthreads();  // every warp is done reading this layer's input
    const float* bl = bias + l * OUTW + col0 + 2 * t;
    bf16* hrow = H + (grp * 16 * MT + g) * LDH + col0 + 2 * t;
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      const float2 b2 = *reinterpret_cast<const float2*>(bl + j * 8);
      if constexpr (KINDS == 4) {
        // primal softplus (bias first), tangents sigmoid(beta z_primal) * z_tangent
        float h[4][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float zp = acc[0][j][e] + (e ? b2.y : b2.x);
          const float x = beta * zp;
          const float ex = expf(-fabsf(x));  // softplus_b's, shared with the sigmoid
          const float sg = __fdividef(x >= 0.0f ? 1.0f : ex, 1.0f + ex);
          const bool masked = l == 3 && col0 + j * 8 + 2 * t + e >= MASK_W;
          h[0][e] = masked ? 0.0f : div_beta(fmaxf(x, 0.0f) + log1pf(ex), beta, inv_beta);
          h[1][e] = masked ? 0.0f : sg * acc[0][j][2 + e];
          h[2][e] = masked ? 0.0f : sg * acc[1][j][e];
          h[3][e] = masked ? 0.0f : sg * acc[1][j][2 + e];
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          *reinterpret_cast<__nv_bfloat162*>(hrow + s * 8 * LDH + j * 8) =
              __floats2bfloat162_rn(h[s][0], h[s][1]);
          if (Hg)
            *reinterpret_cast<__nv_bfloat162*>(Hg + l * lstride + goff + s * F_S + j * F_J) =
                __floats2bfloat162_rn(h[s][0], h[s][1]);
        }
      } else {
        // every row primal: softplus, bias first
#pragma unroll
        for (int s = 0; s < 2 * MT; ++s) {
          float h[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float zp = acc[s >> 1][j][2 * (s & 1) + e] + (e ? b2.y : b2.x);
            const float x = beta * zp;
            const float ex = expf(-fabsf(x));
            const bool masked = l == 3 && col0 + j * 8 + 2 * t + e >= MASK_W;
            h[e] = masked ? 0.0f : div_beta(fmaxf(x, 0.0f) + log1pf(ex), beta, inv_beta);
          }
          *reinterpret_cast<__nv_bfloat162*>(hrow + s * 8 * LDH + j * 8) =
              __floats2bfloat162_rn(h[0], h[1]);
        }
      }
    }
  }
}

}  // namespace sdfnet
}  // namespace nero
