// SDF MLP with its spatial gradient, forward and backward, for Hopper (sm_90a).
//
// Replaces nero_tpu/ops/pallas/sdf_grad_kernel.py::sdf_with_grad_fused
// (pallas_call nero_sdf_grad_fwd :363 and nero_sdf_grad_bwd :387).
//
// A tile is P = 32 points. Its PE(multires) and the PE's three tangents
// (d/dx, d/dy, d/dz) make 4P = 128 rows that run through the 9 layers
// together: the bias on primal rows only, the tangent rule u' = sigmoid(beta
// z) * (u @ W), the mask of layer 3 at its 256 - NPE columns (217 at the
// shipped multires 6; sdf_net.cuh builds any multires 1-20) and the skip
// layer as two products (w4a on h3, w4b on the PE), bf16 operands with f32
// sums. The figures below (slabs, shared memory, times) are multires 6's.
//
// Forward (sdf_grad_fwd_kernel): one block of 16 warps per tile. Warp w
// owns points 8(w/4) .. 8(w/4)+7 and output columns 64(w%4) .. +63, as two
// m16n8k16 row tiles: tile 0 holds the points' primal rows and then their
// d/dx rows, tile 1 their d/dy and then d/dz rows. In the mma.sync
// accumulator layout a lane then holds z_primal and the three z_tangent of
// one point at the same two columns, so bias, softplus, the tangent rule and
// the mask run in registers (64 f32 accumulators a lane) and each layer goes
// once, as bf16, into the activation tile in shared memory; there is no f32
// C tile. The ten products (w0 w1 w2 w3 w4a w4b w5 w6 w7 w8, which is the
// packed order) are one stream of 18 k-slabs of up to 128 rows, staged by
// 16-byte cp.async copies through a 2-stage ring in shared memory, so the
// next slab, and the next layer's first one, is in flight while the tensor
// cores or the epilogue work. B fragments come from the ring with
// ldmatrix.trans (the weights are [in, out] row-major), A fragments from
// the activation tile with ldmatrix. Layer 8 runs tile 0 on all 34 n8-tiles
// and tile 1 on the sdf column's n8-tile alone: grad needs nothing else.
// The ring, the product, the PE and layers 0-7 are sdf_net.cuh's engine at
// four row kinds, which the value-only kernel (sdf_fwd.cu) runs at one: k
// runs in steps of 16 from 0 up, w4a before w4b into the same sums, the
// bias is added after the product, the PE is the same code and softplus_b's
// division is done without its slow-path branch but to the same bits
// (div_beta), so the primal rows equal the value-only kernel's to the bit.
// 225,280 bytes of shared memory, 512 threads of at most 128 registers: one
// block per SM.
//
// Where the card said otherwise than the first design (nero_tpu_torch/
// kernel_variants.py times each choice undone, PERF.md): 8 warps of 128
// columns each leave 2 warps a scheduler, too few to hide the epilogue's
// latency; slabs of 32 rows through 4 stages pay a block barrier every 32 k
// rows; the IEEE divisions branch to a slow path for every element and keep
// the compiler from interleaving them (the tangent rule's sigmoid needs no
// correct rounding and takes __fdividef). Deeper rings and TMA bulk copies
// of the slab rows were slower.
//
// Bound: tensor-core operations at 989 TFLOP/s bf16 (ops/sdf_grad.py::flops:
// 4 stacked rows through layers 0-7; of layer 8 the primal row needs all 257
// outputs and a tangent row the sdf column alone), 0.252 ms at N = 65,536.
// What keeps the forward from it: every block reads all 1.1 MB of packed
// weights from L2, 2.3 GB a call at N = 65,536, and the weight stream alone,
// with no products and no epilogue, takes most of the kernel's time
// (sharing the slabs across a cluster with TMA multicast is later work);
// then the epilogue, which the 2-stage ring overlaps with one slab only;
// mma.sync, not the warpgroup products; tile 0 carries the d/dx rows
// through all of layer 8.
//
// Backward (sdf_grad_bwd): where the TPU kept nine stacked pre-activations
// of its row block in VMEM (4.7 MB) and accumulated dW across a sequential
// grid, a Hopper block has 227 KB and blocks run in no order. So it is two
// kernels and a reduction, three launches:
//  * sdf_bwd_sweep_kernel, one block per tile on the forward's engine. The
//    recompute is the forward's layers 0-7 (the same hidden_layers), which
//    also stores each layer's activations H, bf16, from the accumulators (and
//    the PE). Then the reverse sweep, layers 8 -> 1: GH = GZ_l @ W_l^T on
//    mma.sync, the weights streamed by the same ring as slabs of 128 of their
//    output columns ([in, k], so ldmatrix without .trans gives W^T's
//    fragments), and the second-order through_act of
//    sdf_grad_kernel.py:297-309 in registers on the same accumulator layout:
//    a lane reads back the H it wrote (h_p and the h_t of one point at its two
//    columns), takes s = sigmoid(beta z_p) = 1 - exp(-beta h_p), and forms
//    gz_p = s gh_p + beta (1 - s) sum_t h_t gh_t and gz_t = s gh_t (the TPU
//    kernel's s2 sum_t z_t gh_t, with s z_t = h_t). Each GZ_l goes once, bf16,
//    to device memory and to the cotangent tile, the next product's A operand.
//  * sdf_bwd_params_kernel, dW_l = H_l^T GZ_l for the ten packed products
//    (w0 and w4b take the PE as H) in one launch over (product, 128-row half
//    of its input, row chunk), mma.sync on stages of one tile's rows through
//    a 2-stage cp.async ring; db_l, the column sums of GZ_l's primal rows,
//    rides along in the blocks of the first half.
//  * sdf_bwd_reduce_kernel adds the chunks' partials in chunk order (no
//    atomics: the same gradients every run) into dW and db.
// The scratch lies in pieces (piece_off), so the sweep's stores and loads
// and the parameter pass's copies are whole 128-byte runs. Point gradients
// are not produced: sample positions are detached upstream, as on the TPU
// (sdf_grad_kernel.py:431-432).
//
// Where the card said otherwise than the first design (kernel_variants.py,
// PERF.md): storing Z, as the TPU kernel does, and forming H from it in the
// parameter pass costs that pass more than the stores of H cost the sweep;
// the scratch in rows, not pieces, costs the sweep's scattered 4-byte stores
// and loads. Bound: 0.745 ms at N = 65,536 (operations). What keeps it from
// it: the recompute and the sweep each stream all the weights from L2 for
// every tile (as the forward does), then the scratch round trip (H and GZ,
// 2.3 GB at N = 65,536; the parameter pass reads GZ twice, once for each
// half of a product's input).
#include "sdf_net.cuh"

using namespace nero;
using namespace nero::sdfnet;

namespace {

constexpr int P = 32;           // points per tile
constexpr int ROWS = 4 * P;     // primal + 3 tangent rows
constexpr int L8 = (OUTW / 8 + NQ - 1) / NQ;   // n8-tiles a warp holds in layer 8
constexpr int LDG = OUTW + 8;   // the sweep's cotangent tile [ROWS][LDG] bf16, over H and the PE
constexpr int LDO = 260;        // f32 output staging [P][LDO], over the activations
constexpr size_t F_SMEM = ((size_t)ROWS * LDH + (size_t)ROWS * LDP + (size_t)STAGES * STAGE_ELEMS) * 2;
static_assert(ROWS == 4 * 16 * 2, "the engine's tile: 4 row groups of two m16 tiles");
static_assert(F_SMEM <= 232448, "forward shared memory");
static_assert((size_t)P * LDO * 4 + P * 3 * 4 <= (size_t)ROWS * LDH * 2, "output staging");
static_assert(ROWS * LDG <= ROWS * (LDH + LDP), "cotangent tile");

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(F_THREADS, 1)
sdf_grad_fwd_kernel(const float* __restrict__ pts, const bf16* __restrict__ W,
                    const float* __restrict__ bias, float beta, float scale,
                    float* __restrict__ out_sdf, float* __restrict__ out_grad,
                    float* __restrict__ out_feats) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* H = reinterpret_cast<bf16*>(smem);  // rows 32g + 8s + i: kind s of point 8g + i
  bf16* PEb = H + ROWS * LDH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp / NQ, cq = warp % NQ;  // point group, column group
  const int g = lane >> 2, t = lane & 3;      // accumulator row and column pair
  // blockIdx.y is the scene: its weights and biases; its rows follow the
  // rows of the scenes before it, gridDim.x tiles a scene
  const int p0 = (blockIdx.y * gridDim.x + blockIdx.x) * P;
  W += blockIdx.y * (size_t)W_TOTAL;
  bias += blockIdx.y * 9 * OUTW;

  Ring<FWD_STREAM> ring{PEb + ROWS * LDP, W, 0};
  for (int s = 0; s < STAGES - 1; ++s) ring.load(s);
  pe_tile<4, 2>(PEb, pts, p0, p0 + P, scale, nullptr);
  hidden_layers<4, 2>(H, PEb, ring, bias, beta, nullptr, 0);

  // layer 8: tile 0 (primal, d/dx) on the warp's L8 n8-tiles of the 272
  // columns; tile 1 (d/dy, d/dz) on the sdf column's n8-tile alone
  const unsigned h_x = smem_u32(H + (grp * 32 + (lane & 15)) * LDH + (lane >> 4) * 8);
  float acc8[L8][4], accg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < L8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc8[j][e] = 0.0f;
  const int col8 = cq * L8 * 8;
  for (int k0 = 0; k0 < HID; k0 += SLAB_K) {
    const unsigned b = ring.next() + ((lane & 15) * LDB + (lane >> 4) * 8 + col8) * 2;
#pragma unroll
    for (int kk = 0; kk < SLAB_K / 16; ++kk) {
      unsigned a0[4], a1[4];
      ldsm_x4(a0, h_x + (k0 + kk * 16) * 2);
      if (cq == 0) ldsm_x4(a1, h_x + (16 * LDH + k0 + kk * 16) * 2);
#pragma unroll
      for (int j = 0; j < L8; ++j) {
        if (cq * L8 + j >= OUTW / 8) break;
        unsigned bb[2];
        ldsm_x2_t(bb, b + (kk * 16 * LDB + j * 8) * 2);
        mma_bf16(acc8[j], a0, bb[0], bb[1]);
        if (j == 0 && cq == 0) mma_bf16(accg, a1, bb[0], bb[1]);
      }
    }
  }
  __syncthreads();  // the activation tile becomes the output staging area

  float* O = reinterpret_cast<float*>(smem);  // [P][LDO]: sdf, feats[256]
  float* G = O + P * LDO;                     // [P][3]
  const int pt = grp * 8 + g;
#pragma unroll
  for (int j = 0; j < L8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = col8 + j * 8 + 2 * t + e;
      if (c <= HID) O[pt * LDO + c] = acc8[j][e] + bias[8 * OUTW + c];
    }
  if (cq == 0 && t == 0) {  // grad: the tangent rows' sdf column, no bias
    G[pt * 3 + 0] = acc8[0][2];
    G[pt * 3 + 1] = accg[0];
    G[pt * 3 + 2] = accg[2];
  }
  __syncthreads();
  for (int idx = tid; idx < P * 257; idx += F_THREADS) {
    const int r = idx / 257, c = idx % 257;
    const float v = O[r * LDO + c];
    if (c == 0) out_sdf[p0 + r] = v;
    else out_feats[(size_t)(p0 + r) * HID + c - 1] = v;
  }
  for (int idx = tid; idx < P * 3; idx += F_THREADS) out_grad[p0 * 3 + idx] = G[idx];
}

// ---------------------------------------------------------------------------
// backward: recompute and reverse sweep
// ---------------------------------------------------------------------------

// Scratch of the backward (bf16, in pieces), M = 4 n_pad stacked rows in
// the tile order: H[8][M][256], the activations of layers 0-7 as the
// forward formed them, which the sweep and the parameter pass both read
// (through_act needs s = sigmoid(beta z_p) = 1 - exp(-beta h_p) and the
// products s z_t = h_t); GZ[8][M][256]; GZ8[M][272]; PE[M][48].
struct Scratch {
  bf16 *H, *GZ, *GZ8, *PE;
  __host__ __device__ Scratch(bf16* base, size_t M) {
    H = base;
    GZ = H + 8 * M * HID;
    GZ8 = GZ + 8 * M * HID;
    PE = GZ8 + M * OUTW;
  }
  __host__ __device__ static size_t elems(size_t M) { return 16 * M * HID + M * (OUTW + PEW); }
};

__global__ void __launch_bounds__(F_THREADS, 1)
sdf_bwd_sweep_kernel(const float* __restrict__ pts, const bf16* __restrict__ W,
                     const float* __restrict__ bias, float beta, float scale, int n_pad,
                     const float* __restrict__ d_sdf, const float* __restrict__ d_grad,
                     const float* __restrict__ d_feats, bf16* __restrict__ scratch) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* H = reinterpret_cast<bf16*>(smem);
  bf16* PEb = H + ROWS * LDH;
  bf16* G = H;  // the sweep's cotangent tile [ROWS][LDG], over H and the PE
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp / NQ, cq = warp % NQ;
  const int g = lane >> 2, t = lane & 3;
  const int p0 = (blockIdx.y * gridDim.x + blockIdx.x) * P;  // the scene's rows, as forward
  const size_t M = 4 * (size_t)n_pad, row0 = (size_t)blockIdx.x * ROWS, LS = M * HID;
  W += blockIdx.y * (size_t)W_TOTAL;
  bias += blockIdx.y * 9 * OUTW;
  const Scratch S(scratch + blockIdx.y * Scratch::elems(M), M);  // a scratch per scene

  Ring<BWD_STREAM> ring{PEb + ROWS * LDP, W, 0};
  for (int s = 0; s < STAGES - 1; ++s) ring.load(s);
  pe_tile<4, 2>(PEb, pts, p0, p0 + P, scale, S.PE + row0 * PEW);
  hidden_layers<4, 2>(H, PEb, ring, bias, beta, S.H + row0 * HID, LS);
  __syncthreads();  // the activations and the PE give way to the cotangent tile

  // layer 8's cotangent: primal rows [d_sdf, d_feats], the tangent row of
  // kind s carries d_grad_s in the sdf column
  for (int idx = tid; idx < ROWS * OUTW / 2; idx += F_THREADS) {
    const int row = idx / (OUTW / 2), c = 2 * (idx % (OUTW / 2));
    const int s = (row >> 3) & 3, r = (row >> 5) * 8 + (row & 7);
    float g0 = 0.0f, g1 = 0.0f;
    if (s == 0) {
      const size_t f = (size_t)(p0 + r) * HID;  // column c holds feats c - 1
      g0 = c == 0 ? d_sdf[p0 + r] : c <= HID ? d_feats[f + c - 1] : 0.0f;
      g1 = c + 1 <= HID ? d_feats[f + c] : 0.0f;
    } else if (c == 0) {
      g0 = d_grad[(p0 + r) * 3 + s - 1];
    }
    const __nv_bfloat162 v = __floats2bfloat162_rn(g0, g1);
    *reinterpret_cast<__nv_bfloat162*>(G + row * LDG + c) = v;
    *reinterpret_cast<__nv_bfloat162*>(S.GZ8 + piece_off(row0 + row, c, OUTW)) = v;
  }

  const unsigned g_x = smem_u32(G + (grp * 32 + (lane & 15)) * LDG + (lane >> 4) * 8);
  const int col0 = cq * WN * 8;
  const size_t goff = piece_off(row0 + grp * 32 + g, col0 + 2 * t, HID);
  bf16* grow = G + (grp * 32 + g) * LDG + col0 + 2 * t;
  for (int l = 8; l >= 1; --l) {
    // cotangent of h_l = act(z_{l-1}): GH = GZ_l @ W_l^T (w4a for the skip)
    float acc[2][WN][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
    product<true>(acc, ring, g_x, LDG, l == 8 ? OUTW : HID, col0);
    __syncthreads();  // every warp is done reading the cotangent tile
    const int lp = l - 1;
    const bf16* hl = S.H + lp * LS + goff;
    bf16* gzl = S.GZ + lp * LS + goff;
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      float h[4][2], gz[4][2];  // h: the stored activations of layer lp
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float2 hf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(hl + s * F_S + j * F_J));
        h[s][0] = hf.x;
        h[s][1] = hf.y;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // through_act: h_p = softplus_b(z_p), h_t = s z_t with s = sigmoid(beta z_p),
        // so gz_p = s gh_p + beta s (1 - s) sum_t z_t gh_t and gz_t = s gh_t;
        // 1 - s = exp(-beta h_p), and s z_t = h_t takes the place of z_t
        const float gh[4] = {acc[0][j][e], acc[0][j][2 + e], acc[1][j][e], acc[1][j][2 + e]};
        const float x = beta * h[0][e];
        const float sg = -expm1f(-x), s2 = beta * expf(-x);
        const float mix = h[1][e] * gh[1] + h[2][e] * gh[2] + h[3][e] * gh[3];
        const bool masked = lp == 3 && col0 + j * 8 + 2 * t + e >= MASK_W;
        gz[0][e] = masked ? 0.0f : sg * gh[0] + s2 * mix;
#pragma unroll
        for (int s = 1; s < 4; ++s) gz[s][e] = masked ? 0.0f : sg * gh[s];
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(gz[s][0], gz[s][1]);
        *reinterpret_cast<__nv_bfloat162*>(gzl + s * F_S + j * F_J) = v;
        if (lp > 0) *reinterpret_cast<__nv_bfloat162*>(grow + s * 8 * LDG + j * 8) = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward: weight and bias gradients
// ---------------------------------------------------------------------------

constexpr int PW_THREADS = 512;  // 16 warps: a 128 x 256 tile of dW, 32 x 64 a warp
constexpr int PW_RS = 128;       // rows per stage: one tile, four point groups
constexpr int PW_STAGES = 2;
constexpr int PW_STAGE = PW_RS * (128 + HID);  // X's 128 columns at most, G's 256
constexpr size_t PW_SMEM = (size_t)PW_STAGES * PW_STAGE * 2;
constexpr int PW_TILES = 20;
constexpr int PW_MIN_ROWS = 4096;  // stacked rows per chunk, at least
constexpr size_t PART_ROW = W_TOTAL + 9 * OUTW;  // one chunk's partials: dW, then db
static_assert(PW_SMEM <= 232448, "parameter pass shared memory");

// One block's share of the parameter gradients: dW[out + k * ldo + n] for
// k < 8 xn, n < 8 gn = sum over the chunk's rows of X[row][8 xp + k]
// G[row][8 gp + n], X and G in pieces of widths xw and gw.
struct PwTile {
  const bf16 *X, *G;
  int xw, xp, xn;    // X: width, first column piece, pieces
  int gw, gp, gn;    // G: the same
  size_t out;
  int ldo;
  int db, db_col0, db_n;  // db[db][db_col0 + i], i < db_n: column sums (0 past G's); db < 0: none
};

// Tiles 0-15: w1 w2 w3 w4a w5 w6 w7 w8 (in 0-255 of the output columns),
// two 128-row halves of the input each; 16, 17: w0 and w4b on the PE;
// 18, 19: w8's output columns 256-271, two halves.
__device__ __forceinline__ PwTile pw_tile(int t, const Scratch& S, size_t M) {
  const size_t LS = M * HID;
  if (t < 16) {
    const int l = 1 + t / 2, it = t % 2, ldo = l == 8 ? OUTW : HID;
    return {S.H + (l - 1) * LS, l == 8 ? S.GZ8 : S.GZ + l * LS, HID, 16 * it, 16, ldo, 0, 32,
            layer_off(l) + (size_t)it * 128 * ldo, ldo, it == 0 ? l : -1, 0,
            l == 8 ? HID : OUTW};
  }
  if (t < 18) {
    const bool w0 = t == 16;
    return {S.PE, S.GZ + (w0 ? 0 : 4) * LS, PEW, 0, PEW / 8, HID, 0, 32,
            w0 ? OFF_W0 : OFF_W4B, HID, w0 ? 0 : -1, 0, OUTW};
  }
  const int it = t - 18;
  return {S.H + 7 * LS, S.GZ8, HID, 16 * it, 16, OUTW, 32, 2,
          OFF_W8 + (size_t)it * 128 * OUTW + HID, OUTW, it == 0 ? 8 : -1, HID, OUTW - HID};
}

__global__ void __launch_bounds__(PW_THREADS, 1)
sdf_bwd_params_kernel(bf16* __restrict__ scratch, int n_pad, int rows_per_chunk,
                      float* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);  // per stage X then G, each in pieces
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ig = warp / 4, og = warp % 4;  // the warp's 32 input rows and 64 output columns
  const int g = lane >> 2, t = lane & 3;
  const size_t M = 4 * (size_t)n_pad;
  // blockIdx.z is the scene: its scratch and its chunks' partials
  const PwTile T = pw_tile(blockIdx.x, Scratch(scratch + blockIdx.z * Scratch::elems(M), M), M);
  const int m0 = blockIdx.y * rows_per_chunk;
  const int n_st = max(0, min((int)M - m0, rows_per_chunk)) / PW_RS;
  constexpr int GROUPS = PW_RS / 32;

  // the stage's point groups, pieces p .. p + n - 1 of each: GROUPS runs of
  // n * F_J elements in device memory, 16 bytes a copy
  auto copy = [&](bf16* dst, const bf16* src, int w, int p, int n, size_t m) {
    const int run = n * F_J / 8;
    for (int v = tid; v < GROUPS * run; v += PW_THREADS) {
      const int q = v / run, c = (v - q * run) * 8;
      cp_async16(dst + q * n * F_J + c, src + (m / 32 + q) * (w / 8) * F_J + p * F_J + c);
    }
  };
  auto load = [&](int i) {
    if (i < n_st) {
      bf16* xs = stages + (i % PW_STAGES) * PW_STAGE;
      const size_t m = (size_t)m0 + (size_t)i * PW_RS;
      copy(xs, T.X, T.xw, T.xp, T.xn, m);
      copy(xs + PW_RS * T.xn * 8, T.G, T.gw, T.gp, T.gn, m);
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
  for (int i = 0; i < n_st; ++i) {
    cp_async_wait<PW_STAGES - 2>();
    __syncthreads();
    load(i + PW_STAGES - 1);  // into the stage the block finished with
    bf16* xs = stages + (i % PW_STAGES) * PW_STAGE;
    const bf16* gs = xs + PW_RS * T.xn * 8;
    if (T.db >= 0 && tid < T.gn * 8) {  // the primal rows: kind 0 of each group
#pragma unroll
      for (int q = 0; q < GROUPS; ++q)
#pragma unroll
        for (int r = 0; r < 8; ++r)
          dbs += from_bf(gs[(q * T.gn + (tid >> 3)) * F_J + r * 8 + (tid & 7)]);
    }
    if (rows_here) {
      const unsigned xa = smem_u32(xs), ga = smem_u32(gs);
#pragma unroll
      for (int kk = 0; kk < PW_RS / 16; ++kk) {
        const int q = kk >> 1;  // the point group of rows 16 kk .. 16 kk + 15
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

  float* out = part + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * PART_ROW;
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
  if (T.db >= 0 && tid < T.db_n)
    out[W_TOTAL + T.db * OUTW + T.db_col0 + tid] = tid < T.gn * 8 ? dbs : 0.0f;
}

// dW, db = the chunks' partials added in chunk order; blockIdx.y is the scene
__global__ void sdf_bwd_reduce_kernel(const float* __restrict__ part, int n_chunks,
                                      float* __restrict__ dW, float* __restrict__ db) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= PART_ROW) return;
  part += (size_t)blockIdx.y * n_chunks * PART_ROW;
  dW += blockIdx.y * (size_t)W_TOTAL;
  db += blockIdx.y * 9 * OUTW;
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c) s += part[(size_t)c * PART_ROW + i];
  if (i < W_TOTAL) dW[i] = s;
  else db[i - W_TOTAL] = s;
}

// Row chunks of the parameter pass: at least PW_MIN_ROWS rows each, at most
// 64 (enough blocks to fill the card with the 20 tiles), PW_RS-row stages.
int pw_chunks(int n_pad) {
  const int c = 4 * n_pad / PW_MIN_ROWS;
  return c < 1 ? 1 : c > 64 ? 64 : c;
}

int pw_chunk_rows(int n_pad) {
  const int M = 4 * n_pad, c = pw_chunks(n_pad);
  return ((M + c - 1) / c + PW_RS - 1) / PW_RS * PW_RS;
}

// The launches at S scenes: scene s's rows are rows s n_pad .. (s + 1) n_pad - 1
// of pts and of every row array, its weights W + s W_TOTAL, its biases
// bias + s 9 OUTW, its scratch and partials the s-th of S equal parts, its
// dW and db the s-th rows of [S, W_TOTAL] and [S, 9, OUTW]. Each scene's
// blocks run the one-scene code on its own pointers, so a scene's outputs
// and gradients are those of its one-scene launch to the bit.
int fwd_scenes(const float* pts, int n_pad, int n_scenes, const bf16* W, const float* bias,
               float beta, float scale, float* sdf, float* grad, float* feats,
               cudaStream_t stream) {
  if (n_pad <= 0 || n_scenes <= 0) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      sdf_grad_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F_SMEM);
  if (err != cudaSuccess) return (int)err;
  sdf_grad_fwd_kernel<<<dim3(n_pad / P, n_scenes), F_THREADS, F_SMEM, stream>>>(
      pts, W, bias, beta, scale, sdf, grad, feats);
  return (int)cudaGetLastError();
}

int sweep_scenes(const float* pts, int n_pad, int n_scenes, const bf16* W, const float* bias,
                 float beta, float scale, const float* d_sdf, const float* d_grad,
                 const float* d_feats, bf16* scratch, cudaStream_t stream) {
  if (n_pad <= 0 || n_scenes <= 0) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      sdf_bwd_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F_SMEM);
  if (err != cudaSuccess) return (int)err;
  sdf_bwd_sweep_kernel<<<dim3(n_pad / P, n_scenes), F_THREADS, F_SMEM, stream>>>(
      pts, W, bias, beta, scale, n_pad, d_sdf, d_grad, d_feats, scratch);
  return (int)cudaGetLastError();
}

int params_scenes(int n_pad, int n_scenes, bf16* scratch, float* part, float* dW, float* db,
                  cudaStream_t stream) {
  if (n_pad <= 0 || n_scenes <= 0) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      sdf_bwd_params_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)PW_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = pw_chunks(n_pad);
  sdf_bwd_params_kernel<<<dim3(PW_TILES, n_chunks, n_scenes), PW_THREADS, PW_SMEM, stream>>>(
      scratch, n_pad, pw_chunk_rows(n_pad), part);
  sdf_bwd_reduce_kernel<<<dim3((unsigned)((PART_ROW + 255) / 256), n_scenes), 256, 0, stream>>>(
      part, n_chunks, dW, db);
  return (int)cudaGetLastError();
}

int bwd_scenes(const float* pts, int n_pad, int n_scenes, const bf16* W, const float* bias,
               float beta, float scale, const float* d_sdf, const float* d_grad,
               const float* d_feats, bf16* scratch, float* part, float* dW, float* db,
               cudaStream_t stream) {
  if (n_pad <= 0 || n_scenes <= 0) return 0;  // dW and db stay as the caller zeroed them
  const int rc = sweep_scenes(pts, n_pad, n_scenes, W, bias, beta, scale, d_sdf, d_grad,
                              d_feats, scratch, stream);
  if (rc) return rc;
  return params_scenes(n_pad, n_scenes, scratch, part, dW, db, stream);
}

}  // namespace

extern "C" {

size_t sdf_grad_weight_elems() { return W_TOTAL; }
int sdf_grad_tile() { return P; }
size_t sdf_grad_scratch_elems(int n_pad) { return Scratch::elems(4 * (size_t)n_pad); }
size_t sdf_grad_part_elems(int n_pad) { return (size_t)pw_chunks(n_pad) * PART_ROW; }

// pts [n_pad,3] f32 (n_pad % 32 == 0); W packed bf16; bias [9,272] f32.
int sdf_grad_fwd(const float* pts, int n_pad, const bf16* W, const float* bias, float beta,
                 float scale, float* sdf, float* grad, float* feats, cudaStream_t stream) {
  return fwd_scenes(pts, n_pad, 1, W, bias, beta, scale, sdf, grad, feats, stream);
}

// The backward's first part: recompute and reverse sweep into the scratch
// (sdf_grad_scratch_elems(n_pad) bf16).
int sdf_grad_bwd_sweep(const float* pts, int n_pad, const bf16* W, const float* bias,
                       float beta, float scale, const float* d_sdf, const float* d_grad,
                       const float* d_feats, bf16* scratch, cudaStream_t stream) {
  return sweep_scenes(pts, n_pad, 1, W, bias, beta, scale, d_sdf, d_grad, d_feats, scratch,
                      stream);
}

// The second: dW and db from the scratch; part holds sdf_grad_part_elems(n_pad) floats.
int sdf_grad_bwd_params(int n_pad, bf16* scratch, float* part, float* dW, float* db,
                        cudaStream_t stream) {
  return params_scenes(n_pad, 1, scratch, part, dW, db, stream);
}

// Gradients w.r.t. the packed weights (dW, same layout, f32) and biases
// (db [9,272] f32): the two parts above, three launches.
int sdf_grad_bwd(const float* pts, int n_pad, const bf16* W, const float* bias, float beta,
                 float scale, const float* d_sdf, const float* d_grad, const float* d_feats,
                 bf16* scratch, float* part, float* dW, float* db, cudaStream_t stream) {
  return bwd_scenes(pts, n_pad, 1, W, bias, beta, scale, d_sdf, d_grad, d_feats, scratch, part,
                    dW, db, stream);
}

// S scenes in one launch each (fwd_scenes): pts [S, n_pad, 3]; W [S, W_TOTAL]
// bf16; bias [S, 9, 272]; sdf [S, n_pad], grad [S, n_pad, 3], feats
// [S, n_pad, 256]. The backward's scratch and partials are S times one
// scene's; dW [S, W_TOTAL], db [S, 9, 272].
int sdf_grad_fwd_scenes(const float* pts, int n_pad, int n_scenes, const bf16* W,
                        const float* bias, float beta, float scale, float* sdf, float* grad,
                        float* feats, cudaStream_t stream) {
  return fwd_scenes(pts, n_pad, n_scenes, W, bias, beta, scale, sdf, grad, feats, stream);
}

int sdf_grad_bwd_scenes(const float* pts, int n_pad, int n_scenes, const bf16* W,
                        const float* bias, float beta, float scale, const float* d_sdf,
                        const float* d_grad, const float* d_feats, bf16* scratch, float* part,
                        float* dW, float* db, cudaStream_t stream) {
  return bwd_scenes(pts, n_pad, n_scenes, W, bias, beta, scale, d_sdf, d_grad, d_feats, scratch,
                    part, dW, db, stream);
}

}  // extern "C"
