// SDF MLP with its spatial gradient, forward and backward, for Hopper (sm_90a).
//
// Replaces nero_tpu/ops/pallas/sdf_grad_kernel.py::sdf_with_grad_fused
// (pallas_call nero_sdf_grad_fwd :363 and nero_sdf_grad_bwd :387).
//
// A tile is P = 32 points. Its PE(6) and the PE's three tangents (d/dx,
// d/dy, d/dz) make 4P = 128 rows that run through the 9 layers together: the
// bias on primal rows only, the tangent rule u' = sigmoid(beta z) * (u @ W),
// the 217-column mask at layer 3 and the skip layer as two products (w4a on
// h3, w4b on the PE), bf16 operands with f32 sums.
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
// k runs in steps of 16 from 0 up, w4a before w4b into the same sums, the
// bias is added after the product, the PE is the same code and softplus_b's
// division is done without its slow-path branch but to the same bits
// (div_beta), so the primal rows equal the value-only kernel's (sdf_fwd.cu)
// to the bit. 225,280 bytes of shared memory, 512 threads of at most 128
// registers: one block per SM.
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
// Backward (sdf_rows_kernel): where the TPU kept nine stacked pre-activations
// of its row block in VMEM (4.7 MB), a Hopper block has 227 KB. So the
// kernel recomputes the forward of its tile on WMMA tiles (common.cuh
// block_mm, 16 warps, an f32 C tile in shared memory) and writes
// pre-activations Z (bf16, as the TPU kernel stores them), layer inputs H
// and the PE to device memory, then runs the reverse sweep of its tile in
// shared memory (the through_act second-order softplus'' epilogue of
// sdf_grad_kernel.py:297-309) and writes each layer's pre-activation
// cotangent GZ. The parameter gradients dW_l = H_l^T GZ_l and db_l = sum of
// primal rows of GZ_l then come from the two-pass chunked reduction of
// common.cuh (the TPU accumulated them across a sequential grid). Point
// gradients are not produced: sample positions are detached upstream, as on
// the TPU (sdf_grad_kernel.py:431-432). Its bound is 0.745 ms at N = 65,536;
// the scratch round trip through device memory (about 3.4 GB) and the
// shared-memory C tile keep it far from it.
#include "sdf_net.cuh"

using namespace nero;
using namespace nero::sdfnet;

namespace {

constexpr int P = 32;           // points per tile
constexpr int ROWS = 4 * P;     // primal + 3 tangent rows
constexpr int LDA = OUTW + 8;   // shared-memory leading dims (bank skew)
constexpr int LDP = PEW + 8;
constexpr int LDC = OUTW + 4;
constexpr int NTHREADS = 512;
constexpr int DW_CHUNK_MIN_ROWS = 4096;  // stacked rows per weight-gradient chunk, at least
constexpr size_t SMEM_BYTES =
    (size_t)ROWS * LDA * 2 + (size_t)ROWS * LDP * 2 + (size_t)ROWS * LDC * 4;

// scratch (bf16) per M = 4 * n_pad stacked rows: Z[8][M][256], H[8][M][256],
// GZ[8][M][256], GZ8[M][272], PE[M][48]
struct Scratch {
  bf16 *Z, *H, *GZ, *GZ8, *PE;
  __host__ __device__ Scratch(bf16* base, size_t M) {
    Z = base;
    H = Z + 8 * M * HID;
    GZ = H + 8 * M * HID;
    GZ8 = GZ + 8 * M * HID;
    PE = GZ8 + M * OUTW;
  }
  static size_t elems(size_t M) { return 24 * M * HID + M * OUTW + M * PEW; }
};

__global__ void __launch_bounds__(NTHREADS, 1)
sdf_rows_kernel(const float* __restrict__ pts, const bf16* __restrict__ W,
                const float* __restrict__ bias, float beta, float scale, int n_pad,
                const float* __restrict__ d_sdf, const float* __restrict__ d_grad,
                const float* __restrict__ d_feats, bf16* __restrict__ scratch) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* A = reinterpret_cast<bf16*>(smem);
  bf16* PEb = A + ROWS * LDA;
  float* C = reinterpret_cast<float*>(PEb + ROWS * LDP);
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * P;
  const size_t M = 4 * (size_t)n_pad;
  const size_t row0 = (size_t)blockIdx.x * ROWS;
  Scratch S(scratch, M);

  // PE(6) of the scaled points and its tangents w.r.t. the unscaled points
  for (int idx = tid; idx < ROWS * PEW; idx += NTHREADS) {
    const int row = idx / PEW, c = idx % PEW;
    const int s = row / P, r = row % P;
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
    const bf16 bv = to_bf(v);
    PEb[row * LDP + c] = bv;
    S.PE[(row0 + row) * PEW + c] = bv;
  }
  __syncthreads();

  for (int l = 0; l < 8; ++l) {  // the reverse sweep needs layers 0..7 only
    if (l == 0) {
      block_mm<false>(PEb, LDP, W + OFF_W0, HID, C, LDC, ROWS, HID, PEW, false);
    } else if (l == 4) {
      block_mm<false>(A, LDA, W + OFF_W4A, HID, C, LDC, ROWS, HID, HID, false);
      __syncthreads();
      block_mm<false>(PEb, LDP, W + OFF_W4B, HID, C, LDC, ROWS, HID, PEW, true);
    } else {
      block_mm<false>(A, LDA, W + layer_off(l), HID, C, LDC, ROWS, HID, HID, false);
    }
    __syncthreads();
    // activation: primal softplus, tangents sigmoid(beta z_primal) * z_tangent
    for (int idx = tid; idx < P * HID; idx += NTHREADS) {
      const int r = idx / HID, c = idx % HID;
      const float zp = C[r * LDC + c] + bias[l * OUTW + c];
      const float s = sigmoidf_(beta * zp);
      const bool masked = (l == 3 && c >= MASK_W);
      const float hp = masked ? 0.0f : softplus_b(zp, beta);
      A[r * LDA + c] = to_bf(hp);
      S.Z[((size_t)l * M + row0 + r) * HID + c] = to_bf(zp);
      S.H[((size_t)l * M + row0 + r) * HID + c] = to_bf(hp);
#pragma unroll
      for (int j = 1; j < 4; ++j) {
        const int row = j * P + r;
        const float zt = C[row * LDC + c];
        const float ht = masked ? 0.0f : s * zt;
        A[row * LDA + c] = to_bf(ht);
        S.Z[((size_t)l * M + row0 + row) * HID + c] = to_bf(zt);
        S.H[((size_t)l * M + row0 + row) * HID + c] = to_bf(ht);
      }
    }
    __syncthreads();
  }

  // reverse sweep. Cotangent of z8: primal rows [d_sdf, d_feats], tangent
  // row j carries d_grad_j in the sdf column.
  for (int idx = tid; idx < ROWS * OUTW; idx += NTHREADS) {
    const int row = idx / OUTW, c = idx % OUTW;
    const int s = row / P, r = row % P;
    float g = 0.0f;
    if (s == 0) {
      if (c == 0) g = d_sdf[p0 + r];
      else if (c <= HID) g = d_feats[(size_t)(p0 + r) * HID + c - 1];
    } else if (c == 0) {
      g = d_grad[(p0 + r) * 3 + s - 1];
    }
    const bf16 gb = to_bf(g);
    A[row * LDA + c] = gb;
    S.GZ8[(row0 + row) * OUTW + c] = gb;
  }
  __syncthreads();

  for (int l = 8; l >= 1; --l) {
    // cotangent of h_l = act(z_{l-1}):  GH = GZ_l @ W_l^T  (w4a for the skip)
    const int ldw = l == 8 ? OUTW : HID;
    block_mm<true>(A, LDA, W + layer_off(l), ldw, C, LDC, ROWS, HID, ldw, false);
    __syncthreads();
    const int lp = l - 1;
    const bf16* Z = S.Z + (size_t)lp * M * HID;
    for (int idx = tid; idx < P * HID; idx += NTHREADS) {
      const int r = idx / HID, c = idx % HID;
      const float zp = from_bf(Z[(row0 + r) * HID + c]);
      const float s = sigmoidf_(beta * zp);
      const float s2 = beta * s * (1.0f - s);  // softplus_b''
      const bool masked = (lp == 3 && c >= MASK_W);
      float mix = 0.0f;
      float gzt[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int row = (j + 1) * P + r;
        const float ght = C[row * LDC + c];
        mix += from_bf(Z[(row0 + row) * HID + c]) * ght;
        gzt[j] = masked ? 0.0f : s * ght;
      }
      const float gzp = masked ? 0.0f : s * C[r * LDC + c] + s2 * mix;
      bf16* GZ = S.GZ + (size_t)lp * M * HID;
      A[r * LDA + c] = to_bf(gzp);
      GZ[(row0 + r) * HID + c] = to_bf(gzp);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int row = (j + 1) * P + r;
        A[row * LDA + c] = to_bf(gzt[j]);
        GZ[(row0 + row) * HID + c] = to_bf(gzt[j]);
      }
    }
    __syncthreads();
  }
}


// ---------------------------------------------------------------------------
// forward: mma.sync with weight slabs in shared memory and a register epilogue
// ---------------------------------------------------------------------------

constexpr int WN = 8;           // n8-tiles a warp holds in layers 0-7: 64 columns
constexpr int NQ = HID / (8 * WN);             // column groups: warps per point group
constexpr int F_THREADS = 4 * NQ * 32;         // 4 point groups of 8 points
constexpr int L8 = (OUTW / 8 + NQ - 1) / NQ;   // n8-tiles a warp holds in layer 8
constexpr int LDH = HID + 8;    // activation tile [ROWS][LDH] bf16
constexpr int SLAB_K = 128;     // weight rows per slab
constexpr int LDB = OUTW + 8;   // slab [SLAB_K][LDB] bf16
constexpr int STAGES = 2;
constexpr int STAGE_ELEMS = SLAB_K * LDB;
constexpr int PE_SLABS = (PEW + SLAB_K - 1) / SLAB_K, H_SLABS = HID / SLAB_K;
constexpr int N_SLABS = 2 * PE_SLABS + 8 * H_SLABS;  // w0, w1-w4a, w4b, w5-w8
constexpr int LDO = 260;        // f32 output staging [P][LDO], over the activations
constexpr size_t F_SMEM = ((size_t)ROWS * LDH + (size_t)ROWS * LDP + (size_t)STAGES * STAGE_ELEMS) * 2;
static_assert(F_SMEM <= 232448, "forward shared memory");
static_assert((size_t)P * LDO * 4 + P * 3 * 4 <= (size_t)ROWS * LDH * 2, "output staging");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// c += a @ b on one m16n8k16 tile, bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Slab s of the weight stream: the packed layout is the stream's order, so
// a slab is `rows` consecutive rows of n columns at element offset `off`.
struct Slab {
  size_t off;
  int rows, n;
};

__device__ __forceinline__ Slab slab_at(int s) {
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
  return {off + (size_t)j * SLAB_K * n, min(SLAB_K, k - j * SLAB_K), n};
}

// The ring of weight slabs. next() waits for the oldest slab, makes it (and
// every shared-memory write before the call) visible to the block, refills
// the stage that the block finished with, and returns this lane's ldmatrix
// address in the slab.
struct Ring {
  bf16* base;
  const bf16* W;
  unsigned lane_addr;  // this lane's ldmatrix row/column offset in stage 0
  int slab;

  __device__ __forceinline__ void load(int s) const {
    if (s < N_SLABS) {
      const Slab sl = slab_at(s);
      bf16* st = base + (s % STAGES) * STAGE_ELEMS;
      const int cpr = sl.n / 8;  // 16-byte chunks per row
      for (int v = threadIdx.x; v < sl.rows * cpr; v += F_THREADS) {
        const int r = v / cpr, c = (v - r * cpr) * 8;
        cp_async16(st + r * LDB + c, W + sl.off + (size_t)r * sl.n + c);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  }

  __device__ __forceinline__ unsigned next() {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    load(slab + STAGES - 1);
    const unsigned a = lane_addr + (slab % STAGES) * STAGE_ELEMS * 2;
    ++slab;
    return a;
  }
};

// acc[m][j] += X[rows of m-tile m, 0:K] @ Wslab[:, n8-tile j of this warp's
// columns], k in steps of 16 from 0 up. x: this lane's ldmatrix address in
// the warp's first row of X (leading dim ldx); col0: the warp's first column.
__device__ __forceinline__ void product(float (&acc)[2][WN][4], Ring& ring, unsigned x, int ldx,
                                        int K, int col0) {
  for (int k0 = 0; k0 < K; k0 += SLAB_K) {
    const unsigned b = ring.next() + col0 * 2;
    const int ksteps = min(SLAB_K, K - k0) / 16;
#pragma unroll 1  // unrolled, the k steps spill at the 128 registers of 512 threads
    for (int kk = 0; kk < ksteps; ++kk) {
      unsigned a[2][4];
      ldsm_x4(a[0], x + (k0 + kk * 16) * 2);
      ldsm_x4(a[1], x + (16 * ldx + k0 + kk * 16) * 2);
#pragma unroll
      for (int j = 0; j < WN / 2; ++j) {
        unsigned bb[4];
        ldsm_x4_t(bb, b + (kk * 16 * LDB + j * 16) * 2);
        mma_bf16(acc[0][2 * j], a[0], bb[0], bb[1]);
        mma_bf16(acc[1][2 * j], a[1], bb[0], bb[1]);
        mma_bf16(acc[0][2 * j + 1], a[0], bb[2], bb[3]);
        mma_bf16(acc[1][2 * j + 1], a[1], bb[2], bb[3]);
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
  const int p0 = blockIdx.x * P;
  const float inv_beta = __frcp_rn(beta);
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;  // ldmatrix addressing

  Ring ring{PEb + ROWS * LDP, W,
            smem_u32(PEb + ROWS * LDP) + (unsigned)(lrow * LDB + lcol) * 2, 0};
  for (int s = 0; s < STAGES - 1; ++s) ring.load(s);

  // PE(6) of the scaled points and its tangents w.r.t. the unscaled points
  for (int idx = tid; idx < ROWS * PEW; idx += F_THREADS) {
    const int row = idx / PEW, c = idx % PEW;
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
  }

  const unsigned h_x = smem_u32(H + (grp * 32 + lrow) * LDH + lcol);
  const unsigned pe_x = smem_u32(PEb + (grp * 32 + lrow) * LDP + lcol);
  const int col0 = cq * WN * 8;

  for (int l = 0; l < 8; ++l) {
    float acc[2][WN][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
    if (l == 0) {
      product(acc, ring, pe_x, LDP, PEW, col0);
    } else {
      product(acc, ring, h_x, LDH, HID, col0);
      if (l == 4) product(acc, ring, pe_x, LDP, PEW, col0);
    }
    __syncthreads();  // every warp is done reading this layer's input
    // epilogue: primal softplus (bias first), tangents sigmoid(beta z_primal) * z_tangent
    const float* bl = bias + l * OUTW + col0 + 2 * t;
    bf16* hrow = H + (grp * 32 + g) * LDH + col0 + 2 * t;
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      const float2 b2 = *reinterpret_cast<const float2*>(bl + j * 8);
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
      for (int s = 0; s < 4; ++s)
        *reinterpret_cast<__nv_bfloat162*>(hrow + s * 8 * LDH + j * 8) =
            __floats2bfloat162_rn(h[s][0], h[s][1]);
    }
  }

  // layer 8: tile 0 (primal, d/dx) on the warp's L8 n8-tiles of the 272
  // columns; tile 1 (d/dy, d/dz) on the sdf column's n8-tile alone
  float acc8[L8][4], accg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < L8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc8[j][e] = 0.0f;
  const int col8 = cq * L8 * 8;
  for (int k0 = 0; k0 < HID; k0 += SLAB_K) {
    const unsigned b = ring.next() + col8 * 2;
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

}  // namespace

extern "C" {

size_t sdf_grad_weight_elems() { return W_TOTAL; }
int sdf_grad_tile() { return P; }
size_t sdf_grad_scratch_elems(int n_pad) { return Scratch::elems(4 * (size_t)n_pad); }
size_t sdf_grad_part_elems(int n_pad) {
  return part_elems(4 * n_pad, dw_chunks(4 * n_pad, DW_CHUNK_MIN_ROWS), HID, OUTW);
}

// pts [n_pad,3] f32 (n_pad % 32 == 0); W packed bf16; bias [9,272] f32.
int sdf_grad_fwd(const float* pts, int n_pad, const bf16* W, const float* bias, float beta,
                 float scale, float* sdf, float* grad, float* feats, cudaStream_t stream) {
  if (n_pad <= 0) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      sdf_grad_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F_SMEM);
  if (err != cudaSuccess) return (int)err;
  sdf_grad_fwd_kernel<<<n_pad / P, F_THREADS, F_SMEM, stream>>>(pts, W, bias, beta, scale, sdf,
                                                                 grad, feats);
  return (int)cudaGetLastError();
}

// Gradients w.r.t. the packed weights (dW, same layout, f32) and biases
// (db [9,272] f32). part holds sdf_grad_part_elems(n_pad) floats.
int sdf_grad_bwd(const float* pts, int n_pad, const bf16* W, const float* bias, float beta,
                 float scale, const float* d_sdf, const float* d_grad, const float* d_feats,
                 bf16* scratch, float* part, float* dW, float* db, cudaStream_t stream) {
  if (n_pad <= 0) return 0;  // dW and db stay as the caller zeroed them
  cudaFuncSetAttribute(sdf_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM_BYTES);
  sdf_rows_kernel<<<n_pad / P, NTHREADS, SMEM_BYTES, stream>>>(
      pts, W, bias, beta, scale, n_pad, d_sdf, d_grad, d_feats, scratch);
  const int M = 4 * n_pad;
  const int n_chunks = dw_chunks(M, DW_CHUNK_MIN_ROWS);
  Scratch S(scratch, (size_t)M);
  const size_t LH = (size_t)M * HID;
  // layer 0 reads the PE; layer 4 reads h3 (w4a) and the PE (w4b)
  weight_grad(S.PE, PEW, S.GZ, HID, M, PEW, HID, n_chunks, part, dW + OFF_W0, 0, stream);
  for (int l = 1; l < 8; ++l)
    weight_grad(S.H + (l - 1) * LH, HID, S.GZ + l * LH, HID, M, HID, HID, n_chunks, part,
                dW + layer_off(l), 0, stream);
  weight_grad(S.PE, PEW, S.GZ + 4 * LH, HID, M, PEW, HID, n_chunks, part, dW + OFF_W4B, 0,
              stream);
  weight_grad(S.H + 7 * LH, HID, S.GZ8, OUTW, M, HID, OUTW, n_chunks, part, dW + OFF_W8, 0,
              stream);
  // biases act on primal rows only: row % 128 < 32 in the tile-major layout
  for (int l = 0; l < 8; ++l)
    bias_grad(S.GZ + l * LH, HID, M, HID, ROWS, P, part, db + l * OUTW, 0, stream);
  bias_grad(S.GZ8, OUTW, M, OUTW, ROWS, P, part, db + 8 * OUTW, 0, stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
