// The warp-tile engine of the distilled visibility field: the device code
// that the sphere-march, uniform-march and field-forward kernels share.
//
// Two topologies (nero_tpu/ops/pallas/march_kernel.py::_field_eval_t :60 and
// ::_field_eval_t_wide :103):
//   std   PE of pe = 0-7 octaves (3 + 6 pe channels, 39 at the shipped pe 6,
//         padded to 48) -> 128 -> 128 -> 128 -> 1; pe is a kernel argument
//   wide  four double-angle chains of five octaves at bases 1, 2^.25, 2^.5,
//         2^.75 (123 channels, padded to 128) -> 128 -> 128 -> 1
// All products take bf16-rounded operands and sum in f32 on the tensor cores
// (mma.sync), with f32 bias + ReLU between them: the TPU kernels' numerics.
//
// The engine:
//  * A persistent grid of one block per SM at most (field_grid), WARPS warps
//    each. The bf16 weights (76 KB `std`, 64 KB `wide`, rows padded to
//    FD_LDW = 136 elements against bank conflicts) and the f32 biases are
//    copied into shared memory once per block by field_prologue; that copy
//    ends with the only __syncthreads of a kernel on this engine.
//  * Each warp walks tiles of FD_TILE = 16 rows by a static stride. Lane
//    4g + q holds rows g and g + 8 of its tile: the rows of an m16n8k16
//    fragment. field16 gives all four lanes of a quad the same bits of both
//    rows' values, so a kernel can carry the rows' state in every lane of
//    the quad and needs no exchange. The rows' fixed values wait in a
//    warp-private table Rs [VALS][16] f32 in shared memory (column: the
//    row), which saves registers; the kernel says what VALS holds.
//  * The quad of a row pair splits the encoding (`std`: each lane at most two
//    of the six (row, coordinate) pairs; `wide`: one of the four chains
//    each), runs the double-angle recurrence of its own values and writes
//    them to the warp's staging tile Es [16][136] bf16, from which ldmatrix
//    loads the first layer's A fragments.
//  * W's B fragments by ldmatrix.trans from the [in][out] rows. The
//    accumulators of n8-tiles 2k and 2k + 1 are the next layer's A fragment
//    for k-tile k, so bias + ReLU + bf16 rounding run in registers.
//  * The 128 -> 1 output on the tensor cores too: w_out is column 0 of an
//    n8-tile kept in the padding columns of the last layer's weight rows;
//    lane 4g's sums go to the whole quad by a shuffle.
// What holds it back: the rate of mma.sync, and every warp's read of all the
// weights as B fragments per evaluation of 16 rows (PERF.md, B3).
#pragma once

#include "mma.cuh"

namespace nero {

constexpr int FD_W = 128;         // field width
constexpr int FD_LDW = FD_W + 8;  // bf16 row stride of the weights and the staging tile
constexpr int FD_TILE = 16;       // rows per warp tile
constexpr int FD_MAX_PE = 7;      // `std` octaves: 3 + 6 pe channels within the padded 48
// A kernel's PE template argument: the shipped `std` pe 6 as a constant (the
// code the kernels had before pe was an argument: as an argument it cost the
// marches 2-4%), or any pe 0-7 as the kernel's argument. `wide` ignores pe.
constexpr int FD_PE6 = 6, FD_ANY_PE = -1;
#define FIELD_DISPATCH(fn, wide, pe, ...)                                        \
  ((wide) ? fn<true, nero::FD_ANY_PE>(__VA_ARGS__)                               \
          : (pe) == nero::FD_PE6 ? fn<false, nero::FD_PE6>(__VA_ARGS__)          \
                                 : fn<false, nero::FD_ANY_PE>(__VA_ARGS__))
constexpr unsigned FULL = 0xffffffffu;

template <bool WIDE>
struct FieldDims {
  static constexpr int PE = WIDE ? 128 : 48;   // encoding channels, padded
  static constexpr int NPE = WIDE ? 123 : 3 + 6 * FD_MAX_PE;  // encoding channels, at most
  static constexpr int KT0 = PE / 16;          // k-tiles of the first layer
  static constexpr int HIDDEN = WIDE ? 1 : 2;  // 128 x 128 layers after the first
  static constexpr int WROWS = PE + HIDDEN * FD_W;       // stacked weight rows
  static constexpr int WELEMS = WROWS * FD_W;            // packed bf16 weights
  static constexpr int FELEMS = (HIDDEN + 2) * FD_W + 4; // biases, w_out, b_out (+pad)
};

// A block of WARPS warps whose warps keep VALS f32 values per row in their
// tables: its threads and its shared memory (weights, floats, and each
// warp's staging tile and table).
template <bool WIDE, int WARPS, int VALS>
struct FieldBlock {
  using D = FieldDims<WIDE>;
  static constexpr int THREADS = WARPS * 32;
  static constexpr size_t SMEM = (size_t)D::WROWS * FD_LDW * sizeof(bf16) +
                                 (size_t)D::FELEMS * sizeof(float) +
                                 (size_t)WARPS * FD_TILE * FD_LDW * sizeof(bf16) +
                                 (size_t)WARPS * VALS * FD_TILE * sizeof(float);
};

// What a warp works on: the block's weights Ws [WROWS][FD_LDW] and floats Fs
// (biases of the 128-wide layers, w_out, b_out), its own staging tile Es and
// table Rs.
struct WarpField {
  const bf16* Ws;
  const float* Fs;
  bf16* Es;
  float* Rs;
};

// The block prologue: weights W [WROWS][128] bf16 by cp.async and floats F
// [FELEMS] into shared memory, w_out as a bf16 operand beside the last
// layer's rows, the block-wide barrier, then the warp's staging tile zeroed
// (its padding channels stay 0).
template <bool WIDE, int WARPS, int VALS>
__device__ __forceinline__ WarpField field_prologue(unsigned char* smem,
                                                    const bf16* __restrict__ W,
                                                    const float* __restrict__ F) {
  using D = FieldDims<WIDE>;
  constexpr int THREADS = WARPS * 32;
  bf16* Ws = reinterpret_cast<bf16*>(smem);
  float* Fs = reinterpret_cast<float*>(Ws + D::WROWS * FD_LDW);
  for (int v = threadIdx.x; v < D::WELEMS / 8; v += THREADS) {
    const int r = v / (FD_W / 8), c = (v % (FD_W / 8)) * 8;
    cp_async16(Ws + r * FD_LDW + c, W + (size_t)r * FD_W + c);
  }
  cp_async_commit();
  for (int v = threadIdx.x; v < D::FELEMS; v += THREADS) Fs[v] = F[v];
  // the output weights as a [128][8] bf16 operand in the padding columns
  // 128-135 of the last layer's rows: w_out in column 128, zeros after it
  bf16* Wo = Ws + (D::WROWS - FD_W) * FD_LDW + FD_W;
  const float* w_out = F + (D::HIDDEN + 1) * FD_W;
  for (int v = threadIdx.x; v < FD_W * 8; v += THREADS)
    Wo[(v >> 3) * FD_LDW + (v & 7)] = to_bf((v & 7) == 0 ? w_out[v >> 3] : 0.0f);
  cp_async_wait<0>();
  __syncthreads();  // the only block-wide barrier: warps never wait on each other after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* Es = reinterpret_cast<bf16*>(Fs + D::FELEMS) + warp * FD_TILE * FD_LDW;
  float* Rs = reinterpret_cast<float*>(reinterpret_cast<bf16*>(Fs + D::FELEMS) +
                                       WARPS * FD_TILE * FD_LDW) +
              warp * VALS * FD_TILE;
  for (int v = lane; v < FD_TILE * FD_LDW / 2; v += 32) reinterpret_cast<unsigned*>(Es)[v] = 0u;
  return WarpField{Ws, Fs, Es, Rs};
}

__device__ __forceinline__ unsigned pack_bf2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The encoding of the tile's 16 points into the warp's staging tile Es
// [16][FD_LDW] bf16. p[r][k]: coordinate k of row g + 8r, where lane 4g + q
// holds rows g and g + 8. Channel order of ops/sphere_march.py's pe_rows
// (std: xyz, then sin(xyz), cos(xyz) per octave, six octaves) and
// pe_rows_wide (xyz, then four chains of five octaves at bases 2^(k/4));
// `std` writes its pe octaves (0-7: PE, or the argument pe where PE is
// FD_ANY_PE), `wide` ignores pe. The channels past them and the padding
// channels were zeroed once and stay 0. The quad splits
// the work: `std`, lane q takes the (row, coordinate) pairs q and, for q < 2,
// q + 4; `wide`, lane q takes chain q of both rows (lane 0 also the raw xyz).
// Each runs the double-angle recurrence of its own values.
template <bool WIDE, int PE>
__device__ __forceinline__ void encode(const float (&p)[2][3], int pe, int lane, bf16* Es) {
  const int n_oct = PE >= 0 ? PE : pe;
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
        for (int o = 0; o < FD_MAX_PE; ++o) {
          if (o >= n_oct) break;
          dst[3 + 6 * o] = to_bf(s);
          dst[6 + 6 * o] = to_bf(c);
          if (o + 1 < n_oct) {
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
// every lane of the quad. PE, pe: the `std` encoding's octaves (encode); Ws,
// Fs: the block's weights and floats; Es: the warp's staging tile.
template <bool WIDE, int PE>
__device__ __forceinline__ void field16(const float (&p)[2][3], int pe, const bf16* Ws,
                                        const float* Fs, bf16* Es, int lane, float (&v)[2]) {
  using D = FieldDims<WIDE>;
  unsigned a0[D::KT0][4];
  encode<WIDE, PE>(p, pe, lane, Es);
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

// Blocks of a persistent grid of `warps`-warp blocks over the warp tiles of
// n rows: enough for the tiles, one per SM at most.
inline int field_grid(int n, int warps, cudaError_t* err) {
  int dev = 0, sms = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  const int blocks = ((n + FD_TILE - 1) / FD_TILE + warps - 1) / warps;
  return blocks < sms ? blocks : sms;
}

}  // namespace nero
