// The distilled visibility field, evaluated for a tile of 128 points at once:
// the device function that the sphere-march, uniform-march and field-forward
// kernels share.
//
// Two topologies (nero_tpu/ops/pallas/march_kernel.py::_field_eval_t :60 and
// ::_field_eval_t_wide :103):
//   std   PE6 (39 channels, padded to 48) -> 128 -> 128 -> 128 -> 1
//   wide  four double-angle chains of five octaves at bases 1, 2^.25, 2^.5,
//         2^.75 (123 channels, padded to 128) -> 128 -> 128 -> 1
// All products take bf16-rounded operands and sum in f32 on the tensor cores
// (block_mm of common.cuh), with f32 bias + ReLU between them; the last
// 128 -> 1 layer is a per-point dot.
//
// A block has FD_THREADS = 256 threads and a tile FD_RAYS = 128 points: the
// thread pair (2p, 2p + 1) owns point p, each writes half of its encoding and
// takes half of the final dot. Shared memory: the bf16 weights (copied once
// per block, rows padded to a 136-element stride against bank conflicts), the
// tile's bf16 activations, its f32 product and the f32 biases.
#pragma once

#include "common.cuh"

namespace nero {

constexpr int FD_RAYS = 128;     // points per tile
constexpr int FD_THREADS = 256;  // two threads per point
constexpr int FD_W = 128;        // field width
constexpr int FD_LDW = FD_W + 8; // bf16 row stride of weights and activations
constexpr int FD_LDC = FD_W + 4; // f32 row stride of the product

template <bool WIDE>
struct FieldDims {
  static constexpr int PE = WIDE ? 128 : 48;   // encoding channels, padded
  static constexpr int NPE = WIDE ? 123 : 39;  // encoding channels
  static constexpr int HIDDEN = WIDE ? 1 : 2;  // 128 x 128 layers after the first
  static constexpr int WROWS = PE + HIDDEN * FD_W;       // stacked weight rows
  static constexpr int WELEMS = WROWS * FD_W;            // packed bf16 weights
  static constexpr int FELEMS = (HIDDEN + 2) * FD_W + 4; // biases, w_out, b_out (+pad)
  static constexpr size_t SMEM = (size_t)WROWS * FD_LDW * sizeof(bf16) +
                                 (size_t)FD_RAYS * FD_LDW * sizeof(bf16) +
                                 (size_t)FD_RAYS * FD_LDC * sizeof(float) +
                                 (size_t)FELEMS * sizeof(float);
};

// The block's shared-memory regions.
struct FieldSmem {
  bf16* Ws;   // weights [WROWS][FD_LDW]
  bf16* As;   // activations [FD_RAYS][FD_LDW]
  float* Cs;  // product [FD_RAYS][FD_LDC]
  float* Fs;  // biases of the 128-wide layers, w_out (bf16-rounded), b_out
};

template <bool WIDE>
__device__ __forceinline__ FieldSmem field_carve(unsigned char* base) {
  FieldSmem s;
  s.Ws = reinterpret_cast<bf16*>(base);
  s.As = s.Ws + FieldDims<WIDE>::WROWS * FD_LDW;
  s.Cs = reinterpret_cast<float*>(s.As + FD_RAYS * FD_LDW);
  s.Fs = s.Cs + FD_RAYS * FD_LDC;
  return s;
}

// Weights W [WROWS][128] bf16 and floats F [FELEMS] into shared memory, once
// per block; ends with a block-wide barrier.
template <bool WIDE>
__device__ __forceinline__ void field_load(const FieldSmem& s, const bf16* __restrict__ W,
                                           const float* __restrict__ F) {
  using D = FieldDims<WIDE>;
  for (int v = threadIdx.x; v < D::WELEMS / 8; v += FD_THREADS) {
    const int r = v / (FD_W / 8), c = (v % (FD_W / 8)) * 8;
    *reinterpret_cast<uint4*>(s.Ws + r * FD_LDW + c) =
        *reinterpret_cast<const uint4*>(W + (size_t)r * FD_W + c);
  }
  const int w_out = (D::HIDDEN + 1) * FD_W;
  for (int v = threadIdx.x; v < D::FELEMS; v += FD_THREADS) {
    float x = F[v];
    if (v >= w_out && v < w_out + FD_W) x = from_bf(to_bf(x));  // w_out as a bf16 operand
    s.Fs[v] = x;
  }
  __syncthreads();
}

// As[r, c] = bf16(relu(Cs[r, c] + bias[c])) over the whole tile.
__device__ __forceinline__ void bias_relu_store(const float* Cs, const float* bias, bf16* As) {
  for (int v = threadIdx.x; v < FD_RAYS * (FD_W / 2); v += FD_THREADS) {
    const int r = v / (FD_W / 2), c = (v % (FD_W / 2)) * 2;
    const float a = fmaxf(Cs[r * FD_LDC + c] + bias[c], 0.0f);
    const float b = fmaxf(Cs[r * FD_LDC + c + 1] + bias[c + 1], 0.0f);
    *reinterpret_cast<__nv_bfloat162*>(As + r * FD_LDW + c) = __floats2bfloat162_rn(a, b);
  }
}

// One chain of `n_oct` octaves from sin/cos of the base angle by the
// double-angle identities; `dst` points at the chain's first sin channel,
// channel order per octave: sin(xyz), cos(xyz).
__device__ __forceinline__ void pe_chain(float ax, float ay, float az, int n_oct, bf16* dst) {
  float s[3] = {sinf(ax), sinf(ay), sinf(az)};
  float c[3] = {cosf(ax), cosf(ay), cosf(az)};
  for (int i = 0; i < n_oct; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dst[6 * i + k] = to_bf(s[k]);
      dst[6 * i + 3 + k] = to_bf(c[k]);
    }
    if (i + 1 < n_oct) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float s2 = 2.0f * s[k] * c[k];
        c[k] = 1.0f - 2.0f * s[k] * s[k];
        s[k] = s2;
      }
    }
  }
}

// The tile's encoding into As. std: the pair splits sin / cos rows of the one
// chain; wide: each thread of the pair takes two of the four chains.
template <bool WIDE>
__device__ __forceinline__ void field_encode(float px, float py, float pz, bf16* As) {
  using D = FieldDims<WIDE>;
  const int ray = threadIdx.x >> 1, half = threadIdx.x & 1;
  bf16* arow = As + ray * FD_LDW;
  if (half == 0) {
    arow[0] = to_bf(px);
    arow[1] = to_bf(py);
    arow[2] = to_bf(pz);
  } else {
    for (int k = D::NPE; k < D::PE; ++k) arow[k] = to_bf(0.0f);
  }
  if (WIDE) {
    // bases 2^(k/4) rounded to f32, as the reference's x * base
    const float base[4] = {1.0f, 1.189207115002721f, 1.4142135623730951f, 1.681792830507429f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int chain = 2 * half + j;
      const float b = base[chain];
      pe_chain(px * b, py * b, pz * b, 5, arow + 3 + 30 * chain);
    }
  } else {
    float s[3] = {sinf(px), sinf(py), sinf(pz)};
    float c[3] = {cosf(px), cosf(py), cosf(pz)};
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      bf16* dst = arow + 3 + 6 * i + 3 * half;  // the sin rows, or the cos rows
      dst[0] = to_bf(half == 0 ? s[0] : c[0]);
      dst[1] = to_bf(half == 0 ? s[1] : c[1]);
      dst[2] = to_bf(half == 0 ? s[2] : c[2]);
      if (i + 1 < 6) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float s2 = 2.0f * s[k] * c[k];
          c[k] = 1.0f - 2.0f * s[k] * s[k];
          s[k] = s2;
        }
      }
    }
  }
}

// The field at one point per thread pair, for the whole tile at once. The
// pair passes the same point; both threads get the value. Every thread of
// the block must call it (it holds block-wide barriers).
template <bool WIDE>
__device__ __forceinline__ float field_eval(float px, float py, float pz, const FieldSmem& s) {
  using D = FieldDims<WIDE>;
  const int ray = threadIdx.x >> 1, half = threadIdx.x & 1;
  field_encode<WIDE>(px, py, pz, s.As);
  __syncthreads();
  block_mm<false>(s.As, FD_LDW, s.Ws, FD_LDW, s.Cs, FD_LDC, FD_RAYS, FD_W, D::PE, false);
  __syncthreads();
#pragma unroll
  for (int l = 0; l < D::HIDDEN; ++l) {
    bias_relu_store(s.Cs, s.Fs + l * FD_W, s.As);
    __syncthreads();
    block_mm<false>(s.As, FD_LDW, s.Ws + (D::PE + l * FD_W) * FD_LDW, FD_LDW, s.Cs, FD_LDC,
                    FD_RAYS, FD_W, FD_W, false);
    __syncthreads();
  }
  // 128 -> 1: bf16-rounded activations times bf16-rounded weights, f32 sum;
  // the pair splits the columns (even / odd) and adds the halves
  const float* crow = s.Cs + ray * FD_LDC;
  const float* b_last = s.Fs + D::HIDDEN * FD_W;
  const float* w_out = s.Fs + (D::HIDDEN + 1) * FD_W;
  float acc = 0.0f;
#pragma unroll 8
  for (int j = 0; j < FD_W / 2; ++j) {
    const int col = 2 * j + half;
    acc += from_bf(to_bf(fmaxf(crow[col] + b_last[col], 0.0f))) * w_out[col];
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  // Cs is next written by the first product of the next evaluation, which
  // follows a block-wide barrier, so no barrier is needed here
  return acc + s.Fs[(D::HIDDEN + 2) * FD_W];
}

// Blocks of a persistent grid over n_tiles tiles: one per SM at most.
inline int field_grid(int n_tiles, cudaError_t* err) {
  int dev = 0, sms = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  return n_tiles < sms ? n_tiles : sms;
}

}  // namespace nero
