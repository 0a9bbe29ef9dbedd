// The SDF network's layout and leaf functions, shared by the SDF-with-gradient
// kernel (sdf_grad.cu) and the value-only kernel (sdf_fwd.cu): PE(6) on the
// scaled point (39 channels, padded to 48), nine weight-norm layers 256 wide
// (layer 3 is 217 wide and feeds the skip; layer 4 reads [h3, PE] as two
// products, w4a and w4b, both pre-scaled by 1/sqrt(2) when packed), 257
// outputs (padded to 272), softplus(beta x)/beta between the layers.
// ops/sdf_grad.py::pack_weights writes this layout.
#pragma once

#include "common.cuh"

namespace nero {
namespace sdfnet {

constexpr int HID = 256;
constexpr int PEW = 48;      // 39 PE channels padded to a tile multiple
constexpr int OUTW = 272;    // 257 outputs padded
constexpr int NPE = 39;
constexpr int MASK_W = 217;  // layer-3 width (256 - 39)

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

// softplus(beta z) / beta in its overflow-safe form
__device__ __forceinline__ float softplus_b(float z, float beta) {
  const float x = beta * z;
  return (fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)))) / beta;
}

}  // namespace sdfnet
}  // namespace nero
