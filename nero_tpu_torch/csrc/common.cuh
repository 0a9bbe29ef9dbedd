// Building blocks shared by the port's hand-written Hopper kernels: the bf16
// type and its conversions, and the sigmoid of the shader's heads. The
// products live in mma.cuh (the PTX wrappers), engine.cuh (the ring and
// parameter pass of lights.cu and predictor.cu), field.cuh (the warp-tile
// engine of the distilled field) and sdf_net.cuh (the SDF network's forward
// engine).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace nero {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ bf16 to_bf(float x) { return __float2bfloat16(x); }
__device__ __forceinline__ float from_bf(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

}  // namespace nero
