// One evaluation of the distilled SDF field per point, for sm_90a.
//
// Replaces nero_tpu/ops/pallas/field_kernel.py::field_fwd_fused (:119, its
// pallas_call at :90, body _kernel :55-80): the positional encoding by the
// double-angle recurrence and the field MLP with bf16 operands and f32 sums,
// value only, no gradient. The TPU kernel takes the `std` topology; this one
// also takes `wide`, since both come from csrc/field.cuh.
//
// What bounds it: tensor-core operations, one field evaluation per point
// (2*((3+6pe)*128 + 2*128*128 + 128) operations, `std`) against 16 bytes per
// point of device-memory traffic.
//
// Design: csrc/field.cuh's warp-tile engine, one field16 call per 16-point
// warp tile. FF_WARPS = 12 warps a block on a persistent grid, the weights
// resident in shared memory; the warp's table holds its tile's points. The
// ragged last tile is masked: points past N are neither read nor written.
#include "field.cuh"

namespace nero {

constexpr int FF_WARPS = 12;  // warps per block
constexpr int FF_VALS = 3;    // the point, per row of the warp's table

template <bool WIDE>
using FfBlock = FieldBlock<WIDE, FF_WARPS, FF_VALS>;

template <bool WIDE, int PE>
__global__ void __launch_bounds__(FF_WARPS * 32, 1) field_fwd_kernel(
    const float* __restrict__ pts, int N, const bf16* __restrict__ W,
    const float* __restrict__ F, int pe, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char ff_smem[];
  const WarpField f = field_prologue<WIDE, FF_WARPS, FF_VALS>(ff_smem, W, F);
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int n_tiles = (N + FD_TILE - 1) / FD_TILE;
  for (int tile = blockIdx.x * FF_WARPS + (threadIdx.x >> 5); tile < n_tiles;
       tile += gridDim.x * FF_WARPS) {
    // lane q = 0 of each quad loads and stores row g, q = 1 row g + 8
    const int row = g + 8 * q, id = tile * FD_TILE + row;
    __syncwarp();  // the previous tile's points are read
    if (q < 2)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        f.Rs[k * FD_TILE + row] = id < N ? pts[3 * (size_t)id + k] : 0.0f;
    __syncwarp();
    float p[2][3], v[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int k = 0; k < 3; ++k) p[r][k] = f.Rs[k * FD_TILE + g + 8 * r];
    field16<WIDE, PE>(p, pe, f.Ws, f.Fs, f.Es, lane, v);
    if (q < 2 && id < N) out[id] = q == 0 ? v[0] : v[1];
  }
}

}  // namespace nero

namespace {

template <bool WIDE, int PE>
int launch_field_fwd(const void* pts, int N, const void* W, const void* F, int pe, void* out,
                     void* stream) {
  using namespace nero;
  constexpr size_t smem = FfBlock<WIDE>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(field_fwd_kernel<WIDE, PE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = field_grid(N, FF_WARPS, &err);
  if (err != cudaSuccess) return (int)err;
  field_fwd_kernel<WIDE, PE><<<grid, FfBlock<WIDE>::THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)pts, N, (const bf16*)W, (const float*)F, pe, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int field_fwd_tile() { return nero::FD_TILE; }
size_t field_fwd_weight_elems(int wide) {
  return wide ? nero::FieldDims<true>::WELEMS : nero::FieldDims<false>::WELEMS;
}
size_t field_fwd_float_elems(int wide) {
  return wide ? nero::FieldDims<true>::FELEMS : nero::FieldDims<false>::FELEMS;
}

// pts [N,3] f32; W, F and pe as csrc/sphere_march.cu takes them; out [N] f32.
int field_fwd(const void* pts, int N, const void* W, const void* F, int wide, int pe, void* out,
              void* stream) {
  if (N <= 0) return 0;
  return FIELD_DISPATCH(launch_field_fwd, wide, pe, pts, N, W, F, pe, out, stream);
}

}  // extern "C"
