// One evaluation of the distilled SDF field per point, for sm_90a.
//
// Replaces nero_tpu/ops/pallas/field_kernel.py::field_fwd_fused (:119, its
// pallas_call at :90, body _kernel :55-80): the positional encoding by the
// double-angle recurrence and the field MLP with bf16 operands and f32 sums,
// value only, no gradient. The TPU kernel takes the `std` topology; this one
// also takes `wide`, since both come from csrc/field.cuh.
//
// What bounds it: tensor-core operations, one field evaluation per point
// (2*(39*128 + 2*128*128 + 128) operations, `std`) against 16 bytes per
// point of device-memory traffic.
//
// Design: one block of 256 threads walks tiles of 128 points on a persistent
// grid with the weights resident in shared memory; the ragged last tile is
// masked: points past N are neither read nor written.
#include "field.cuh"

namespace nero {

template <bool WIDE>
__global__ void __launch_bounds__(FD_THREADS) field_fwd_kernel(
    const float* __restrict__ pts, int N, const bf16* __restrict__ W,
    const float* __restrict__ F, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char ff_smem[];
  const FieldSmem s = field_carve<WIDE>(ff_smem);
  field_load<WIDE>(s, W, F);

  const int n_tiles = (N + FD_RAYS - 1) / FD_RAYS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p = tile * FD_RAYS + (threadIdx.x >> 1);
    const bool live = p < N;
    float x = 0.f, y = 0.f, z = 0.f;
    if (live) {
      x = pts[3 * (size_t)p];
      y = pts[3 * (size_t)p + 1];
      z = pts[3 * (size_t)p + 2];
    }
    const float v = field_eval<WIDE>(x, y, z, s);
    if (live && (threadIdx.x & 1) == 0) out[p] = v;
  }
}

}  // namespace nero

namespace {

template <bool WIDE>
int launch_field_fwd(const void* pts, int N, const void* W, const void* F, void* out,
                     void* stream) {
  using namespace nero;
  cudaError_t err = cudaFuncSetAttribute(field_fwd_kernel<WIDE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)FieldDims<WIDE>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int grid = field_grid((N + FD_RAYS - 1) / FD_RAYS, &err);
  if (err != cudaSuccess) return (int)err;
  field_fwd_kernel<WIDE><<<grid, FD_THREADS, FieldDims<WIDE>::SMEM, (cudaStream_t)stream>>>(
      (const float*)pts, N, (const bf16*)W, (const float*)F, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int field_fwd_tile() { return nero::FD_RAYS; }
size_t field_fwd_weight_elems(int wide) {
  return wide ? nero::FieldDims<true>::WELEMS : nero::FieldDims<false>::WELEMS;
}
size_t field_fwd_float_elems(int wide) {
  return wide ? nero::FieldDims<true>::FELEMS : nero::FieldDims<false>::FELEMS;
}

// pts [N,3] f32; W, F as csrc/sphere_march.cu takes them; out [N] f32.
int field_fwd(const void* pts, int N, const void* W, const void* F, int wide, void* out,
              void* stream) {
  if (N <= 0) return 0;
  return wide ? launch_field_fwd<true>(pts, N, W, F, out, stream)
              : launch_field_fwd<false>(pts, N, W, F, out, stream);
}

}  // extern "C"
