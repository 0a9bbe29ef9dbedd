"""Times variants of the SDF-with-gradient kernels, of the whole-shader
kernel, of the sphere or uniform march, of the light kernel, of the
predictor kernel or of the value-only SDF kernel on the card.

    python -m nero_tpu_torch.kernel_variants [--parent OLD/sdf_grad.cu] [NAME ...]
    python -m nero_tpu_torch.kernel_variants --kernel shader [--parent OLD/shader.cu] [NAME ...]
    python -m nero_tpu_torch.kernel_variants --kernel sphere_march [--wide]
        [--parent OLD/sphere_march.cu] [NAME ...]
    python -m nero_tpu_torch.kernel_variants --kernel march [--wide] [--parent OLD/march.cu]
        [NAME ...]
    python -m nero_tpu_torch.kernel_variants --kernel lights [--outer]
        [--parent OLD/lights.cu] [NAME ...]
    python -m nero_tpu_torch.kernel_variants --kernel predictor [--parent OLD/predictor.cu]
        [NAME ...]
    python -m nero_tpu_torch.kernel_variants --kernel sdf_fwd [--parent OLD/sdf_fwd.cu]
        [NAME ...]
    python -m nero_tpu_torch.kernel_variants --kernel sdf_fwd_scenes
    python -m nero_tpu_torch.kernel_variants --kernel predictor_scenes

Each variant is `csrc/sdf_grad.cu` (VARIANTS: the forward engine's, which the
backward's recompute and reverse sweep share and which lives in
`csrc/sdf_net.cuh`, then the backward's own) or
`csrc/shader.cu` (SHADER_VARIANTS, of both directions, whose forward is the
backward's recompute) with one design choice
undone or one part of its work taken out, built by nvcc from a patched copy
(one process each, in parallel) into `build/nero_tpu_torch/variants/`.
`--parent` adds another version of the source, built as it is (an earlier
commit's, with the same C entries: `sdf_grad_fwd` and `sdf_grad_bwd`, or
`shader_fwd` and `shader_bwd`), against the headers that lie beside it
(unpack the earlier commit's csrc/ whole) before those of csrc/. All are
launched on the same packed weights, inputs and cotangents at N = 65,536, the
training lattice (the shader in its default variant, or `--sphere` /
`--human`), in the given order and then in reverse, 20 timed forward and 10
timed backward launches each after 3 untimed ones (CUDA events). Prints per
variant the registers and spill bytes that ptxas reported for the kernels,
the times of the forward, of the whole backward and of its two parts
(recompute + sweep, parameter pass; not for a parent without them) in both
passes, and the largest difference from the kernel as it is (SDF: of sdf,
grad and feats, and of dW and db over their largest value; shader: of the
forward's packed [N, 24] output, dgeo, dfeats, dW and dB, each over its
largest value). The `fwd_*` variants are for the forward's column: they
change the backward too. The variants that only reorganise the work must give
0 or, where they sum in another order, about 1e-6.

The sphere march (SPHERE_VARIANTS, `csrc/sphere_march.cu`; `--parent` an
earlier source with the C entry `sphere_march`, with or without the field's
`pe` argument) and the uniform march (MARCH_VARIANTS, `csrc/march.cu`;
`--parent` with the C entry `march`, the same) run
on the field distilled from the bowl mesh (`std`, or `wide` with `--wide`;
cached in `data/cache/neural_tracer_torch/`) over N_RAYS = 393,216 surface
rays. Both run on csrc/field.cuh's engine: a patch that the kernel's source
does not hold is made in that header (`_HEADERS`), which the variant's
build then finds in a directory of its own before csrc/. Each library runs every mode: the sphere march with the
Stage-II defaults (18 sphere steps, 2 Illinois steps) and with 8
bisections, the uniform march at c32-r8; 20 timed launches of the first
mode after 3 untimed ones, in the given order and then in reverse. It
prints per variant the registers and spill bytes, `launch_ms` of both
passes, whether t and `found` equal the kernel's to the bit in every mode,
the share of `found` equal to the kernel's and the largest |dt| on rays both
found; and the kernel's agreement with the plain version in each mode. A
variant that spills is built and reported, not timed; a parent that spills
is timed all the same.

The light kernel (LIGHTS_VARIANTS, `csrc/lights.cu`, of both directions: the
forward runs on the backward's engine and builds its inputs with the
recompute's code; `--parent` an earlier source with the same C entries
`lights_fwd` and `lights_bwd`) runs at
N_RAYS rows of the Stage-II lattice in mode `both` with the `direction`
outer light, or with `--outer` in mode `outer` with `sphere_direction`, on
random geometry and cotangents, 20 timed forward and 10 timed backward
launches after 3 untimed ones, in the given order and then in reverse. It
prints per variant the registers and spill bytes of the backward's three
kernels and of the forward, the forward, the whole backward and its two
parts (not for a parent without them), and the largest difference from the
kernel of dgeo, dW, dB and the forward, each over its largest value.

The predictor kernel (PREDICTOR_VARIANTS, `csrc/predictor.cu`; `--parent` an
earlier source with the same C entries `predictor_fwd` and `predictor_bwd`)
runs at N = 65,536 rows for each head shape of PREDICTOR_SHAPES (259 -> 3 and
72 -> 3, the per-head shader's most launched), on
random inputs and cotangents, 20 timed forward and 10 timed backward launches
after 3 untimed ones, in the given order and then in reverse. It prints per
variant the registers and spill bytes of the backward's three kernels and of
the forward, the forward, the whole backward and its three parts (sweep,
parameter pass, reduction; not for a parent without them), and the largest
difference from the kernel of dx, dW, dB and the forward, each over its
largest value.

The value-only SDF kernel (SDF_FWD_VARIANTS, `csrc/sdf_fwd.cu` on the engine
of `csrc/sdf_net.cuh`, where a patch that the source does not hold is made;
`--parent` an earlier source with the same C entry `sdf_fwd`) runs at
SDF_FWD_SIZES points (the sampler's up-sample and first passes, the
occlusion march's first pass) on the packed weights of a seeded network, 20
timed launches after 3 untimed ones at each size, in the given order and
then in reverse. It prints per variant the registers and spill bytes of
the 128- and 64-point instances, the launch times of both passes at each
size, and whether its values equal the kernel's to the bit at every size.

`--kernel sdf_fwd_scenes` and `--kernel predictor_scenes` time the scene
axis of the value-only SDF kernel and of the predictor kernel (the library
as built, no variants): one launch for S scenes (SCENE_COUNTS) against S
one-scene launches, in turns (batched, one by one, one by one, batched), 20
timed forward and 10 timed backward calls after 3 untimed ones, B6 at
SDF_FWD_SIZES points a scene, B8 at N rows a scene for each head shape of
the Stage-I shader; each scene's values (B8: and dx, dW, dB) held to its
one-scene launch's to the bit.

`--encodings` runs the variants at other encoding widths than the shipped
ones, each library built with the -D macros of ops/cuda_build.py and the
inputs shaped to match: `--encodings 8` the SDF kernels at multires 8 (with
the PE's weights live), `--encodings 4,10` the shader at ide_deg 4 and
light_pos_freq 10, `--encodings 4` the light kernel at ide_deg 4. A
`--parent` takes the shipped widths only.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import os
import subprocess

import numpy as np
import torch

from nero_tpu_torch.fields.sdf import SDFConfig, init_sdf
from nero_tpu_torch.ops import cuda_build
from nero_tpu_torch.ops import sdf_grad as K
from nero_tpu_torch.ops.lights import type_lib as lights_type_lib
from nero_tpu_torch.ops.predictor import type_lib as predictor_type_lib
from nero_tpu_torch.ops.mlp import resolve_weight_norm

N = 65536
OUT_DIR = os.path.join(cuda_build.BUILD_DIR, "variants")

_EPILOGUE = """\
          const float x = beta * zp;
          const float ex = expf(-fabsf(x));  // softplus_b's, shared with the sigmoid
          const float sg = __fdividef(x >= 0.0f ? 1.0f : ex, 1.0f + ex);
          const bool masked = l == 3 && col0 + j * 8 + 2 * t + e >= MASK_W;
          h[0][e] = masked ? 0.0f : div_beta(fmaxf(x, 0.0f) + log1pf(ex), beta, inv_beta);
          h[1][e] = masked ? 0.0f : sg * acc[0][j][2 + e];
          h[2][e] = masked ? 0.0f : sg * acc[1][j][e];
          h[3][e] = masked ? 0.0f : sg * acc[1][j][2 + e];"""
_NO_EPILOGUE = """\
          h[0][e] = zp * 0.01f;
          h[1][e] = acc[0][j][2 + e] * 0.01f;
          h[2][e] = acc[1][j][e] * 0.01f;
          h[3][e] = acc[1][j][2 + e] * 0.01f;"""
_SWEEP_EPILOGUE = """\
        const float x = beta * h[0][e];
        const float sg = -expm1f(-x), s2 = beta * expf(-x);
        const float mix = h[1][e] * gh[1] + h[2][e] * gh[2] + h[3][e] * gh[3];
        const bool masked = lp == 3 && col0 + j * 8 + 2 * t + e >= MASK_W;
        gz[0][e] = masked ? 0.0f : sg * gh[0] + s2 * mix;
#pragma unroll
        for (int s = 1; s < 4; ++s) gz[s][e] = masked ? 0.0f : sg * gh[s];"""
# keeps the stored H's loads and the accumulators live
_NO_SWEEP_EPILOGUE = """\
#pragma unroll
        for (int s = 0; s < 4; ++s) gz[s][e] = gh[s] * 0.01f + h[s][e];"""
# put before a source's first include: every mma.sync after it keeps its
# fragments live and does no tensor-core work
_NO_MMA = """#include "mma.cuh"
__device__ __forceinline__ void mma_keep(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  c[0] += __uint_as_float(a[0] & b0 & 0x3f800000u) - 1.0f;
}
#define mma_bf16 mma_keep
"""
_SDF_INCLUDE = '#include "sdf_net.cuh"\n'
# every mma.sync of the SDF engine (sdf_net.cuh) and of the source's own kernels
_SDF_NO_MMA = (_SDF_INCLUDE, _NO_MMA + _SDF_INCLUDE)
# the recompute stores the pre-activations Z (bias added, no mask), as the
# TPU kernel keeps them; the sweep takes s = sigmoid(beta z_p) and z_t from Z,
# and the parameter pass forms H = act(bf16 z) in place in its stage (the TPU
# kernel's h_of), layer 3's mask on tiles 6 and 7 (X is layer 3's output);
# the sweep hands it beta through a device variable
_STORE_H = """\
          if (Hg)
            *reinterpret_cast<__nv_bfloat162*>(Hg + l * lstride + goff + s * F_S + j * F_J) =
                __floats2bfloat162_rn(h[s][0], h[s][1]);"""
_STORE_Z = """\
          if (Hg)
            *reinterpret_cast<__nv_bfloat162*>(Hg + l * lstride + goff + s * F_S + j * F_J) =
                s == 0 ? __floats2bfloat162_rn(acc[0][j][0] + b2.x, acc[0][j][1] + b2.y)
                       : __floats2bfloat162_rn(acc[s >> 1][j][(s & 1) * 2],
                                               acc[s >> 1][j][(s & 1) * 2 + 1]);"""
_S_FROM_Z = """\
        const float ex = expf(-fabsf(x));
        const float sg = __fdividef(x >= 0.0f ? 1.0f : ex, 1.0f + ex);
        const float s2 = beta * sg * (1.0f - sg);"""
_STAGE = "    const bf16* gs = xs + PW_RS * T.xn * 8;\n"
_H_FROM_Z = _STAGE + """\
    if (T.xw == HID) {
      const float beta = pw_beta, inv_beta = __frcp_rn(beta);
      for (int v = tid; v < PW_RS / 4 * T.xn * 8; v += PW_THREADS) {
        const int c = v & 7, row = (v >> 3) & 7, piece = (v >> 6) % T.xn, q = (v >> 6) / T.xn;
        bf16* zr = xs + (q * T.xn + piece) * F_J + row * 8 + c;
        const float x = beta * from_bf(zr[0]);
        const float ex = expf(-fabsf(x));
        const float sg = __fdividef(x >= 0.0f ? 1.0f : ex, 1.0f + ex);
        const bool masked = blockIdx.x / 2 == 3 && (T.xp + piece) * 8 + c >= MASK_W;
        zr[0] = to_bf(masked ? 0.0f : div_beta(fmaxf(x, 0.0f) + log1pf(ex), beta, inv_beta));
#pragma unroll
        for (int s = 1; s < 4; ++s) zr[s * F_S] = to_bf(masked ? 0.0f : sg * from_bf(zr[s * F_S]));
      }
      __syncthreads();
    }
"""
_SWEEP_RECOMPUTE = "  hidden_layers<4, 2>(H, PEb, ring, bias, beta, S.H + row0 * HID, LS);\n"
_PARAMS_LAUNCH = """\
  sdf_bwd_params_kernel<<<dim3(PW_TILES, n_chunks, n_scenes), PW_THREADS, PW_SMEM, stream>>>(
      scratch, n_pad, pw_chunk_rows(n_pad), part);"""
_PARAMS_LAUNCH_PER_TILE = """\
  for (int t = 0; t < PW_TILES; ++t)
    sdf_bwd_params_kernel<<<dim3(1, n_chunks, n_scenes), PW_THREADS, PW_SMEM, stream>>>(
        scratch, n_pad, t, pw_chunk_rows(n_pad), part);"""


def _shape(wn: int, stages: int, slab_k: int):
    return [("constexpr int WN = 8;", f"constexpr int WN = {wn};"),
            ("constexpr int STAGES = 2;", f"constexpr int STAGES = {stages};"),
            ("constexpr int SLAB_K = PEW > 64 ? 64 : 128;", f"constexpr int SLAB_K = {slab_k};")]


VARIANTS = {
    "kernel": [],
    # the forward engine (also the backward's recompute and reverse sweep)
    # the first design: 8 warps of 32 rows x 128 columns (128 accumulators)
    "warps8_cols128": _shape(16, 2, 128),
    # weight slabs of 32 rows (sweep: columns) through a 4-stage ring
    "slab32_stages4": _shape(8, 4, 32),
    # softplus_b's IEEE division, and the IEEE sigmoid of the tangent rule
    "ieee_divisions": [
        ("div_beta(fmaxf(x, 0.0f) + log1pf(ex), beta, inv_beta);\n          h[1]",
         "softplus_b(zp, beta);\n          h[1]"),
        ("__fdividef(x >= 0.0f ? 1.0f : ex, 1.0f + ex);\n          const bool masked = l == 3",
         "x >= 0.0f ? 1.0f / (1.0f + ex) : ex / (1.0f + ex);\n          const bool masked = l == 3")],
    "no_epilogue": [(_EPILOGUE, _NO_EPILOGUE)],
    "no_mma": [_SDF_NO_MMA],
    "weights_only": [(_EPILOGUE, _NO_EPILOGUE), (_SWEEP_EPILOGUE, _NO_SWEEP_EPILOGUE),
                     _SDF_NO_MMA],
    # the backward's own
    # the recompute stores Z, not H (see _STORE_Z)
    "bwd_store_z": [
        (_STORE_H, _STORE_Z),
        ("        const float sg = -expm1f(-x), s2 = beta * expf(-x);", _S_FROM_Z),
        ("struct Scratch {", "__device__ float pw_beta;\n\nstruct Scratch {"),
        (_SWEEP_RECOMPUTE,
         "  if (blockIdx.x == 0 && tid == 0) pw_beta = beta;\n" + _SWEEP_RECOMPUTE),
        (_STAGE, _H_FROM_Z)],
    # the parameter pass as one launch per tile (20), not one for all
    "bwd_launch_per_tile": [
        ("scratch, int n_pad, int rows_per_chunk,",
         "scratch, int n_pad, int tile0, int rows_per_chunk,"),
        ("pw_tile(blockIdx.x,", "pw_tile(tile0 + blockIdx.x,"),
        (_PARAMS_LAUNCH, _PARAMS_LAUNCH_PER_TILE)],
    # its ring: 3 stages of 64 rows, 4 of 32, not 2 of 128 (one tile)
    "bwd_ring3_rows64": [("constexpr int PW_RS = 128;", "constexpr int PW_RS = 64;"),
                         ("constexpr int PW_STAGES = 2;", "constexpr int PW_STAGES = 3;")],
    "bwd_ring4_rows32": [("constexpr int PW_RS = 128;", "constexpr int PW_RS = 32;"),
                         ("constexpr int PW_STAGES = 2;", "constexpr int PW_STAGES = 4;")],
    # the sweep's through_act epilogue
    "bwd_no_epilogue": [(_SWEEP_EPILOGUE, _NO_SWEEP_EPILOGUE)],
}

# ---- the whole-shader backward (csrc/shader.cu) ----
_SH_INCLUDE = '#include "mma.cuh"\n'
_SH_FWD_EPILOGUE = """\
                  __floats2bfloat162_rn(fmaxf(acc[m][j][2 * hf] + b2.x, 0.0f),
                                        fmaxf(acc[m][j][2 * hf + 1] + b2.y, 0.0f));"""
_SH_NO_FWD_EPILOGUE = """\
                  __floats2bfloat162_rn(acc[m][j][2 * hf] * 0.01f, acc[m][j][2 * hf + 1] * 0.01f);"""
_SH_SWEEP_EPILOGUE = """\
                __floats2bfloat162_rn(hv.x > 0.0f ? acc[m][j][2 * hf] : 0.0f,
                                      hv.y > 0.0f ? acc[m][j][2 * hf + 1] : 0.0f);"""
# keeps the stored H's loads live
_SH_NO_SWEEP_EPILOGUE = """\
                __floats2bfloat162_rn(acc[m][j][2 * hf] * 0.01f + hv.x,
                                      acc[m][j][2 * hf + 1] * 0.01f + hv.y);"""
_SH_ENC_FWD = """\
  if (slot == 5) {
    if constexpr (L::human) {
      float pose[12];"""
_SH_ENC_BWD = "        enc_bwd<L>(e, D, di, rs, tab, geo, p0, n);\n"
# the forward's own (the recompute's differ)
_SH_FWD_BUILD = "    build_slot<L>(slot, A, Pt, rs, T.tab, feats, geo, p0, n);\n"
_SH_FWD_H = "      if (l < 3) {  // H = relu(z + b) to the tile\n"

SHADER_VARIANTS = {
    "kernel": [],
    # no products and no epilogues: the weight stream with the scratch traffic
    "weights_only": [(_SH_INCLUDE, _NO_MMA), (_SH_FWD_EPILOGUE, _SH_NO_FWD_EPILOGUE),
                     (_SH_SWEEP_EPILOGUE, _SH_NO_SWEEP_EPILOGUE)],
    # the per-row encodings left out, forward (the input slots stay zero) and backward
    "no_encodings": [(_SH_ENC_FWD, "  if (slot >= 0) {\n  } else if (slot == 5) {\n"
                                   "    if constexpr (L::human) {\n      float pose[12];"),
                     (_SH_ENC_BWD, "")],
    # the ring shape that lost: weight slabs of 64 rows (sweep: columns) through 3 stages
    "slab64_stages3": [("constexpr int SLAB_K = DX_STAGE > 144 ? 64 : 128; ",
                        "constexpr int SLAB_K = 64; "),
                       ("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
    # a light head's f32 dX through device memory (behind the scratch), not
    # shared memory over the activation and points tiles
    "dx_device_memory": [
        ("6 * (size_t)L::NEVAL * m * HID + (size_t)L::NEVAL * m * DO;",
         "6 * (size_t)L::NEVAL * m * HID + (size_t)L::NEVAL * m * DO + 2 * m * DX_MAX;"),
        ("  float* D = reinterpret_cast<float*>(smem_raw);",
         "  float* D = reinterpret_cast<float*>(scratch + BwdScratch<L>::elems((size_t)m_rows) -\n"
         "                                      2 * (size_t)m_rows * DX_MAX) +\n"
         "             (size_t)blockIdx.x * PB * DX_MAX;")],
    # the forward's weight-stream floor: the ring with its barriers and the
    # fragments' ldmatrix, no mma.sync, no input slots, no epilogues, no
    # outputs but the tail (the backward's columns: it loses its mma.sync too)
    "fwd_weights_only": [(_SH_INCLUDE, _NO_MMA), (_SH_FWD_BUILD, ""),
                         (_SH_FWD_H, "      if (true) continue;\n" + _SH_FWD_H)],
    # 64-row tiles of 8 warps, both directions: the weight stream per row doubled
    "fwd_p64_tiles": [("constexpr int PB = 128; ", "constexpr int PB = 64; "),
                      ("constexpr int NTHREADS = 512;", "constexpr int NTHREADS = 256;")],
}

# ---- the sphere march (csrc/sphere_march.cu, on csrc/field.cuh's engine) ----
# The engine's choices (encoding, products, output) live in field.cuh: a
# patch that csrc/sphere_march.cu does not hold is made there (_HEADERS).
_SM_ENCODE = "  encode<WIDE, PE>(p, pe, lane, Es);\n"
# the raw coordinates alone in the staging tile (the other channels stay 0)
_SM_RAW = """\
  if ((lane & 3) == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int k = 0; k < 3; ++k) Es[((lane >> 2) + 8 * r) * FD_LDW + k] = to_bf(p[r][k]);
  __syncwarp();
"""
_SM_WARPS = "constexpr int SM_WARPS = 12; "
_SM_OUT_MMA = """  // 128 -> 1 on the tensor cores: bf16(relu(acc + b_last)) @ w_out, w_out
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
"""
# the first design: each lane's 32 columns of both rows, the quad's four
# parts added by two xor shuffles
_SM_OUT_DOT = """  // 128 -> 1: bf16-rounded activations times bf16-rounded weights, f32 sums
  const float* b_last = Fs + D::HIDDEN * FD_W;
  const float* w_out = Fs + (D::HIDDEN + 1) * FD_W;
  const int q = lane & 3;
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(b_last + 8 * j + 2 * q);
    float2 w = *reinterpret_cast<const float2*>(w_out + 8 * j + 2 * q);
    w = make_float2(from_bf(to_bf(w.x)), from_bf(to_bf(w.y)));
    s0 += from_bf(to_bf(fmaxf(acc[j][0] + b.x, 0.0f))) * w.x;
    s0 += from_bf(to_bf(fmaxf(acc[j][1] + b.y, 0.0f))) * w.y;
    s1 += from_bf(to_bf(fmaxf(acc[j][2] + b.x, 0.0f))) * w.x;
    s1 += from_bf(to_bf(fmaxf(acc[j][3] + b.y, 0.0f))) * w.y;
  }
  // a + b == b + a in f32: all four lanes end with the same sums
  s0 += __shfl_xor_sync(FULL, s0, 1);
  s1 += __shfl_xor_sync(FULL, s1, 1);
  s0 += __shfl_xor_sync(FULL, s0, 2);
  s1 += __shfl_xor_sync(FULL, s1, 2);
  const float b_out = Fs[(D::HIDDEN + 2) * FD_W];
  v[0] = s0 + b_out;
  v[1] = s1 + b_out;
"""
_SM_PRODUCT = "// acc = A @ W for the tile's 16 rows"
# the first design: the encoding built straight in the A fragments, every
# lane running every recurrence, the quad sharing the transcendentals
_SM_ENCODE_REGS = """// The first layer's A fragments of the tile's 16 points, straight from the
// encoding (every lane runs every recurrence and keeps its own slots). p[r][k]: coordinate k of row g + 8r. Channel c of a row sits in
// k-tile c / 16, register 2 * ((c % 16) / 8) + r, half c % 2, of lane
// q = (c % 8) / 2. Channel order of ops/sphere_march.py's pe_rows (std: xyz,
// then sin(xyz), cos(xyz) per octave, six octaves) and pe_rows_wide (xyz,
// then four chains of five octaves at bases 2^(k/4)); padding channels are 0.
template <bool WIDE>
__device__ __forceinline__ void encode_regs(const float (&p)[2][3], int lane,
                                       unsigned (&a)[FieldDims<WIDE>::KT0][4]) {
  constexpr int KT0 = FieldDims<WIDE>::KT0;
  constexpr int NCH = WIDE ? 4 : 1, NOCT = WIDE ? 5 : 6;
  const int q = lane & 3, quad = lane & ~3;
  float f[KT0][4][2];
#pragma unroll
  for (int k = 0; k < KT0; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) f[k][r][0] = f[k][r][1] = 0.0f;
  // channel c of row r, kept by the lane whose slot it is (c is a constant
  // once unrolled: one predicated move)
  auto put = [&](int c, int r, float v) {
    const int w = c % 16;
    if (q == (w & 7) >> 1) f[c / 16][2 * (w >> 3) + r][c & 1] = v;
  };
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) put(k, r, p[r][k]);
  // the six (row, coordinate) pairs: lane q takes pair q and, for q < 2, q + 4
  const float x0 = q == 0 ? p[0][0] : q == 1 ? p[0][1] : q == 2 ? p[0][2] : p[1][0];
  const float x1 = q == 0 ? p[1][1] : p[1][2];
  // bases 2^(k/4) rounded to f32, as the reference's x * base
  const float base[4] = {1.0f, 1.189207115002721f, 1.4142135623730951f, 1.681792830507429f};
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    float sm[2] = {0.0f, 0.0f}, cm[2] = {0.0f, 0.0f};
    sincosf(x0 * base[ch], &sm[0], &cm[0]);
    if (q < 2) sincosf(x1 * base[ch], &sm[1], &cm[1]);
    float s[6], c[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      s[i] = __shfl_sync(FULL, sm[i >> 2], quad | (i & 3));
      c[i] = __shfl_sync(FULL, cm[i >> 2], quad | (i & 3));
    }
#pragma unroll
    for (int o = 0; o < NOCT; ++o) {
      const int c0 = 3 + 6 * NOCT * ch + 6 * o;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        put(c0 + i % 3, i / 3, s[i]);
        put(c0 + 3 + i % 3, i / 3, c[i]);
      }
      if (o + 1 < NOCT) {
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const float s2 = 2.0f * s[i] * c[i];
          c[i] = 1.0f - 2.0f * s[i] * s[i];
          s[i] = s2;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < KT0; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[k][r] = pack_bf2(f[k][r][0], f[k][r][1]);
}

"""

_SM_WARPS8 = (_SM_WARPS, "constexpr int SM_WARPS = 8; ")

# The variants that need more registers than the 168 of 12 warps run at 8
# warps (255 registers): hold them against `warps8`.
SPHERE_VARIANTS = {
    "kernel": [],
    # the encoding left out: its cost
    "no_encode": [(_SM_ENCODE, _SM_RAW)],
    # more or fewer warps per block (the registers a thread may take: 128, 255)
    "warps16": [(_SM_WARPS, "constexpr int SM_WARPS = 16; ")],
    "warps8": [_SM_WARPS8],
    # at 8 warps: the B fragments loaded, no products: the floor of the
    # fragment traffic
    "no_mma_w8": [(_SH_INCLUDE, _NO_MMA), _SM_WARPS8],
    # at 8 warps: each layer's B fragments loaded once, for its first k-tile,
    # and used for every k-tile: the products without the fragment traffic
    "b_once_w8": [("      ldsm_x4_t(b[j], ", "      if (k == 0) ldsm_x4_t(b[j], "), _SM_WARPS8],
    # at 8 warps: the encoding straight into the A fragments, not through the
    # staging tile
    "encode_in_registers_w8": [(_SM_ENCODE + "  load_a(Es, lane, a0);\n",
                                "  encode_regs<WIDE>(p, lane, a0);\n"),
                               (_SM_PRODUCT, _SM_ENCODE_REGS + _SM_PRODUCT), _SM_WARPS8],
    # at 8 warps: the 128 -> 1 output as per-lane dot products, not on the
    # tensor cores
    "output_dot_w8": [(_SM_OUT_MMA, _SM_OUT_DOT), _SM_WARPS8],
}

# ---- the uniform march (csrc/march.cu, on csrc/field.cuh's engine) ----
_MR_WARPS = "constexpr int MR_WARPS = 12; "

MARCH_VARIANTS = {
    "kernel": [],
    # the encoding left out: its cost
    "no_encode": [(_SM_ENCODE, _SM_RAW)],
    # more or fewer warps per block (the registers a thread may take: 128, 255)
    "warps16": [(_MR_WARPS, "constexpr int MR_WARPS = 16; ")],
    "warps8": [(_MR_WARPS, "constexpr int MR_WARPS = 8; ")],
}

# ---- the light kernel, forward and backward (csrc/lights.cu) ----
_LI_INCLUDE = '#include "engine.cuh"\n'
# every mma.sync of the backward's kernels (the sweep's products and the
# parameter pass, both in engine.cuh): keeps the fragments live, no
# tensor-core work
_LI_NO_MMA = _NO_MMA + _LI_INCLUDE
_LI_FWD_EPILOGUE = """\
                __floats2bfloat162_rn(fmaxf(acc[m][j][2 * hf] + b2.x, 0.0f),
                                      fmaxf(acc[m][j][2 * hf + 1] + b2.y, 0.0f));"""
_LI_NO_FWD_EPILOGUE = """\
                __floats2bfloat162_rn(acc[m][j][2 * hf] * 0.01f, acc[m][j][2 * hf + 1] * 0.01f);"""
_LI_SWEEP_EPILOGUE = """\
                __floats2bfloat162_rn(hv.x > 0.0f ? acc[m][j][2 * hf] : 0.0f,
                                      hv.y > 0.0f ? acc[m][j][2 * hf + 1] : 0.0f);"""
# keeps the stored H's loads live
_LI_NO_SWEEP_EPILOGUE = """\
                __floats2bfloat162_rn(acc[m][j][2 * hf] * 0.01f + hv.x,
                                      acc[m][j][2 * hf + 1] * 0.01f + hv.y);"""
_LI_DX = """\
  __host__ __device__ static constexpr int dx0(int h) { return is_inner(h) ? DX0_INNER : 0; }
  __host__ __device__ static constexpr int dxw(int h) {
    return is_inner(h) ? DI_INNER - DX0_INNER : di(h);"""

_LI_WEIGHTS_ONLY = [(_LI_INCLUDE, _LI_NO_MMA), (_LI_FWD_EPILOGUE, _LI_NO_FWD_EPILOGUE),
                    (_LI_SWEEP_EPILOGUE, _LI_NO_SWEEP_EPILOGUE)]
# build_input writes zeros: no encodings, the row state and the tile's
# zero fill only
_LI_NO_INPUTS = [("  int used;\n  if (L::is_inner(h)) {", "  int used = 0;\n  if (false) {"),
                 ("  } else {\n    ide_row(tab, s[B_D]",
                  "  } else if (false) {\n    ide_row(tab, s[B_D]")]

LIGHTS_VARIANTS = {
    "kernel": [],
    # no products and no hidden-layer epilogues (the forward's and the
    # recompute's share their text): the weight stream, with the scratch
    # traffic in the backward
    "weights_only": _LI_WEIGHTS_ONLY,
    # the forward's (and the recompute's) per-tile input phase without its
    # encodings
    "no_inputs": _LI_NO_INPUTS,
    # both: the ring and the slab stream with the tile's barriers alone
    "ring_only": _LI_WEIGHTS_ONLY + _LI_NO_INPUTS,
    # the sweep alone: the C entry does not run the parameter pass (dW, dB
    # are left as they were)
    "no_params": [("  if (rc) return rc;\n  return lights_bwd_params(", "  return rc;\n  (void)lights_bwd_params(")],
    # dX over all 128 input columns of the inner head (PE8's too), not the
    # 80 of its IDE
    "full_dx_inner": [(_LI_DX, _LI_DX.replace("is_inner(h) ? DX0_INNER : 0", "0")
                                      .replace("is_inner(h) ? DI_INNER - DX0_INNER : di(h)",
                                               "di(h)"))],
    # 8 warps over 64-row tiles, forward and backward: the weight stream
    # twice per 128 rows
    "warps8": [("constexpr int PB = 128; ", "constexpr int PB = 64; "),
               ("constexpr int BTHREADS = 512; ", "constexpr int BTHREADS = 256; ")],
}

# ---- the predictor kernel's backward (csrc/predictor.cu) ----
_PR_FWD_EPILOGUE = """\
              __floats2bfloat162_rn(fmaxf(acc[m][j][2 * hf] + b2.x, 0.0f),
                                    fmaxf(acc[m][j][2 * hf + 1] + b2.y, 0.0f));"""
_PR_NO_FWD_EPILOGUE = """\
              __floats2bfloat162_rn(acc[m][j][2 * hf] * 0.01f, acc[m][j][2 * hf + 1] * 0.01f);"""
_PR_SWEEP_EPILOGUE = """\
              __floats2bfloat162_rn(hv.x > 0.0f ? acc[m][j][2 * hf] : 0.0f,
                                    hv.y > 0.0f ? acc[m][j][2 * hf + 1] : 0.0f);"""
# keeps the stored H's loads live
_PR_NO_SWEEP_EPILOGUE = """\
              __floats2bfloat162_rn(acc[m][j][2 * hf] * 0.01f + hv.x,
                                    acc[m][j][2 * hf + 1] * 0.01f + hv.y);"""

PREDICTOR_VARIANTS = {
    "kernel": [],
    # no products and no epilogues (the sweep's and the parameter pass's
    # mma.sync, both in engine.cuh): the weight stream with the scratch traffic
    "weights_only": [(_LI_INCLUDE, _LI_NO_MMA), (_PR_FWD_EPILOGUE, _PR_NO_FWD_EPILOGUE),
                     (_PR_SWEEP_EPILOGUE, _PR_NO_SWEEP_EPILOGUE)],
    # the sweep alone: the C entry runs neither the parameter pass nor the
    # reduction (dW, dB are left as they were)
    "no_params": [("  if (rc) return rc;\n  rc = params_scenes(",
                   "  return rc;\n  rc = params_scenes(")],
    # 8 warps over 64-row tiles: the weight stream twice per 128 rows
    "p64_tiles": [("constexpr int PB = 128; ", "constexpr int PB = 64; "),
                  ("constexpr int BTHREADS = 512; ", "constexpr int BTHREADS = 256; ")],
}

# ---- the value-only SDF kernel (csrc/sdf_fwd.cu, on sdf_net.cuh's engine) ----
_SF_RULE = "int sdf_fwd_tile(int n, int sms) { return (n + 63) / 64 <= sms ? 64 : 128; }"
_SF_EPILOGUE = """\
            const float x = beta * zp;
            const float ex = expf(-fabsf(x));
            const bool masked = l == 3 && col0 + j * 8 + 2 * t + e >= MASK_W;
            h[e] = masked ? 0.0f : div_beta(fmaxf(x, 0.0f) + log1pf(ex), beta, inv_beta);"""
_SF_NO_EPILOGUE = "            h[e] = zp * 0.01f;"

SDF_FWD_VARIANTS = {
    "kernel": [],
    # 64-point tiles (16 warps of one m16 row tile each) at every size
    "p64_tiles": [(_SF_RULE, "int sdf_fwd_tile(int n, int sms) { return 64; }")],
    # 128-point tiles at every size
    "p128_tiles": [(_SF_RULE, "int sdf_fwd_tile(int n, int sms) { return 128; }")],
    # no products and no softplus: the PE, the weight stream with its
    # barriers and the fragments' ldmatrix
    "weights_only": [(_SF_EPILOGUE, _SF_NO_EPILOGUE), _SDF_NO_MMA],
}

_KERNELS = {"sdf_grad": ("sdf_grad_fwd_kernel", "sdf_bwd_sweep_kernel", "sdf_bwd_params_kernel"),
            # the forward: shader_fwd_kernel, or an earlier source's shader_rows_kernel
            "shader": ("(?:shader_fwd_kernel|shader_rows_kernel)", "shader_bwd_sweep_kernel",
                       "shader_bwd_params_kernel"),
            "sphere_march": ("sphere_march_kernel",),
            "march": ("march_kernel",),
            "lights": ("lights_bwd_sweep_kernel", "lights_bwd_params_kernel",
                       "lights_bwd_reduce_kernel"),
            # the forward beside them: predictor_fwd_kernel, or an earlier
            # source's predictor_rows_kernel (plain or <false>)
            "predictor": ("predictor_bwd_sweep_kernel", "predictor_bwd_params_kernel",
                          "predictor_bwd_reduce_kernel",
                          r"(?:predictor_fwd_kernel|predictor_rows_kernel(?:ILb0E)?)E"),
            # 128- and 64-point tiles, or an earlier source's one kernel
            "sdf_fwd": (r"sdf_fwd_kernel(?:ILi2EE|E)", r"sdf_fwd_kernelILi1EE")}
_TABLES = {"sdf_grad": VARIANTS, "shader": SHADER_VARIANTS, "sphere_march": SPHERE_VARIANTS,
           "march": MARCH_VARIANTS, "lights": LIGHTS_VARIANTS, "predictor": PREDICTOR_VARIANTS,
           "sdf_fwd": SDF_FWD_VARIANTS}
# the headers that a kernel's variants may patch, after its own source
_HEADERS = {"sphere_march": ("field.cuh",), "march": ("field.cuh",),
            "sdf_grad": ("sdf_net.cuh",), "sdf_fwd": ("sdf_net.cuh",)}
# the value-only SDF kernel's sizes: the sampler's up-sample and first
# passes, the occlusion march's first pass
SDF_FWD_SIZES = (8192, 32768, 131072)
N_RAYS = 393216  # Stage II: 512 points x (512 + 256) directions
# the predictor's head shapes (d_in, d_out): the two most launched by the
# per-head shader, at di 272 and 80
PREDICTOR_SHAPES = ((259, 3), (72, 3))


KS_DEFAULT_ENC = (5, 8)  # the shader's shipped (ide_deg, light_pos_freq)


def _encodings(kernel: str, text):
    """`--encodings` for `kernel`: None (the shipped widths), the multires,
    (ide_deg, light_pos_freq) or ide_deg; sets DEFINES to the build's macros."""
    global DEFINES
    if text is None:
        return None
    from nero_tpu_torch.ops import lights as KL
    from nero_tpu_torch.ops import shader as KS

    vals = tuple(int(v) for v in text.split(","))
    if kernel == "shader":
        DEFINES = KS.defines(vals)
        return vals
    if kernel in ("sdf_grad", "sdf_fwd"):
        DEFINES = K.defines(vals[0])
    elif kernel == "lights":
        DEFINES = KL.defines(vals[0])
    else:
        raise SystemExit(f"kernel_variants: --encodings does not apply to {kernel}")
    return vals[0]


def sdf_params(cfg, dev):
    """The SDF of seed 3; away from the shipped multires with the PE's
    weights (layer 0's and the skip layer's PE rows, zero under the
    geometric init) drawn at 0.01 / 2^i for octave i, so that every PE
    channel reaches the outputs and each octave moves the spatial gradient
    about as much as the first."""
    params = init_sdf(torch.Generator().manual_seed(3), cfg, device=dev)
    if cfg.multires != K.MULTIRES:
        gen = torch.Generator().manual_seed(4)
        rows = 6 * cfg.multires  # the octaves' rows: the last of each PE input
        amp = 0.01 / 2.0 ** (torch.arange(rows) // 6).float()[:, None]
        with torch.no_grad():
            for l in (0, cfg.skip):
                v = params[l]["v"]
                v[-rows:] += (amp * torch.randn(rows, v.shape[1], generator=gen)).to(dev)
    return params


def variant_files(name: str, kernel: str = "sdf_grad") -> dict:
    """File name -> patched text: csrc/<kernel>.cu, and each header of
    _HEADERS[kernel] that a patch changed. Each (old, new) pair is made in the
    first of those files that holds `old`."""
    names = (f"{kernel}.cu", *_HEADERS.get(kernel, ()))
    orig = {}
    for fn in names:
        with open(os.path.join(cuda_build.CSRC, fn)) as f:
            orig[fn] = f.read()
    files = dict(orig)
    for old, new in _TABLES[kernel][name]:
        fn = next((fn for fn in names if old in files[fn]), None)
        if fn is None:
            raise ValueError(f"variant {name}: no longer held by {' or '.join(names)}: "
                             f"{old[:60]!r}")
        files[fn] = files[fn].replace(old, new)
    return {fn: text for fn, text in files.items() if fn == names[0] or text != orig[fn]}


def variant_source(name: str, kernel: str = "sdf_grad") -> str:
    return variant_files(name, kernel)[f"{kernel}.cu"]


def _variant(name: str, kernel: str):
    """A `build` source: the patched text, with the directory of its patched
    headers where it has any."""
    files = variant_files(name, kernel)
    src = files.pop(f"{kernel}.cu")
    if not files:
        return src
    own = os.path.join(OUT_DIR, name)
    os.makedirs(own, exist_ok=True)
    for fn, text in files.items():
        with open(os.path.join(own, fn), "w") as f:
            f.write(text)
    return src, own


def _type_shader(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.shader_fwd.restype = i
    lib.shader_fwd.argtypes = [vp, vp, i, vp, vp, vp, i, i, vp, vp]
    lib.shader_bwd.restype = i
    lib.shader_bwd.argtypes = [vp, vp, i, vp, vp, vp, i, i, vp, vp, vp, vp, vp, vp, vp, vp]
    # an earlier source sizes by (m_rows, sphere, human) and (m_rows): the extra
    # arguments are ignored there, and N is a multiple of both tiles
    for fn in ("shader_scratch_elems", "shader_part_elems"):
        getattr(lib, fn).restype = ctypes.c_size_t
        getattr(lib, fn).argtypes = [i, i, i]
    parts = hasattr(lib, "shader_bwd_sweep")
    if parts:
        lib.shader_bwd_sweep.restype = i
        lib.shader_bwd_sweep.argtypes = [vp, vp, i, vp, vp, vp, i, i, vp, vp, vp, vp, vp]
        lib.shader_bwd_params.restype = i
        lib.shader_bwd_params.argtypes = [i, i, i, vp, vp, vp, vp, vp]
    return parts


_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entries of the two marches: (rays, R, W, F, wide), pe, then the
# march's own arguments; an earlier source takes no pe (its field is pe 6)
_MARCH_ARGS = {"sphere_march": [_i, _i, _i, _f, _f, _f, _f, _f, _vp, _vp, _vp],
               "march": [_i, _i, _f, _vp, _vp, _vp]}
_MARCH_HEAD = [_vp, _vp, _vp, _vp, _i, _vp, _vp, _i]


def _takes_pe(src) -> bool:
    """Whether a march source's C entry takes the field's pe."""
    return "int wide, int pe" in (src if isinstance(src, str) else src[0])


# `--encodings`: the -D macros every library of the call is built with
DEFINES: tuple = ()


def build(sources: dict, kernel: str = "sdf_grad", instance: str = "") -> dict:
    """name -> source text, or (source text, directory searched for its
    headers before csrc/: an earlier commit's source with the headers of that
    commit); returns name -> (loaded library, whether it has the backward's
    parts, ptxas summary of the kernels whose names match `instance` after
    theirs). Each is built with DEFINES."""
    os.makedirs(OUT_DIR, exist_ok=True)
    jobs = {}
    for name, src in sources.items():
        src, own = (src, None) if isinstance(src, str) else src
        cu, so = os.path.join(OUT_DIR, f"{name}.cu"), os.path.join(OUT_DIR, f"{name}.so")
        with open(cu, "w") as f:
            f.write(src)
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *cuda_build._flags(DEFINES),
               *(["-I", own] if own else []), "-I", cuda_build.CSRC, "-o", so, cu]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log = proc.communicate()[0]
        with open(so + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(so)
        regs = []
        for kern in _KERNELS[kernel]:
            info = cuda_build.parse_ptxas(log, kern + instance)
            regs.append(f"{info.get('regs', '-')}/{info.get('spill_bytes', '-')}")
        if kernel == "shader":
            libs[name] = (lib, _type_shader(lib), " ".join(regs))
            continue
        if kernel == "lights":
            # the forward beside them: lights_fwd_kernel, or an earlier
            # source's lights_rows_kernel (plain or <false>)
            info = cuda_build.parse_ptxas(
                log, rf"(?:lights_fwd_kernel{instance}|lights_rows_kernel(?:ILb0E|E))")
            regs.append(f"{info.get('regs', '-')}/{info.get('spill_bytes', '-')}")
            libs[name] = (lib, lights_type_lib(lib), " ".join(regs))
            continue
        if kernel == "predictor":
            libs[name] = (lib, predictor_type_lib(lib), " ".join(regs))
            continue
        if kernel == "sdf_fwd":
            vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.sdf_fwd.restype, lib.sdf_fwd.argtypes = i, [vp, i, vp, vp, f, f, vp, vp]
            libs[name] = (lib, None, " ".join(regs))
            continue
        if kernel in _MARCH_ARGS:
            entry = getattr(lib, kernel)
            pe = _takes_pe(sources[name])
            entry.restype = ctypes.c_int
            entry.argtypes = _MARCH_HEAD + [_i] * pe + _MARCH_ARGS[kernel]
            libs[name] = (lib, pe, " ".join(regs))
            continue
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sdf_grad_fwd.restype = i
        lib.sdf_grad_fwd.argtypes = [vp, i, vp, vp, f, f, vp, vp, vp, vp]
        lib.sdf_grad_bwd.restype = i
        lib.sdf_grad_bwd.argtypes = [vp, i, vp, vp, f, f, vp, vp, vp, vp, vp, vp, vp, vp]
        for fn in ("sdf_grad_scratch_elems", "sdf_grad_part_elems"):
            getattr(lib, fn).restype = ctypes.c_size_t
            getattr(lib, fn).argtypes = [i]
        parts = hasattr(lib, "sdf_grad_bwd_sweep")
        if parts:
            lib.sdf_grad_bwd_sweep.restype = i
            lib.sdf_grad_bwd_sweep.argtypes = [vp, i, vp, vp, f, f, vp, vp, vp, vp, vp]
            lib.sdf_grad_bwd_params.restype = i
            lib.sdf_grad_bwd_params.argtypes = [i, vp, vp, vp, vp, vp]
        libs[name] = (lib, parts, " ".join(regs))
    return libs


def _time(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _passes(libs, run) -> dict:
    """run(lib, parts) -> times, in the given order and then in reverse."""
    times = {n: [] for n in libs}
    for name in list(libs) + list(reversed(libs)):
        lib, parts, _ = libs[name]
        times[name].append(run(name, lib, parts))
    return times


def _bwd_table(libs, fwd, bwd, parts_of, parts, outputs: str) -> None:
    """Times and prints a kernel whose backward runs in parts: each library's
    backward outputs and forward output against the `kernel` variant's
    (max|d| over the variant's max), and in two passes the forward, the whole
    backward and, where the library has them, the backward's parts
    (`parts_of(lib)`, one callable each, named by `parts`)."""
    outs = {}

    def run(name, lib, has_parts):
        outs[name] = tuple(x.clone() for x in bwd(lib)) + (fwd(lib),)
        row = [_time(lambda: fwd(lib), 20), _time(lambda: bwd(lib), 10)]
        if has_parts:
            row += [_time(fn, 10) for fn in parts_of(lib)]
        return row

    times = _passes(libs, run)
    labels = ("fwd", "bwd", *parts)
    print(f"variant              regs/spills sweep params reduce fwd   ms: fwd, bwd "
          f"({' + '.join(parts)}), first / second pass   max|d|/max of {outputs}")
    ref = outs["kernel"]
    for name, (_, _, ptx) in libs.items():
        d = [f"{((a - b).abs().max() / b.abs().max()).item():.2e}"
             for a, b in zip(outs[name], ref)]
        ms = [f"{label} {times[name][0][k]:.4f}/{times[name][1][k]:.4f}"
              for k, label in enumerate(labels[:len(times[name][0])])]
        print(f"{name:20s} {ptx:32s} {'  '.join(ms)}   {' '.join(d)}")


SCENE_COUNTS = (2, 4)  # scenes of one launch in the scene-axis timings


def _turns(batched, one_by_one, iters: int) -> tuple:
    """(batched ms, one-by-one ms), each the mean of its two passes, taken
    in turns: batched, one by one, one by one, batched."""
    b1, o1, o2, b2 = (_time(fn, iters) for fn in (batched, one_by_one, one_by_one, batched))
    return (b1 + b2) / 2, (o1 + o2) / 2


def _main_sdf_fwd_scenes() -> int:
    """B6's scene axis: a launch for S scenes against S one-scene launches."""
    from nero_tpu_torch.ops import sdf_fwd as KF
    from nero_tpu_torch.parallel.scenes import stack_trees

    dev = torch.device("cuda")
    cfg = SDFConfig()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(_card())
    print("value-only SDF kernel, scene axis: ms of one launch for S scenes / S one-scene "
          "launches (tiles), ratio, each scene's sdf its one-scene launch's to the bit")
    for S in SCENE_COUNTS:
        params = stack_trees([init_sdf(torch.Generator().manual_seed(3 + s), cfg, device=dev)
                              for s in range(S)])
        with torch.no_grad():
            W, bias = KF.pack_scenes(params, cfg)
        rng = np.random.default_rng(S)
        for n in SDF_FWD_SIZES:
            pts = torch.as_tensor(rng.uniform(-0.7, 0.7, (S, n, 3)).astype(np.float32),
                                  device=dev)
            batched = lambda: KF._launch(W, bias, pts, cfg)
            each = lambda: [KF._launch(W[s], bias[s], pts[s], cfg) for s in range(S)]
            bits = all(torch.equal(a, b) for a, b in zip(batched(), each()))
            b_ms, o_ms = _turns(batched, each, 20)
            print(f"S = {S} x {n}: {b_ms:.4f} ({KF.tile(S * n, sms)}-point tiles) / {o_ms:.4f} "
                  f"({KF.tile(n, sms)}-point tiles), {b_ms / o_ms:.3f}; to the bit: "
                  f"{'yes' if bits else 'no'}")
    return 0


def _main_predictor_scenes() -> int:
    """B8's scene axis: a launch each way for S scenes against S one-scene
    launches, at N rows a scene for each head shape of the Stage-I shader."""
    from nero_tpu_torch.ops import predictor as KP
    from nero_tpu_torch.ops.mlp import init_predictor

    dev = torch.device("cuda")
    print(_card())
    print(f"predictor kernel, scene axis, N = {N} rows a scene: ms of one launch for S scenes "
          f"/ S one-scene launches, ratio, forward and backward; each scene's output, dx, dW "
          f"and dB its one-scene launch's to the bit")
    for S in SCENE_COUNTS:
        for d_in, d_out in KP.SHADER_SHAPES:
            res = [resolve_weight_norm(init_predictor(torch.Generator().manual_seed(d_in + s),
                                                      d_in, d_out, device=dev))
                   for s in range(S)]
            with torch.no_grad():
                W, B = KP.pack_scenes([torch.stack([r[l]["w"] for r in res]) for l in range(4)],
                                      [torch.stack([r[l]["b"] for r in res]) for l in range(4)])
            rng = np.random.default_rng(d_in)
            x = torch.as_tensor((rng.standard_normal((S, N, d_in)) * 0.5).astype(np.float32),
                                device=dev)
            gout = torch.as_tensor(rng.standard_normal((S, N, d_out)).astype(np.float32),
                                   device=dev)
            fwd_b = lambda: KP._fwd(x, W, B, d_out)
            fwd_1 = lambda: [KP._fwd(x[s], W[s], B[s], d_out) for s in range(S)]
            bwd_b = lambda: KP._bwd(x, W, B, gout)
            bwd_1 = lambda: [KP._bwd(x[s], W[s], B[s], gout[s]) for s in range(S)]
            with torch.no_grad():
                bits = all(torch.equal(a, b) for a, b in zip(fwd_b(), fwd_1()))
                gb, g1 = bwd_b(), bwd_1()
                bits = bits and all(torch.equal(a[s], g1[s][k]) for k, a in enumerate(gb)
                                    for s in range(S))
                del gb, g1
                f = _turns(fwd_b, fwd_1, 20)
                b = _turns(bwd_b, bwd_1, 10)
            print(f"S = {S}, {d_in} -> {d_out}: fwd {f[0]:.4f} / {f[1]:.4f}, {f[0] / f[1]:.3f}; "
                  f"bwd {b[0]:.4f} / {b[1]:.4f}, {b[0] / b[1]:.3f}; to the bit: "
                  f"{'yes' if bits else 'no'}")
            torch.cuda.empty_cache()
    return 0


_SCENE_MODES = {"sdf_fwd_scenes": _main_sdf_fwd_scenes,
                "predictor_scenes": _main_predictor_scenes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help="variants (all of the kernel's table)")
    ap.add_argument("--kernel", choices=list(_TABLES) + list(_SCENE_MODES), default="sdf_grad")
    ap.add_argument("--parent", help="another sdf_grad.cu, shader.cu, sphere_march.cu, "
                                     "march.cu, lights.cu or predictor.cu to build as it is")
    ap.add_argument("--sphere", action="store_true", help="shader: the sphere_direction variant")
    ap.add_argument("--human", action="store_true", help="shader: the human_light variant")
    ap.add_argument("--wide", action="store_true",
                    help="sphere_march, march: the `wide` field")
    ap.add_argument("--outer", action="store_true",
                    help="lights: mode `outer` with `sphere_direction` (default: mode `both`)")
    ap.add_argument("--encodings", default=None,
                    help="other encoding widths: the SDF kernels' multires (8), the shader's "
                         "ide_deg,light_pos_freq (4,10), the light kernel's ide_deg (4)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA device")
    if args.kernel in _SCENE_MODES:
        if args.parent or args.names or args.encodings:
            raise SystemExit(f"kernel_variants: --kernel {args.kernel} takes no variant, "
                             f"--parent or --encodings")
        return _SCENE_MODES[args.kernel]()
    enc = _encodings(args.kernel, args.encodings)
    if enc is not None and args.parent:
        raise SystemExit("kernel_variants: a --parent takes the shipped encodings only")
    names = args.names or list(_TABLES[args.kernel])
    sources = {n: _variant(n, args.kernel) for n in dict.fromkeys(["kernel", *names])}
    if args.parent:  # with the headers beside it, where it has them
        with open(args.parent) as f:
            sources["parent"] = (f.read(), os.path.dirname(os.path.abspath(args.parent)))
    if args.kernel == "shader":
        return _main_shader(sources, int(args.sphere), int(args.human), enc or KS_DEFAULT_ENC)
    if args.kernel in _MARCH_ARGS:
        return _main_march(sources, args.kernel, args.wide)
    if args.kernel == "lights":
        return _main_lights(sources, args.outer, enc or 5)
    if args.kernel == "predictor":
        return _main_predictor(sources)
    if args.kernel == "sdf_fwd":
        return _main_sdf_fwd(sources, enc or K.MULTIRES)
    libs = build(sources)

    dev = torch.device("cuda")
    cfg = SDFConfig(multires=enc or K.MULTIRES)
    beta, scale = float(cfg.beta), float(cfg.scale)
    layers = resolve_weight_norm(sdf_params(cfg, dev))
    with torch.no_grad():
        W, bias = K.pack_weights([l["w"] for l in layers], [l["b"] for l in layers])
    rng = np.random.default_rng(1)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    pts = t(rng.uniform(-0.7, 0.7, (N, 3)))
    g_sdf, g_grad = t(rng.standard_normal(N)) / N, t(rng.standard_normal((N, 3))) / N
    g_feats = t(rng.standard_normal((N, 256))) * (0.1 / N)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def fwd(lib):
        out = (torch.empty(N, device=dev), torch.empty(N, 3, device=dev),
               torch.empty(N, 256, device=dev))
        rc = lib.sdf_grad_fwd(pts.data_ptr(), N, W.data_ptr(), bias.data_ptr(), beta, scale,
                              *(o.data_ptr() for o in out), stream)
        cuda_build.check(rc, "sdf_grad_fwd")
        return out

    bufs = {}

    def buffers(lib):
        if id(lib) not in bufs:  # one set per library, outside the timed launches
            bufs[id(lib)] = (
                torch.empty(lib.sdf_grad_scratch_elems(N), dtype=torch.bfloat16, device=dev),
                torch.empty(lib.sdf_grad_part_elems(N), device=dev),
                torch.zeros(W.numel(), device=dev), torch.zeros(9, K.OUT_W, device=dev))
        return bufs[id(lib)]

    def sweep(lib):
        scratch = buffers(lib)[0]
        rc = lib.sdf_grad_bwd_sweep(pts.data_ptr(), N, W.data_ptr(), bias.data_ptr(), beta,
                                    scale, g_sdf.data_ptr(), g_grad.data_ptr(),
                                    g_feats.data_ptr(), scratch.data_ptr(), stream)
        cuda_build.check(rc, "sdf_grad_bwd_sweep")

    def params(lib):
        scratch, part, dW, db = buffers(lib)
        rc = lib.sdf_grad_bwd_params(N, scratch.data_ptr(), part.data_ptr(),
                                     dW.data_ptr(), db.data_ptr(), stream)
        cuda_build.check(rc, "sdf_grad_bwd_params")

    def bwd(lib):
        scratch, part, dW, db = buffers(lib)
        rc = lib.sdf_grad_bwd(pts.data_ptr(), N, W.data_ptr(), bias.data_ptr(), beta, scale,
                              g_sdf.data_ptr(), g_grad.data_ptr(), g_feats.data_ptr(),
                              scratch.data_ptr(), part.data_ptr(), dW.data_ptr(),
                              db.data_ptr(), stream)
        cuda_build.check(rc, "sdf_grad_bwd")
        return dW, db

    outs = {}

    def run(name, lib, parts):
        outs[name] = fwd(lib) + tuple(x.clone() for x in bwd(lib))
        row = [_time(lambda: fwd(lib), 20), _time(lambda: bwd(lib), 10)]
        if parts:
            row += [_time(lambda: sweep(lib), 10), _time(lambda: params(lib), 10)]
        return row

    times = _passes(libs, run)
    del bufs
    print(_card())
    print("variant              regs/spills fwd sweep params   ms: fwd, bwd (sweep + params), "
          "first / second pass   max|d| sdf grad feats; dW db (over their max)")
    ref = outs["kernel"]
    for name, (_, parts, ptx) in libs.items():
        o = outs[name]
        d = [f"{(a - b).abs().max().item():.2e}" for a, b in zip(o[:3], ref[:3])]
        d += [f"{((a - b).abs().max() / b.abs().max()).item():.2e}" for a, b in zip(o[3:], ref[3:])]
        ms = []
        for k, label in enumerate(("fwd", "bwd", "sweep", "params")[:len(times[name][0])]):
            ms.append(f"{label} {times[name][0][k]:.4f}/{times[name][1][k]:.4f}")
        print(f"{name:20s} {ptx:24s} {'  '.join(ms)}   {' '.join(d[:3])}; {' '.join(d[3:])}")
    return 0


def _main_shader(sources: dict, sphere: int, human: int, enc: tuple) -> int:
    """The whole-shader kernel's variants, forward and backward, at the
    encodings enc = (ide_deg, light_pos_freq)."""
    from nero_tpu_torch.fields.app_shading import AppShadingConfig, init_app_shading
    from nero_tpu_torch.ops import shader as KS

    libs = build(sources, "shader", f"\\w*Lb{sphere}ELb{human}E")
    dev = torch.device("cuda")
    cfg = AppShadingConfig(sphere_direction=bool(sphere), human_light=bool(human),
                           ide_deg=enc[0], light_pos_freq=enc[1])
    params = init_app_shading(torch.Generator().manual_seed(0), cfg, device=dev)
    rng = np.random.default_rng(1)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    poses = None
    if human:
        q, _ = np.linalg.qr(rng.standard_normal((N, 3, 3)))
        poses = t(np.concatenate([q, rng.uniform(-0.5, 0.5, (N, 3, 1))], -1))
    with torch.no_grad():
        geo, feats, spec, ws, bs = KS.kernel_inputs(
            params, cfg, t(rng.uniform(-0.6, 0.6, (N, 3))), t(rng.standard_normal((N, 3))),
            t(rng.standard_normal((N, 3))), t(rng.standard_normal((N, 256)) * 0.3), poses)
        W, B = KS.pack_weights(ws, bs, spec[2])
    gout = t(rng.standard_normal((N, KS.OUT)))
    tab = KS.ide_table_on(dev, enc[0])
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda x: x.data_ptr()
    head = lambda: (ptr(geo), ptr(feats), N, ptr(W), ptr(B), ptr(tab), sphere, human)
    bufs = {}

    def buffers(lib):
        if id(lib) not in bufs:  # one set per library, outside the timed launches
            bufs[id(lib)] = (
                torch.empty(lib.shader_scratch_elems(N, sphere, human), dtype=torch.bfloat16,
                            device=dev),
                torch.empty(lib.shader_part_elems(N, sphere, human), device=dev),
                torch.empty(N, KS.DGEO, device=dev), torch.empty(N, KS.HID, device=dev),
                torch.zeros(W.numel(), device=dev), torch.zeros_like(B))
        return bufs[id(lib)]

    def fwd(lib):
        out = torch.empty(N, KS.OUT, device=dev)
        cuda_build.check(lib.shader_fwd(*head(), ptr(out), stream), "shader_fwd")
        return out

    def bwd(lib):
        scratch, part, dgeo, dfeats, dW, dB = buffers(lib)
        cuda_build.check(lib.shader_bwd(*head(), ptr(gout), ptr(dgeo), ptr(dfeats), ptr(scratch),
                                        ptr(part), ptr(dW), ptr(dB), stream), "shader_bwd")
        return dgeo, dfeats, dW, dB

    def sweep(lib):
        scratch, _, dgeo, dfeats, _, _ = buffers(lib)
        cuda_build.check(lib.shader_bwd_sweep(*head(), ptr(gout), ptr(dgeo), ptr(dfeats),
                                              ptr(scratch), stream), "shader_bwd_sweep")

    def params_pass(lib):
        scratch, part, _, _, dW, dB = buffers(lib)
        cuda_build.check(lib.shader_bwd_params(N, sphere, human, ptr(scratch), ptr(part), ptr(dW),
                                               ptr(dB), stream), "shader_bwd_params")

    outs = {}

    def run(name, lib, parts):
        outs[name] = (fwd(lib),) + tuple(x.clone() for x in bwd(lib))
        row = [_time(lambda: fwd(lib), 20), _time(lambda: bwd(lib), 10)]
        if parts:
            row += [_time(lambda: sweep(lib), 10), _time(lambda: params_pass(lib), 10)]
        return row

    times = _passes(libs, run)
    del bufs
    print(_card())
    print(f"shader variant sphere={sphere} human={human}, ide_deg {enc[0]}, light_pos_freq "
          f"{enc[1]}, N = {N}")
    print("variant              regs/spills fwd sweep params   ms: fwd, bwd (sweep + params), "
          "first / second pass   max|d|/max of out dgeo dfeats dW dB")
    ref = outs["kernel"]
    for name, (_, parts, ptx) in libs.items():
        d = [f"{((a - b).abs().max() / b.abs().max()).item():.2e}"
             for a, b in zip(outs[name], ref)]
        ms = [f"{label} {times[name][0][k]:.4f}/{times[name][1][k]:.4f}" for k, label in
              enumerate(("fwd", "bwd", "sweep", "params")[:len(times[name][0])])]
        print(f"{name:20s} {ptx:24s} {'  '.join(ms)}   {' '.join(d)}")
    return 0


def _main_lights(sources: dict, outer: bool, ide_deg: int) -> int:
    """The light kernel's backward variants (and the forward beside them) at
    N_RAYS rows, the Stage-II lattice, at IDE degree `ide_deg`."""
    from nero_tpu_torch.fields.mc_shading import MCShadingConfig, init_mc_shading
    from nero_tpu_torch.ops import lights as KL

    sphere, both = int(outer), int(not outer)
    libs = build(sources, "lights", f"\\w*Lb{sphere}ELb{both}E")
    dev = torch.device("cuda")
    n = N_RAYS
    cfg = MCShadingConfig(human_lights=False, ide_deg=ide_deg,
                          outer_light_version="sphere_direction" if outer else "direction")
    mode = "outer" if outer else "both"
    params = init_mc_shading(torch.Generator().manual_seed(0), cfg, device=dev)
    rng = np.random.default_rng(1)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    dirs = rng.standard_normal((n, 3))
    with torch.no_grad():
        geo, _, _, ws, bs = KL.kernel_inputs(
            params, cfg, t(rng.uniform(-0.6, 0.6, (n, 3))),
            t(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)),
            t(rng.uniform(-0.6, 0.6, (n, 3))), t(rng.standard_normal((n, 3))), mode)
        W, B = KL.pack_buffers(ws, bs, bool(sphere), bool(both), ide_deg)
    gout = t(rng.standard_normal((n, KL.OUT)))
    tab = KL.ide_table_on(dev, ide_deg)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda x: x.data_ptr()
    head = lambda: (ptr(geo), n, ptr(W), ptr(B), ptr(tab), sphere, both)
    bufs = {}

    def buffers(lib):
        if id(lib) not in bufs:  # one set per library, outside the timed launches
            bufs[id(lib)] = (
                torch.empty(lib.lights_scratch_elems(n, sphere, both), dtype=torch.bfloat16,
                            device=dev),
                torch.empty(lib.lights_part_elems(n, sphere, both), device=dev),
                torch.empty(n, 6, device=dev), torch.zeros(W.numel(), device=dev),
                torch.zeros_like(B))
        return bufs[id(lib)]

    def fwd(lib):
        out = torch.empty(n, KL.OUT, device=dev)
        cuda_build.check(lib.lights_fwd(*head(), ptr(out), stream), "lights_fwd")
        return out

    def bwd(lib):
        scratch, part, dgeo, dW, dB = buffers(lib)
        cuda_build.check(lib.lights_bwd(*head(), ptr(gout), ptr(dgeo), ptr(scratch), ptr(part),
                                        ptr(dW), ptr(dB), stream), "lights_bwd")
        return dgeo, dW, dB

    def parts_of(lib):
        scratch, part, dgeo, dW, dB = buffers(lib)
        return (lambda: cuda_build.check(lib.lights_bwd_sweep(
                    *head(), ptr(gout), ptr(dgeo), ptr(scratch), stream), "lights_bwd_sweep"),
                lambda: cuda_build.check(lib.lights_bwd_params(
                    n, sphere, both, ptr(scratch), ptr(part), ptr(dW), ptr(dB), stream),
                    "lights_bwd_params"))

    print(_card())
    print(f"light kernel, mode {mode}{' with sphere_direction' if outer else ''}, ide_deg "
          f"{ide_deg}, N = {n}")
    _bwd_table(libs, fwd, bwd, parts_of, ("sweep", "params"), "dgeo dW dB fwd")
    return 0


def _main_predictor(sources: dict) -> int:
    """The predictor kernel's backward variants (and the forward beside them)
    at N = 65,536 rows, the training lattice, for each of PREDICTOR_SHAPES."""
    from nero_tpu_torch.ops import predictor as KP
    from nero_tpu_torch.ops.mlp import init_predictor

    libs = build(sources, "predictor")
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda x: x.data_ptr()
    print(_card())
    for d_in, d_out in PREDICTOR_SHAPES:
        di = KP.padded_d_in(d_in)
        layers = resolve_weight_norm(init_predictor(torch.Generator().manual_seed(d_in), d_in,
                                                    d_out, device=dev))
        with torch.no_grad():
            W, B = KP.pack_weights([l["w"] for l in layers], [l["b"] for l in layers])
        rng = np.random.default_rng(1)
        x = torch.as_tensor((rng.standard_normal((N, d_in)) * 0.5).astype(np.float32), device=dev)
        gout = torch.as_tensor(rng.standard_normal((N, d_out)).astype(np.float32), device=dev)
        head = (ptr(x), N, d_in, di, d_out, ptr(W), ptr(B))
        bufs = {}

        def buffers(lib):
            if id(lib) not in bufs:  # one set per library, outside the timed launches
                bufs[id(lib)] = (
                    torch.empty(lib.predictor_scratch_elems(N, di), dtype=torch.bfloat16,
                                device=dev),
                    torch.empty(lib.predictor_part_elems(N, di), device=dev),
                    torch.empty(N, d_in, device=dev), torch.zeros(W.numel(), device=dev),
                    torch.zeros(4, KP.HID, device=dev))
            return bufs[id(lib)]

        def fwd(lib):
            out = torch.empty(N, d_out, device=dev)
            cuda_build.check(lib.predictor_fwd(*head, ptr(out), stream), "predictor_fwd")
            return out

        def bwd(lib):
            scratch, part, dx, dW, dB = buffers(lib)
            cuda_build.check(lib.predictor_bwd(*head, ptr(gout), ptr(dx), 1, ptr(scratch),
                                               ptr(part), ptr(dW), ptr(dB), stream),
                             "predictor_bwd")
            return dx, dW, dB

        def parts_of(lib):
            scratch, part, dx, dW, dB = buffers(lib)
            return (lambda: cuda_build.check(lib.predictor_bwd_sweep(
                        *head, ptr(gout), ptr(dx), 1, ptr(scratch), stream), "sweep"),
                    lambda: cuda_build.check(lib.predictor_bwd_params(
                        N, di, ptr(scratch), ptr(part), stream), "params"),
                    lambda: cuda_build.check(lib.predictor_bwd_reduce(
                        N, di, ptr(part), ptr(dW), ptr(dB), stream), "reduce"))

        print(f"predictor head {d_in} -> {d_out} (di {di}), N = {N}")
        _bwd_table(libs, fwd, bwd, parts_of, ("sweep", "params", "reduce"), "dx dW dB fwd")
    return 0


def _main_sdf_fwd(sources: dict, multires: int) -> int:
    """The value-only SDF kernel's variants at SDF_FWD_SIZES points, on the
    packed weights of a seeded network at `multires`; each library's values
    held to the kernel's to the bit at every size."""
    libs = build(sources, "sdf_fwd")
    dev = torch.device("cuda")
    cfg = SDFConfig(multires=multires)
    beta, scale = float(cfg.beta), float(cfg.scale)
    layers = resolve_weight_norm(sdf_params(cfg, dev))
    with torch.no_grad():
        W, bias = K.pack_weights([l["w"] for l in layers], [l["b"] for l in layers])
    rng = np.random.default_rng(1)
    pts = torch.as_tensor(rng.uniform(-0.7, 0.7, (max(SDF_FWD_SIZES), 3)).astype(np.float32),
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty(max(SDF_FWD_SIZES), device=dev)

    def launch(lib, m):
        cuda_build.check(lib.sdf_fwd(pts.data_ptr(), m, W.data_ptr(), bias.data_ptr(), beta,
                                     scale, out.data_ptr(), stream), "sdf_fwd")

    outs = {}

    def run(name, lib, _):
        row = []
        for m in SDF_FWD_SIZES:
            if (name, m) not in outs:
                launch(lib, m)
                outs[name, m] = out[:m].clone()
            row.append(_time(lambda: launch(lib, m), 20))
        return row

    times = _passes(libs, run)
    print(_card())
    print(f"value-only SDF kernel at {', '.join(map(str, SDF_FWD_SIZES))} points, multires "
          f"{multires}")
    print("variant              regs/spills 128 64   launch ms at each size, first / second pass"
          "   values as the kernel's to the bit")
    for name, (_, _, ptx) in libs.items():
        bits = all(torch.equal(outs[name, m], outs["kernel", m]) for m in SDF_FWD_SIZES)
        ms = [f"{m} {times[name][0][k]:.4f}/{times[name][1][k]:.4f}"
              for k, m in enumerate(SDF_FWD_SIZES)]
        print(f"{name:20s} {ptx:16s} {'  '.join(ms)}   {'yes' if bits else 'no'}")
    return 0


def _main_march(sources: dict, kernel: str, wide: bool) -> int:
    """The sphere or uniform march's variants on the distilled bowl field.
    Each library runs every mode of the kernel (the sphere march: Illinois-2,
    the Stage-II default, then bisection-8; the uniform march: c32-r8); its
    outputs are held to the kernel's to the bit, and its time is taken in the
    first mode."""
    from nero_tpu_torch.geometry.neural_tracer import NeuralTracer, sphere_segment
    from nero_tpu_torch.geometry.proc_mesh import proc_mesh, surface_rays
    from nero_tpu_torch.models.material import DEFAULT_MATERIAL_CFG
    from nero_tpu_torch.ops import march as KU
    from nero_tpu_torch.ops import sphere_march as KM

    # the shipped instance: `std` at pe 6, or `wide` (an earlier source has
    # no PE argument)
    libs = build(sources, kernel, rf"\w*Lb{int(wide)}E(?:{'Lin1E' if wide else 'Li6E'})?E")
    dev = torch.device("cuda")
    topology = "wide" if wide else "std"
    mesh = proc_mesh("bowl")
    tracer = NeuralTracer(mesh["vertices"], mesh["triangles"], verbose=False, device=dev,
                          seed=DEFAULT_MATERIAL_CFG["random_seed"], field_topology=topology)
    o_np, d_np = surface_rays(mesh, N_RAYS)
    o, d = torch.as_tensor(o_np, device=dev), torch.as_tensor(d_np, device=dev)
    t_enter, t_exit, _ = sphere_segment(o, d, tracer.bound)
    rays = tuple(KM.prep(x) for x in (o, d, t_enter, t_exit))
    W, Fv = KM.kernel_buffers(tracer.packed)
    dt_frac = 1.0 / (tracer.n_coarse - 1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    t_out = torch.empty(N_RAYS, device=dev)
    found = torch.empty(N_RAYS, dtype=torch.bool, device=dev)
    head = (*(x.data_ptr() for x in rays), N_RAYS, W.data_ptr(), Fv.data_ptr(), int(wide))
    tail = (t_out.data_ptr(), found.data_ptr(), stream)
    takes_pe = {id(lib): pe for lib, pe, _ in libs.values()}

    def field(lib):  # the entry's first arguments: rays, field and its pe
        return (*head, tracer.pe) if takes_pe[id(lib)] else head

    if kernel == "sphere_march":
        modes = {"illinois-2": (2, "illinois"), "bisect-8": (8, "bisect")}

        def launch(lib, mode):
            n_refine, refine = modes[mode]
            return lib.sphere_march(*field(lib), tracer.n_sphere, n_refine,
                                    int(refine == "illinois"), 0.012 + 1e-6, tracer.margin, 0.9,
                                    dt_frac, 0.25, *tail)

        def plain(mode):
            n_refine, refine = modes[mode]
            return KM.sphere_march_plain(tracer.packed, *rays, n_sphere=tracer.n_sphere,
                                         n_refine=n_refine, margin=tracer.margin,
                                         dt_frac=dt_frac, refine=refine)
    else:
        modes = {f"c{tracer.n_coarse}-r8": (tracer.n_coarse, 8)}

        def launch(lib, mode):
            return lib.march(*field(lib), *modes[mode], 0.012 + 1e-6, *tail)

        def plain(mode):
            n_coarse, n_refine = modes[mode]
            return KU.march_plain(tracer.packed, *rays, n_coarse=n_coarse, n_refine=n_refine)

    first = next(iter(modes))
    outs, spills = {}, {}

    def run(name, lib, _):
        if name not in outs:
            outs[name] = {}
            for mode in modes:
                cuda_build.check(launch(lib, mode), kernel)
                outs[name][mode] = (t_out.clone(), found.clone())
        ptx = libs[name][2]
        spills[name] = ptx.split("/")[-1] not in ("0", "-")
        if spills[name] and name != "parent":
            return [float("nan")]
        return [_time(lambda: cuda_build.check(launch(lib, first), kernel), 20)]

    times = _passes(libs, run)
    print(_card())
    for mode in modes:
        t_k, f_k = outs["kernel"][mode]
        t_p, f_p = plain(mode)
        both = f_k & f_p
        print(f"{kernel}, {topology} field, N = {N_RAYS}, {mode}; kernel against the plain "
              f"version: found agreement {(f_k == f_p).float().mean().item():.6f}, median |dt| "
              f"{(t_k - t_p).abs()[both].median().item():.3e}, max |dt| "
              f"{(t_k - t_p).abs()[both].max().item():.3e}, found rate "
              f"{f_k.float().mean().item():.4f}")
    print(f"variant                 regs/spills  launch ms ({first}), first / second pass   "
          f"t and found as the kernel's, in {' and '.join(modes)}: to the bit / found "
          f"agreement / max|dt| (both found)")
    for name, (_, _, ptx) in libs.items():
        bits, agree, dt = True, 1.0, 0.0
        for mode in modes:
            (t_v, f_v), (t_k, f_k) = outs[name][mode], outs["kernel"][mode]
            bits = bits and torch.equal(t_v, t_k) and torch.equal(f_v, f_k)
            agree = min(agree, (f_v == f_k).float().mean().item())
            both = f_v & f_k
            if bool(both.any()):
                dt = max(dt, (t_v - t_k).abs()[both].max().item())
        ms = ("not timed (spills)" if math.isnan(times[name][0][0])
              else f"{times[name][0][0]:.4f}/{times[name][1][0]:.4f}")
        print(f"{name:23s} {ptx:12s} {ms:34s} {'yes' if bits else 'no':3s}   {agree:.6f}   "
              f"{dt:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
