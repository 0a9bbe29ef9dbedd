// Per-row encodings and their hand-derived gradients, shared by the shader
// and light kernels: the Ref-NeRF integrated directional encoding (IDE) by the
// de-Moivre recurrence of utils/encodings.py (polynomial, NaN-free), the
// positional encoding, and vector normalisation.
//
// The IDE's degree is the build's: -DNERO_IDE_DEG=1..5 (5 unless given;
// ops/cuda_build.py builds one library per degree that a configuration
// asks for). Its NML entries (2, 5, 10, 19, 36) are the (l, m) pairs of
// l = 1, 2, 4, .., 2^(deg-1), m = 0..l, and its [Re | Im] row is NIDE = 2 NML
// wide (4, 10, 20, 38, 72): Im starts at NML, so a lower degree's row is no
// prefix of degree 5's. The table (utils/encodings.py::ide_kernel_table) is
// the coefficient matrix [LMAX + 1][NML], then sigma [NML] and m [NML].
#pragma once

#include "common.cuh"

#ifndef NERO_IDE_DEG
#define NERO_IDE_DEG 5
#endif

namespace nero {

constexpr int IDE_DEG = NERO_IDE_DEG;
constexpr int LMAX = 1 << (IDE_DEG - 1);
constexpr int NML = IDE_DEG + 2 * LMAX - 1;  // IDE entries
constexpr int NIDE = 2 * NML;
constexpr int TAB = (LMAX + 1) * NML + 2 * NML;
static_assert(IDE_DEG >= 1 && IDE_DEG <= 5, "the IDE takes degrees 1-5");

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(bf16* p, float v) { *p = to_bf(v); }

// 2^i as an exact f32 for i = 0..127, from the exponent bits: an int shift
// overflows at octave 31 (to -2^31) and is undefined from octave 32 on
__device__ __forceinline__ float pow2f(int i) { return __int_as_float((127 + i) << 23); }

// A window of `w` columns of a bf16 row, x its first: a pointer that
// ide_row can write through. Window{x, c, w} stands for the window's column c
// (+ k: column c + k); columns outside 0 .. w - 1 are dropped.
struct Window {
  bf16* x;
  int c, w;
  __device__ __forceinline__ Window operator+(int k) const { return {x, c + k, w}; }
};
__device__ __forceinline__ void store_as(Window p, float v) {
  if (p.c >= 0 && p.c < p.w) p.x[p.c] = to_bf(v);
}

// The f32 cotangent of a window of `w` columns, d its first, for
// ide_row_bwd: WindowIn{d, c, w}[k] is the window's column c + k, and 0
// outside it.
struct WindowIn {
  const float* d;
  int c, w;
  __device__ __forceinline__ float operator[](int k) const {
    return c + k >= 0 && c + k < w ? d[c + k] : 0.0f;
  }
};

// (x + iy)^m for m = 0..LM, and z^k for k = 0..LM
template <int LM>
__device__ void ide_powers(float x, float y, float z, float* re, float* im, float* zp) {
  re[0] = 1.0f; im[0] = 0.0f; zp[0] = 1.0f;
  for (int m = 1; m <= LM; ++m) {
    re[m] = re[m - 1] * x - im[m - 1] * y;
    im[m] = re[m - 1] * y + im[m - 1] * x;
    zp[m] = zp[m - 1] * z;
  }
}

// IDE of degree DEG of one direction, from that degree's table: out[i] = Re,
// out[nml + i] = Im for its nml entries. `nlanes` threads can share a row:
// lane `lane` computes the entries lane, lane + nlanes, ... `out` is a float
// or bf16 pointer, or a Window of a row.
template <int DEG = IDE_DEG, typename P>
__device__ void ide_row(const float* tab, float x, float y, float z, float kappa, P out,
                        int stride, int lane = 0, int nlanes = 1) {
  constexpr int lmax = 1 << (DEG - 1), nml = DEG + 2 * lmax - 1;
  float re[lmax + 1], im[lmax + 1], zp[lmax + 1];
  ide_powers<lmax>(x, y, z, re, im, zp);
  const float* sigma = tab + (lmax + 1) * nml;
  const float* mm = sigma + nml;
  for (int i = lane; i < nml; i += nlanes) {
    float pz = 0.0f;
    for (int k = 0; k <= lmax; ++k) pz += zp[k] * tab[k * nml + i];
    const int m = (int)mm[i];
    const float att = expf(-sigma[i] * kappa);
    store_as(out + i * stride, re[m] * pz * att);
    store_as(out + (nml + i) * stride, im[m] * pz * att);
  }
}

// backward of ide_row: g[0:2 nml] cotangent -> d(x,y,z) (added) and d kappa.
// With `nlanes` threads on a row each gets the partial sums of its entries,
// and the caller adds the lanes. `g` is a float pointer or a WindowIn.
template <int DEG = IDE_DEG, typename G>
__device__ float ide_row_bwd(const float* tab, float x, float y, float z, float kappa,
                             G g, float* dxyz, int lane = 0, int nlanes = 1) {
  constexpr int lmax = 1 << (DEG - 1), nml = DEG + 2 * lmax - 1;
  float re[lmax + 1], im[lmax + 1], zp[lmax + 1];
  ide_powers<lmax>(x, y, z, re, im, zp);
  const float* sigma = tab + (lmax + 1) * nml;
  const float* mm = sigma + nml;
  float gx = 0.0f, gy = 0.0f, gz = 0.0f, gk = 0.0f;
  for (int i = lane; i < nml; i += nlanes) {
    float pz = 0.0f, dpz = 0.0f;
    for (int k = 0; k <= lmax; ++k) {
      const float c = tab[k * nml + i];
      pz += zp[k] * c;
      if (k > 0) dpz += k * zp[k - 1] * c;
    }
    const int m = (int)mm[i];
    const float att = expf(-sigma[i] * kappa);
    const float gr = g[i] * att, gi = g[nml + i] * att;
    const float proj = gr * re[m] + gi * im[m];  // d out / d (pz * att) direction
    gz += proj * dpz;
    gk += -sigma[i] * proj * pz;
    if (m > 0) {
      // d(x+iy)^m/dx = m (x+iy)^(m-1), d/dy = i m (x+iy)^(m-1)
      const float a = m * re[m - 1], b = m * im[m - 1];
      gx += pz * (gr * a + gi * b);
      gy += pz * (-gr * b + gi * a);
    }
  }
  dxyz[0] += gx; dxyz[1] += gy; dxyz[2] += gz;
  return gk;
}

__device__ __forceinline__ float pe_val(const float* x, int c) {
  if (c < 3) return x[c];
  const int i = (c - 3) / 6, q = (c - 3) % 6, k = q % 3;
  const float a = x[k] * pow2f(i);
  return q >= 3 ? cosf(a) : sinf(a);
}

// d PE / d x added to dx, given the cotangent g of nfreq octaves
__device__ void pe_bwd(const float* x, const float* g, int stride, int nfreq, float* dx) {
  for (int k = 0; k < 3; ++k) dx[k] += g[k * stride];
  for (int i = 0; i < nfreq; ++i)
    for (int k = 0; k < 3; ++k) {
      const float f = pow2f(i), a = x[k] * f;
      dx[k] += f * (g[(3 + 6 * i + k) * stride] * cosf(a) - g[(6 + 6 * i + k) * stride] * sinf(a));
    }
}

__device__ __forceinline__ void normalize3(const float* v, float* out, float* len) {
  const float n = sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  const float d = fmaxf(n, 1e-12f);
  for (int k = 0; k < 3; ++k) out[k] = v[k] / d;
  *len = n;
}

// d raw from d unit for u = raw / max(|raw|, 1e-12)
__device__ __forceinline__ void normalize3_bwd(const float* u, float len, const float* du,
                                               float* draw) {
  if (len > 1e-12f) {
    const float p = u[0] * du[0] + u[1] * du[1] + u[2] * du[2];
    for (int k = 0; k < 3; ++k) draw[k] = (du[k] - u[k] * p) / len;
  } else {
    for (int k = 0; k < 3; ++k) draw[k] = du[k] / 1e-12f;
  }
}

}  // namespace nero
