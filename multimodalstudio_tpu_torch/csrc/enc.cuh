// The NeRF frequency encoding of a position inside a kernel, with its
// Jacobian transpose and the diagonal of its Hessian (fused_mlp.py::_enc_fwd
// :181-212, _enc_jt :242-260, _bwd_adj_kernel :580-599). Columns, for F
// frequencies with scales s_i (include_input, d-major):
//   [x_0, x_1, x_2, sin(x_d s_i) (3F), cos(x_d s_i) (3F)].
// sinf / cosf without fast math: the arguments reach tens of radians.
#pragma once

#include "chain.cuh"

namespace mms {

constexpr int MAXPE = 16;  // max NeRF-encoding frequencies

// column c (< 3 + 6F) of the encoding of p
__device__ __forceinline__ float pe_col(const float* p, int F, const float* scale, int c) {
  if (c < 3) return p[c];
  if (c < 3 + 3 * F) {
    const int k = c - 3;
    return sinf(p[k / F] * scale[k % F]);
  }
  const int k = c - 3 - 3 * F;
  return cosf(p[k / F] * scale[k % F]);
}

// component k of J_enc(p)^T a for an encoding-level cotangent a
__device__ __forceinline__ float pe_jt(const float* a, const float* p, int F, const float* scale,
                                       int k) {
  float acc = 0.f;
  for (int i = 0; i < F; ++i) {
    const float s = scale[i];
    const float sc = p[k] * s;
    acc += a[3 + k * F + i] * (cosf(sc) * s) + a[3 + 3 * F + k * F + i] * (-sinf(sc) * s);
  }
  return a[k] + acc;
}

// <a, d^2 enc / d p_k^2> (enc'' = -s^2 enc, diagonal per coordinate)
__device__ __forceinline__ float pe_hess(const float* a, const float* p, int F,
                                         const float* scale, int k) {
  float sec = 0.f;
  for (int i = 0; i < F; ++i) {
    const float s = scale[i];
    const float sc = p[k] * s;
    sec += a[3 + k * F + i] * (-sinf(sc) * s * s) + a[3 + 3 * F + k * F + i] * (-cosf(sc) * s * s);
  }
  return sec;
}

// bf16-rounded entry of the encoding's basis tangent t0_d at column c of
// coordinate d's sin / cos block (fused_mlp.py:199-211): cos(x_d s) s or
// -sin(x_d s) s; column c < 3 is the unit vector (handled by the caller)
__device__ __forceinline__ float pe_tangent(const float* p, int F, const float* scale, int c) {
  if (c < 3 + 3 * F) {
    const int k = c - 3;
    const float s = scale[k % F];
    return round_bf16(cosf(p[k / F] * s) * s);
  }
  const int k = c - 3 - 3 * F;
  const float s = scale[k % F];
  return round_bf16(-sinf(p[k / F] * s) * s);
}

}  // namespace mms
