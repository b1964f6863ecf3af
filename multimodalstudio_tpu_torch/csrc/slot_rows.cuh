// The slot grid's front on K1's activation images, shared by K2's forward
// (slot_value.cu), K3's forward (adj_fwd.cuh) and the backward pass of K2 and K3
// (slot_chain_bwd.cu): the tile's chain
// input x0 = [pos, sin, cos, grid of the active levels, 0] rounded to bf16 into
// the activation images, from the raw positions and the f32 table parameter.
#pragma once

#include "k1.cuh"
#include "slot.cuh"

namespace k1 {

// the 8 corner values of one feature of an entry
__device__ __forceinline__ void corners(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// the 8 corner values of feature f of an entry, rounded by the table's type
template <class TT>
__device__ __forceinline__ void entry_corners(const float* T, int f, float (&v)[8]) {
  corners(T + f * 8, v);
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = mms::grid_round<TT>(v[c]);
}

// The tile's chain input x0 = [pos, sin, cos, grid of the active levels, 0]
// rounded to bf16 into activation columns [c0, c0 + P0), zero past n, by the
// warpgroup's 128 threads. TT: the table's type, which sets the grid side's
// roundings; the table arrives as its f32 parameter.
template <class TT>
__device__ __forceinline__ void slot_rows(const mms::SlotParams& P, const float* __restrict__ pos,
                                          int n, long long row0, const float* __restrict__ table,
                                          const float* __restrict__ lmask, bf16* act, int c0,
                                          int P0) {
  const int t = threadIdx.x & 127;
  const int k = P.levels, F = P.feats, pw = P.pw, grid_end = pw + k * F;
  for (int i = t; i < 64 * k; i += 128) {  // grid: one (sample, level) per thread
    const int r = i / k, l = i - r * k;
    const long long row = row0 + r;
    if (row >= n) {
      for (int f = 0; f < F; ++f) act[act_el(c0 + pw + l * F + f, r)] = __float2bfloat16(0.f);
      continue;
    }
    float p[3];
    mms::load_pos(pos, n, row, p);
    float wa[3][2], dwa[3][2], ddwa[3][2];
    const unsigned e = mms::cell_geom(P, l, p, wa, dwa, ddwa);
    float wb[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) wb[c] = mms::corner_weight<TT>(wa, c);
    const float* T = table + mms::entry_offset(P, l, e);
    for (int f = 0; f < F; ++f) {
      float v[8];
      corners(T + f * 8, v);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        acc += mms::grid_round<TT>(mms::grid_round<TT>(v[c]) * wb[c]);
      act[act_el(c0 + pw + l * F + f, r)] = __float2bfloat16(acc * lmask[l * F + f]);
    }
  }
  for (int i = t; i < 64 * pw; i += 128) {  // the NeRF encoding
    const int r = i / pw, c = i - r * pw;
    const long long row = row0 + r;
    const float v = row < n ? mms::pe_col(pos + row * 3, P.pe_freqs, P.pe_scale, c) : 0.f;
    act[act_el(c0 + c, r)] = __float2bfloat16(v);
  }
  const int rest = P0 - grid_end;  // the inactive levels and the padding
  for (int i = t; i < 64 * rest; i += 128) {
    const int r = i / rest;
    act[act_el(c0 + grid_end + i - r * rest, r)] = __float2bfloat16(0.f);
  }
}

}  // namespace k1
