// The slot grid's pieces that its kernels share (slot_rows.cuh's front of K2's and K3's
// forwards and their backward pass, adj_fwd.cuh's grid term, the split's scatter in
// slot_split.cu): the grid and encoding constants and the cell geometry of one
// (sample, level).
//
// The table's type TT sets the grid side's cast points (grid_round). A bf16 table
// (TT = bf16) rounds as the reference's single-bf16 dots do: table value and trilerp
// weight bf16, their product rounded to bf16 before the f32 sum, and so on. An f32 table
// (TT = float) keeps f32 throughout the grid side, as the reference's bf16 hi+lo split
// dots reach f32 to about 2^-16 (slot_fused.py:368-369, SlotGeom.bf16 False); only the
// grid column of x0 is rounded to bf16. The kernels read the table as its f32 parameter
// and round a bf16 table's values as they read them.
#pragma once

#include <type_traits>

#include "enc.cuh"

namespace mms {

constexpr int MAXLV = 32;  // max grid levels (build.py MAX_LEVELS)

struct SlotParams {
  int levels;    // active levels K (<= the table's levels)
  int feats;     // F features per entry
  int pk_shift;  // log2(entries per 128-lane row)
  int res[MAXLV];
  int dense[MAXLV];
  unsigned ent_mask[MAXLV];  // entries - 1 (hashed levels)
  int row_off[MAXLV];        // physical row offset of each level
  float radius;
  float clip_hi;  // float32(1 - 1e-6)
  int smooth;     // Smoothstep (1) or Linear (0)
  int pe_freqs;
  float pe_scale[MAXPE];
  int pw;  // 3 + 6 * pe_freqs
};

inline int fill_slot_params(SlotParams& P, int levels, int feats, int pk_shift, const int* res,
                            const int* dense, const int* ent_mask, const int* row_off,
                            float radius, float clip_hi, int smooth, int pe_freqs,
                            const float* pe_scale) {
  if (levels < 1 || levels > MAXLV || pe_freqs < 0 || pe_freqs > MAXPE || feats > 16) return -1;
  P.levels = levels;
  P.feats = feats;
  P.pk_shift = pk_shift;
  for (int l = 0; l < levels; ++l) {
    P.res[l] = res[l];
    P.dense[l] = dense[l];
    P.ent_mask[l] = (unsigned)ent_mask[l];
    P.row_off[l] = row_off[l];
  }
  P.radius = radius;
  P.clip_hi = clip_hi;
  P.smooth = smooth;
  P.pe_freqs = pe_freqs;
  for (int i = 0; i < pe_freqs; ++i) P.pe_scale[i] = pe_scale[i];
  P.pw = 3 + 6 * pe_freqs;
  return 0;
}

// Cell of level l containing p: entry index and per-axis trilerp factors
// wa[t][bit] (bit ? s : 1 - s), their derivatives dwa[t][bit] = d wa / d g
// and second derivatives ddwa (the resolution chain rule included), as
// slot_grid.py::slot_geometry and slot_fused.py::_geom_weights.
__device__ __forceinline__ unsigned cell_geom(const SlotParams& P, int l, const float p[3],
                                              float wa[3][2], float dwa[3][2],
                                              float ddwa[3][2]) {
  const float r = P.radius;
  const float resf = (float)P.res[l];
  int b[3];
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    float g = (p[t] + r) / (2.f * r);
    g = fminf(fmaxf(g, 0.f), P.clip_hi);
    const float sc = g * resf;
    const float fl = floorf(sc);
    const float fr = sc - fl;
    b[t] = min(max((int)fl, 0), P.res[l] - 1);
    float s, ds, dds;
    if (P.smooth) {
      s = fr * fr * (3.f - 2.f * fr);
      ds = 6.f * fr * (1.f - fr) * resf;
      dds = (6.f - 12.f * fr) * resf * resf;
    } else {
      s = fr;
      ds = resf;
      dds = 0.f;
    }
    wa[t][0] = 1.f - s;
    wa[t][1] = s;
    dwa[t][0] = -ds;
    dwa[t][1] = ds;
    ddwa[t][0] = -dds;
    ddwa[t][1] = dds;
  }
  if (P.dense[l]) return (unsigned)(b[0] + (b[1] + b[2] * P.res[l]) * P.res[l]);
  const unsigned h = (unsigned)b[0] ^ ((unsigned)b[1] * 2654435761u) ^ ((unsigned)b[2] * 805459861u);
  return h & P.ent_mask[l];
}

// Whether the table is bf16: its grid side rounds to bf16.
template <class TT>
constexpr bool kBf16Table = std::is_same<TT, bf16>::value;

// A grid-side value as the table's type rounds it: to bf16 for a bf16 table, not at all
// for an f32 one.
template <class TT>
__device__ __forceinline__ float grid_round(float x) {
  if constexpr (kBf16Table<TT>) return round_bf16(x);
  return x;
}

__device__ __forceinline__ float tval(bf16 x) { return bf(x); }
__device__ __forceinline__ float tval(float x) { return x; }

// Offset of a cell entry's first value in the [rows, 128] table.
__device__ __forceinline__ long long entry_offset(const SlotParams& P, int l, unsigned e) {
  const long long phys = P.row_off[l] + (long long)(e >> P.pk_shift);
  const int grp = e & ((1u << P.pk_shift) - 1u);
  return phys * 128 + grp * 8 * P.feats;
}

// trilerp weight of corner c (offset bits c = dx + 2 dy + 4 dz), rounded by the table's type
template <class TT>
__device__ __forceinline__ float corner_weight(const float wa[3][2], int c) {
  return grid_round<TT>(wa[0][c & 1] * wa[1][(c >> 1) & 1] * wa[2][(c >> 2) & 1]);
}

// d w_c / d g_t = dwa_t * wa_u * wa_v (u, v the other axes in cyclic order)
__device__ __forceinline__ float corner_axis_factor(const float wa[3][2], const float dwa[3][2],
                                                    int c, int t) {
  const int u = (t + 1) % 3, v = (t + 2) % 3;
  return dwa[t][(c >> t) & 1] * wa[u][(c >> u) & 1] * wa[v][(c >> v) & 1];
}

// 1 where coordinate p was not clipped to the grid, else 0 (_cell_coords)
__device__ __forceinline__ float clip_gate(const SlotParams& P, float p) {
  const float g = (p + P.radius) / (2.f * P.radius);
  return (g > 0.f && g < P.clip_hi) ? 1.f : 0.f;
}

__device__ __forceinline__ void load_pos(const float* pos, int n, long long row, float p[3]) {
#pragma unroll
  for (int t = 0; t < 3; ++t) p[t] = row < n ? pos[row * 3 + t] : 0.f;
}

}  // namespace mms
