// Shared pieces of the fused slot-grid kernels (slot_fused.cu, slot_fused_bwd.cu):
// the grid and encoding constants, the cell geometry of one (sample, level), and
// the front end that builds a tile's chain input x0 = [pos, sin, cos, grid, 0].
#pragma once

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

// Offset of a cell entry's first value in the [rows, 128] table.
__device__ __forceinline__ long long entry_offset(const SlotParams& P, int l, unsigned e) {
  const long long phys = P.row_off[l] + (long long)(e >> P.pk_shift);
  const int grp = e & ((1u << P.pk_shift) - 1u);
  return phys * 128 + grp * 8 * P.feats;
}

// bf16 trilerp weight of corner c (offset bits c = dx + 2 dy + 4 dz)
__device__ __forceinline__ float corner_weight(const float wa[3][2], int c) {
  return round_bf16(wa[0][c & 1] * wa[1][(c >> 1) & 1] * wa[2][(c >> 2) & 1]);
}

// d w_c / d g_t = dwa_t * wa_u * wa_v (u, v the other axes in cyclic order)
__device__ __forceinline__ float corner_axis_factor(const float wa[3][2], const float dwa[3][2],
                                                    int c, int t) {
  const int u = (t + 1) % 3, v = (t + 2) % 3;
  return dwa[t][(c >> t) & 1] * wa[u][(c >> u) & 1] * wa[v][(c >> v) & 1];
}

__device__ __forceinline__ void load_pos(const float* pos, int n, long long row, float p[3]) {
#pragma unroll
  for (int t = 0; t < 3; ++t) p[t] = row < n ? pos[row * 3 + t] : 0.f;
}

// The tile's chain input into buf [64, lds] bf16 (columns [0, p0)) and its
// cell entries into sT [64, levels, 8F]. Grid part: one thread per (sample,
// level) reads the entry as 16-byte loads; table and trilerp weight rounded
// to bf16, their product rounded to bf16 before the 8-corner f32 sum, the sum
// times the coarse-to-fine mask rounded to bf16. NeRF encoding [x, sin(x_d
// 2^i), cos(x_d 2^i)] (d-major) with sinf / cosf; zeros past the active
// levels. Ends with __syncthreads().
__device__ __forceinline__ void slot_front(const SlotParams& P, int p0, const float* pos, int n,
                                           long long row0, const bf16* table, const float* lmask,
                                           bf16* buf, int lds, bf16* sT) {
  const int ew = 8 * P.feats;
  for (int i = threadIdx.x; i < TILE_M * P.levels; i += NTHREADS) {
    const int r = i / P.levels, l = i % P.levels;
    float p[3];
    load_pos(pos, n, row0 + r, p);
    float wa[3][2], dwa[3][2], ddwa[3][2];
    const unsigned e = cell_geom(P, l, p, wa, dwa, ddwa);
    const uint4* src = reinterpret_cast<const uint4*>(table + entry_offset(P, l, e));
    uint4* dst = reinterpret_cast<uint4*>(sT + (r * P.levels + l) * ew);
    for (int q = 0; q < ew / 8; ++q) dst[q] = src[q];
    const bf16* T = sT + (r * P.levels + l) * ew;
    float wb[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) wb[c] = corner_weight(wa, c);
    for (int f = 0; f < P.feats; ++f) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc += round_bf16(bf(T[f * 8 + c]) * wb[c]);
      buf[r * lds + P.pw + l * P.feats + f] = __float2bfloat16(acc * lmask[l * P.feats + f]);
    }
  }
  const int grid_end = P.pw + P.levels * P.feats;
  for (int i = threadIdx.x; i < TILE_M * p0; i += NTHREADS) {
    const int r = i / p0, c = i % p0;
    if (c >= P.pw && c < grid_end) continue;
    float v = 0.f;
    if (c < P.pw && row0 + r < n) v = pe_col(pos + (row0 + r) * 3, P.pe_freqs, P.pe_scale, c);
    buf[r * lds + c] = __float2bfloat16(v);
  }
  __syncthreads();
}

}  // namespace mms
