// The table scatter of the split backward of the fused slot-grid SDF chains for Hopper
// (MMS_SLOT_BWD_SPLIT=1); the per-sample passes of K2s and K3s are slot_chain_bwd.cu's
// pass, whose split flag writes each (sample, level)'s table cotangent compact as [N, K,
// 8F] in the table's type (bf16, or f32 for an f32 table, slot_fused.py:1055, 1652).
//
// Replaces the Pallas TPU kernel multimodalstudio_tpu/ops/pallas/slot_fused.py
// _bwd_scatter_kernel (:925): the table cotangent added into the f32 table gradient, each
// (sample, level)'s entry recomputed from the position (as the TPU kernel recomputes its
// rows, :925-935). The TPU's one-hot MXU scatter over a lane-padded [N, K * 128]
// cotangent is a mechanism of its matrix unit.
//
// Bound on an H100: the bytes of the cotangent, read once (755 MB at the f32 table's two
// calls of a training microbatch, 47 MB at the bf16 table's), with the positions and the
// table gradient. Training keeps one level active, so most chunks (a (sample, level)'s 8F
// values) are zeros; the active coarse level's few entries take every sample. The design:
// - a block takes one level, 128 / G lane groups of G lanes, each lane reading 16 bytes of
//   a chunk (G = 2 at a bf16 table with F = 2, 32 at an f32 one with F = 16), so a group
//   reads its chunk whole and a warp's read is whole sectors; a group walks a run of
//   consecutive samples (group_run), 4 chunks in flight a lane, read evict-first;
// - a chunk that is all zero (a ballot over the group) adds nothing and needs no position;
//   a batch of 4 with a live chunk reads its positions at once, and the entry is computed
//   once per live (sample, level);
// - a lane sums its values in registers while the group's entry stays the same (along a
//   ray a coarse level's entry holds for tens of samples) and adds them, when the entry
//   changes or the run ends, by red.global.add.v4.f32 (one a lane at an f32 table, two at
//   a bf16 one), all-zero quads skipped.
// The bf16 cotangent was rounded by the pass (slot_fused.py:224-228 in JAX); its values are
// summed in f32, in an order that changes from run to run.
#include "slot.cuh"
#include "warp.cuh"

using namespace mms;

namespace {

constexpr int BLOCK = 128;
constexpr int BATCH = 4;  // chunks a lane has in flight

// A lane's 16 bytes of a chunk as floats: 4 f32 values, or 8 bf16 ones.
template <class DT>
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[16 / sizeof(DT)]) {
  const unsigned wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (sizeof(DT) == 4) {
      x[q] = __uint_as_float(wd[q]);
    } else {
      x[2 * q] = __uint_as_float(wd[q] << 16);
      x[2 * q + 1] = __uint_as_float(wd[q] & 0xffff0000u);
    }
  }
}

template <class DT, int F>
__global__ void __launch_bounds__(BLOCK)
slot_table_scatter_kernel(const float* __restrict__ pos, int n, const DT* __restrict__ dcomp,
                          SlotParams P, int seg, float* __restrict__ d_table) {
  constexpr int NV = 16 / sizeof(DT);  // values a lane reads
  constexpr int G = 8 * F / NV;        // lanes of a group: one chunk
  constexpr int NG = BLOCK / G;
  const int k = P.levels, l = blockIdx.x % k;
  const int j = threadIdx.x % G;
  const unsigned gm = group_mask<G>();
  const long long sb = ((long long)(blockIdx.x / k) * NG + threadIdx.x / G) * seg;
  const long long se = min(sb + seg, (long long)n);
  // the lane's 16 bytes of chunk (s, l), and the step from one sample's to the next's
  const uint4* src = reinterpret_cast<const uint4*>(dcomp) + (sb * k + l) * G + j;
  const long long step = (long long)k * G;
  long long key = -1;  // the table offset of the lane's values of the entry it sums for
  float pend[NV];
  for (long long s = sb; s < se; s += BATCH) {
    uint4 v[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b)
      v[b] = s + b < se ? __ldcs(src + (s - sb + b) * step) : make_uint4(0u, 0u, 0u, 0u);
    bool live[BATCH], any = false;
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      float x[NV];
      unpack<DT>(v[b], x);
      bool nz = false;
#pragma unroll
      for (int q = 0; q < NV; ++q) nz |= x[q] != 0.f;
      live[b] = __any_sync(gm, nz);
      any |= live[b];
    }
    if (!any) continue;
    float p[BATCH][3];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) load_pos(pos, n, s + b, p[b]);
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      if (!live[b]) continue;
      float x[NV], wa[3][2], dwa[3][2], ddwa[3][2];
      unpack<DT>(v[b], x);
      const long long off = entry_offset(P, l, cell_geom(P, l, p[b], wa, dwa, ddwa)) + j * NV;
      if (off != key) {
        if (key >= 0) {
#pragma unroll
          for (int q = 0; q < NV; q += 4) red4_nonzero(d_table + key + q, pend + q);
        }
        key = off;
#pragma unroll
        for (int q = 0; q < NV; ++q) pend[q] = x[q];
      } else {
#pragma unroll
        for (int q = 0; q < NV; ++q) pend[q] += x[q];
      }
    }
  }
  if (key >= 0) {
#pragma unroll
    for (int q = 0; q < NV; q += 4) red4_nonzero(d_table + key + q, pend + q);
  }
}

template <class DT, int F>
int launch(const float* pos, int n, const void* dcomp, const SlotParams& P, float* d_table,
           cudaStream_t stream) {
  constexpr int G = 8 * F * (int)sizeof(DT) / 16;
  const int seg = group_run(n, P.levels, G);
  const long long per_block = (long long)(BLOCK / G) * seg;
  const unsigned grid = (unsigned)((n + per_block - 1) / per_block * P.levels);
  slot_table_scatter_kernel<DT, F><<<grid, BLOCK, 0, stream>>>(pos, n, (const DT*)dcomp, P, seg,
                                                                d_table);
  return (int)cudaGetLastError();
}

template <class DT>
int launch_f(const float* pos, int n, const void* dcomp, const SlotParams& P, float* d_table,
             cudaStream_t s) {
  switch (P.feats) {
    case 2: return launch<DT, 2>(pos, n, dcomp, P, d_table, s);
    case 4: return launch<DT, 4>(pos, n, dcomp, P, d_table, s);
    case 8: return launch<DT, 8>(pos, n, dcomp, P, d_table, s);
    default: return launch<DT, 16>(pos, n, dcomp, P, d_table, s);
  }
}

}  // namespace

// The scatter: d_table [rows, 128] f32 (zeroed by the caller) += d_comp [N, K, 8F], bf16 or
// (dcomp_f32) f32; d_comp and d_table 16-byte aligned.
extern "C" int mms_slot_table_scatter(const void* pos, int n, const void* dcomp, int dcomp_f32,
                                      int levels, int feats, int pk_shift, const int* res,
                                      const int* dense, const int* ent_mask, const int* row_off,
                                      float radius, float clip_hi, void* d_table, void* stream) {
  SlotParams P;
  if (fill_slot_params(P, levels, feats, pk_shift, res, dense, ent_mask, row_off, radius,
                       clip_hi, 0, 0, nullptr))
    return -1;
  if (n < 1 || (feats != 2 && feats != 4 && feats != 8 && feats != 16) || !aligned16(dcomp) ||
      !aligned16(d_table))
    return -1;
  const auto s = (cudaStream_t)stream;
  if (dcomp_f32) return launch_f<float>((const float*)pos, n, dcomp, P, (float*)d_table, s);
  return launch_f<bf16>((const float*)pos, n, dcomp, P, (float*)d_table, s);
}
