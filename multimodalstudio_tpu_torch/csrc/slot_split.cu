// The table scatter of the split backward of the fused slot-grid SDF chains for Hopper
// (MMS_SLOT_BWD_SPLIT=1); the per-sample passes of K2s and K3s are slot_chain_bwd.cu's
// pass, whose split flag writes each (sample, level)'s table cotangent compact as [N, K,
// 8F] in the table's type (bf16, or f32 for an f32 table, slot_fused.py:1055, 1652).
//
// Replaces the Pallas TPU kernel multimodalstudio_tpu/ops/pallas/slot_fused.py
// _bwd_scatter_kernel (:925): the table cotangent added into the f32 table gradient.
// One thread per (sample, level) recomputes the cell entry from the position (as the
// TPU kernel recomputes its rows, :925-935) and adds the entry's 8F cotangent values
// into the table gradient with f32 atomics, zeros skipped; the 8F values are read as
// 16-byte loads of the compact cotangent (512 bytes per (sample, level) at F = 16 with
// an f32 table). The TPU's one-hot MXU scatter over a lane-padded [N, K * 128]
// cotangent is a mechanism of its matrix unit. Bound on an H100: bytes (positions and
// the cotangent read once, the table gradient written once); the atomics into the few
// rows of the coarse dense levels contend.
#include "slot.cuh"

using namespace mms;

constexpr int BLOCK = 256;

template <class DT>
__global__ void __launch_bounds__(BLOCK)
slot_table_scatter_kernel(const float* __restrict__ pos, int n, const DT* __restrict__ dcomp,
                          SlotParams P, float* __restrict__ d_table) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= (long long)n * P.levels) return;
  const int l = (int)(i % P.levels);
  float p[3], wa[3][2], dwa[3][2], ddwa[3][2];
  load_pos(pos, n, i / P.levels, p);
  float* dt = d_table + entry_offset(P, l, cell_geom(P, l, p, wa, dwa, ddwa));
  const int ew = 8 * P.feats;
  constexpr int per = 16 / sizeof(DT);  // values per 16-byte load
  const uint4* src = reinterpret_cast<const uint4*>(dcomp + i * ew);
  for (int q = 0; q < ew / per; ++q) {
    const uint4 u = src[q];
    const DT* v = reinterpret_cast<const DT*>(&u);
#pragma unroll
    for (int j = 0; j < per; ++j) {
      const float x = tval(v[j]);
      if (x != 0.f) atomicAdd(dt + q * per + j, x);
    }
  }
}

// The scatter: d_table [rows, 128] f32 (zeroed by the caller) += d_comp [N, K, 8F], bf16 or
// (dcomp_f32) f32.
extern "C" int mms_slot_table_scatter(const void* pos, int n, const void* dcomp, int dcomp_f32,
                                      int levels, int feats, int pk_shift, const int* res,
                                      const int* dense, const int* ent_mask, const int* row_off,
                                      float radius, float clip_hi, void* d_table, void* stream) {
  SlotParams P;
  if (fill_slot_params(P, levels, feats, pk_shift, res, dense, ent_mask, row_off, radius,
                       clip_hi, 0, 0, nullptr))
    return -1;
  const long long threads = (long long)n * levels;
  const int grid = (int)((threads + BLOCK - 1) / BLOCK);
  if (dcomp_f32)
    slot_table_scatter_kernel<float><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)pos, n, (const float*)dcomp, P, (float*)d_table);
  else
    slot_table_scatter_kernel<bf16><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)pos, n, (const bf16*)dcomp, P, (float*)d_table);
  return (int)cudaGetLastError();
}
