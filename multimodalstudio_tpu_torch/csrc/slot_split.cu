// The split backward of the fused slot-grid SDF chains for Hopper (MMS_SLOT_BWD_SPLIT=1):
// K2's per-sample pass and the table scatter of both chains. The value chain's weight
// gradients are dense products over the pass's stack, left to PyTorch's matrix products
// as the JAX package leaves them to XLA (_value_wgrads_xla :1567); K3's per-sample pass
// and its weight gradients are slot_chain_bwd.cu's pass and chain_wgrad.
//
// Replaces two Pallas TPU kernels of multimodalstudio_tpu/ops/pallas/slot_fused.py:
//   K2s _value_bwd_sample_kernel (:1485): K2's backward per sample, without the weight
//       gradient and table accumulators: d pos, the table cotangent, the gz stack;
//   _bwd_scatter_kernel (:925): the table cotangent added into the f32 table gradient.
// The per-sample pass is the merged backward's tile code without its atomics
// (slot_bwd.cuh, SPLIT = true). It writes each (sample, level)'s table cotangent in the
// table's type: bf16 for a bf16 table, f32 for an f32 one (slot_fused.py:1652).
//
// The scatter: one thread per (sample, level) recomputes the cell entry from the position
// (as the TPU kernel recomputes its rows, :925-935) and adds the entry's 8F cotangent values
// into the table gradient with f32 atomics, zeros skipped; the 8F values are read as 16-byte
// loads of the compact [N, K, 8F] cotangent (bf16, or f32 for an f32 table: 512 bytes per
// (sample, level) at F = 16). The TPU's one-hot MXU scatter over a lane-padded [N, K * 128]
// cotangent is a mechanism of its matrix unit. Bound on an H100: bytes (positions and the
// cotangent read once, the table gradient written once); the atomics into the few rows of
// the coarse dense levels contend.
#include "slot_bwd.cuh"

using namespace mms;

template <class DT>
__global__ void __launch_bounds__(NTHREADS)
slot_table_scatter_kernel(const float* __restrict__ pos, int n, const DT* __restrict__ dcomp,
                          SlotParams P, float* __restrict__ d_table) {
  const long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x;
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

// K2s: d pos [N, 3] f32, d_comp [N, K, 8F] (bf16, f32 for an f32 table), gz [L-1, N, H]
// bf16. scratch: null, or max_ctas slabs of mms_slot_bwd_slab elements for the residual
// stack.
extern "C" int mms_slot_value_bwd_sample(SLOT_COMMON_PARAMS, const void* zs, const void* gsdf,
                                         void* d_pos, void* dcomp, void* gzs, void* scratch,
                                         int max_ctas, void* stream) {
  const SplitOut so{dcomp, (bf16*)gzs};
  return launch_value_bwd<true>(pos, n, table, lmask, wpack, bpack, n_layers, in_dims, out_dims,
                                hidden, p0, act, quad_a, levels, feats, pk_shift, res, dense,
                                ent_mask, row_off, radius, clip_hi, smooth, pe_freqs, pe_scale,
                                skip_mask, table_f32, zs, gsdf, d_pos, nullptr, nullptr, nullptr,
                                so, scratch, max_ctas, stream);
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
  const int grid = (int)((threads + NTHREADS - 1) / NTHREADS);
  if (dcomp_f32)
    slot_table_scatter_kernel<float><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        (const float*)pos, n, (const float*)dcomp, P, (float*)d_table);
  else
    slot_table_scatter_kernel<bf16><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        (const float*)pos, n, (const bf16*)dcomp, P, (float*)d_table);
  return (int)cudaGetLastError();
}
