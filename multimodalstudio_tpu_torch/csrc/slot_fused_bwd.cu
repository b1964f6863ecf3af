// Merged backward kernels of the fused slot-grid SDF chains for Hopper: K2's and K3's
// backwards with their weight-gradient and table atomics (the kernels, their design and
// bound: slot_bwd.cuh, SPLIT = false).
//
// Replaces two Pallas TPU kernels of multimodalstudio_tpu/ops/pallas/slot_fused.py:
//   K2 _value_bwd_kernel (:1370), via op_bwd (:1737): first-order backward of sdf;
//   K3 _fused_bwd_kernel (:474), via op_bwd (:1149): backward of (sdf, geo, d sdf / d x),
//      reverse over reverse.
// Both return d pos [N, 3] f32, d table [rows, 128] f32 and the chain's gW / gb f32 (packed).
#include "slot_bwd.cuh"

using namespace mms;

// scratch: null, or max_ctas slabs of mms_slot_bwd_slab elements for the residual stacks.
extern "C" int mms_slot_value_bwd(SLOT_COMMON_PARAMS, const void* zs, const void* gsdf,
                                  void* d_pos, void* d_table, void* gw, void* gb, void* scratch,
                                  int max_ctas, void* stream) {
  return launch_value_bwd<false>(pos, n, table, lmask, wpack, bpack, n_layers, in_dims, out_dims,
                                 hidden, p0, act, quad_a, levels, feats, pk_shift, res, dense,
                                 ent_mask, row_off, radius, clip_hi, smooth, pe_freqs, pe_scale,
                                 zs, gsdf, d_pos, d_table, gw, gb, SplitOut{}, scratch, max_ctas,
                                 stream);
}

extern "C" int mms_slot_chain_bwd(SLOT_COMMON_PARAMS, const void* zs, const void* ss,
                                  const void* adj, int adj_width, const void* gsdf,
                                  const void* ggeo, int geo_width, const void* g3, void* d_pos,
                                  void* d_table, void* gw, void* gb, void* scratch, int max_ctas,
                                  void* stream) {
  return launch_chain_bwd<false>(pos, n, table, lmask, wpack, bpack, n_layers, in_dims, out_dims,
                                 hidden, p0, act, quad_a, levels, feats, pk_shift, res, dense,
                                 ent_mask, row_off, radius, clip_hi, smooth, pe_freqs, pe_scale,
                                 zs, ss, adj, adj_width, gsdf, ggeo, geo_width, g3, d_pos,
                                 d_table, gw, gb, SplitOut{}, scratch, max_ctas, stream);
}
