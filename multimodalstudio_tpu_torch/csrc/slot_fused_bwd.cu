// The merged backward kernel of the fused slot-grid SDF value chain for Hopper: K2's
// backward with its weight-gradient and table atomics (the kernel, its design and bound:
// slot_bwd.cuh, SPLIT = false).
//
// Replaces the Pallas TPU kernel multimodalstudio_tpu/ops/pallas/slot_fused.py
// _value_bwd_kernel (:1370), via op_bwd (:1737): first-order backward of sdf, returning
// d pos [N, 3] f32, d table [rows, 128] f32 and the chain's gW / gb f32 (packed), for a
// bf16 or (table_f32, K2f) an f32 table and a chain with or without skips. K3's merged
// backward is slot_chain_bwd.cu's pass.
#include "slot_bwd.cuh"

using namespace mms;

// scratch: null, or max_ctas slabs of mms_slot_bwd_slab elements for the residual stacks.
extern "C" int mms_slot_value_bwd(SLOT_COMMON_PARAMS, const void* zs, const void* gsdf,
                                  void* d_pos, void* d_table, void* gw, void* gb, void* scratch,
                                  int max_ctas, void* stream) {
  return launch_value_bwd<false>(pos, n, table, lmask, wpack, bpack, n_layers, in_dims, out_dims,
                                 hidden, p0, act, quad_a, levels, feats, pk_shift, res, dense,
                                 ent_mask, row_off, radius, clip_hi, smooth, pe_freqs, pe_scale,
                                 skip_mask, table_f32, zs, gsdf, d_pos, d_table, gw, gb,
                                 SplitOut{}, scratch, max_ctas, stream);
}
