// The adjoint forward's pass (adj_fwd.cuh) at hidden widths over 512 (k1.cuh WC_DEV),
// compiled on its own and linked into the sdf_chain library (build.py PARTS), so that
// ptxas runs it beside the rest.
#include "adj_fwd.cuh"

namespace k1 {

int adj_fwd_launch_dev(const Geom& G, const mms::Enc& E, const mms::SlotParams& SP,
                       const AdjFwdIo& I, int n, const void* wfw, const void* wbw, const void* bpk,
                       const AdjFwdScratch& S, const Launch& P, cudaStream_t stream) {
  return adj_fwd_launch<WC_DEV>(G, E, SP, I, n, wfw, wbw, bpk, S, P, stream);
}

const void* adj_fwd_kernel_dev() { return adj_fwd_kernel_of<WC_DEV>(); }

}  // namespace k1
