// The adjoint backward's per-tile pass (adj_pass.cuh) at hidden widths over 512
// (k1.cuh WC_DEV), compiled on its own and linked into the sdf_chain library
// (build.py PARTS), so that ptxas runs it beside the rest of sdf_chain.cu.
#include "adj_pass.cuh"

namespace k1 {

int adj_pass_launch_dev(const Geom& G, const mms::Enc& E, const AdjIo& I, int n, const void* wfw,
                        const void* wbw, const void* bpk, void* gw, void* gb,
                        const AdjScratch& S, const Launch& P, void* count, cudaStream_t stream) {
  return adj_pass_launch<WC_DEV>(G, E, I, n, wfw, wbw, bpk, gw, gb, S, P, count, stream);
}

const void* adj_pass_kernel_dev() { return adj_pass_kernel<WC_DEV>(); }

}  // namespace k1
