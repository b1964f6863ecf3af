// The adjoint forwards K3/K3f (slot grid in front), K4 (NeRF encoding in front) and
// K5 (the input's rows) for Hopper, on K1's building blocks: adj_fwd.cuh's pass at
// the width classes WC_NARROW and WC_WIDE (WC_DEV: adj_fwd_dev.cu, linked into the
// same library, build.py PARTS), and the entry points. A call is two device
// operations: k1_pack of the chain (fused_chain.cu; its backward images serve the
// adjoint sweep here and the call's backward after it), then the pass.
//
// Replaces three Pallas TPU kernels' first ports: multimodalstudio_tpu/ops/pallas/
// fused_mlp.py _fwd_adj_kernel (:362) reached through fused_sdf_chain (:1145, K4) and
// fused_chain_adjoint (:1215, K5), and slot_fused.py _fused_fwd_kernel (:353) reached
// through fused_slot_sdf_chain (:1197, K3 and, with an f32 table, K3f).
#include "adj_fwd.cuh"

namespace k1 {

// Launch plan of the pass over n rows: the last layer's weight column and the
// grid's d pos halves in shared memory beside the ring and the activations.
static int adj_fwd_plan(const Geom& G, int n, Launch* P) {
  const int wc = width_class(G);
  const void* kernel = wc == WC_DEV    ? adj_fwd_kernel_dev()
                       : wc == WC_WIDE ? adj_fwd_kernel_of<WC_WIDE>()
                                       : adj_fwd_kernel_of<WC_NARROW>();
  const int tiles = (n + 63) / 64;
  const size_t extra = ((size_t)((G.din_pad[G.L - 1] + 3) & ~3) + MAXWG * 256) * 4;
  if (plan_chain(G, tiles, PLAN_ADJ_FWD, extra, P)) return ERR_SMEM;
  if (allow_smem(wc, kernel) != cudaSuccess) return -1;
  if (persistent(kernel, P, (tiles + P->nwg - 1) / P->nwg) != cudaSuccess) return -1;
  return 0;
}

}  // namespace k1

// Bytes of a call's device scratch (the per-slot z, adj and, past a hidden width of
// 512, activation slabs) for n rows; or a negative status.
extern "C" long long mms_adj_fwd_bytes(const k1::Geom* G, int n) {
  if (!k1::geom_ok(*G) || n < 1) return -1;
  k1::Launch P;
  const int st = k1::adj_fwd_plan(*G, n, &P);
  if (st) return st;
  size_t s[3];
  k1::adj_fwd_scratch_sizes(*G, P.grid * P.nwg, P.act_bytes, s);
  return (long long)(s[0] + s[1] + s[2]);
}

static int adj_fwd_launch(const k1::Geom& G, const mms::Enc& E, const mms::SlotParams& SP,
                          const k1::AdjFwdIo& I, int n, const void* wfw, const void* wbw,
                          const void* bpk, void* scratch, void* stream) {
  if (!k1::geom_ok(G) || n < 1 || E.width != G.d_in || I.channel < 0 ||
      I.channel >= G.dout_true[G.L - 1] || (I.sdf ? I.width + 1 : I.width) > G.dout_true[G.L - 1])
    return -1;
  k1::Launch P;
  const int st = k1::adj_fwd_plan(G, n, &P);
  if (st) return st;
  size_t s[3];
  k1::adj_fwd_scratch_sizes(G, P.grid * P.nwg, P.act_bytes, s);
  uint8_t* p = (uint8_t*)scratch;
  const k1::AdjFwdScratch S{(uint32_t*)p, (float*)(p + s[0]),
                            s[2] ? (k1::bf16*)(p + s[0] + s[1]) : nullptr};
  const auto launch = k1::width_class(G) == k1::WC_DEV    ? k1::adj_fwd_launch_dev
                      : k1::width_class(G) == k1::WC_WIDE ? k1::adj_fwd_launch<k1::WC_WIDE>
                                                          : k1::adj_fwd_launch<k1::WC_NARROW>;
  return launch(G, E, SP, I, n, wfw, wbw, bpk, S, P, (cudaStream_t)stream);
}

// G: the chain's layout (fused_mlp.py chain_layout); wfw, wbw, bpk: what mms_k1_pack
// wrote for it, backward images included; scratch: mms_adj_fwd_bytes of device memory.

// K4: positions [n, 3] f32 in; sdf [n] f32, geo [n, geo_width] bf16 and grad [n, 3]
// f32 out.
extern "C" int mms_sdf_chain_fwd(const k1::Geom* G, const void* pos, int n, int pe_freqs,
                                 const float* pe_scale, const void* wfw, const void* wbw,
                                 const void* bpk, void* sdf, void* geo, int geo_width, void* grad,
                                 void* scratch, void* stream) {
  if (pe_freqs < 1 || pe_freqs > mms::MAXPE) return -1;
  mms::Enc E{};
  E.freqs = pe_freqs;
  for (int i = 0; i < pe_freqs; ++i) E.scale[i] = pe_scale[i];
  E.width = 3 + 6 * pe_freqs;
  k1::AdjFwdIo I{};
  I.front = k1::FRONT_ENC;
  I.pos = (const float*)pos;
  I.sdf = (float*)sdf;
  I.y = (k1::bf16*)geo;
  I.width = geo_width;
  I.grad = (float*)grad;
  return adj_fwd_launch(*G, E, mms::SlotParams{}, I, n, wfw, wbw, bpk, scratch, stream);
}

// K5: x [n, d_in] (bf16, or f32 for x_bf16 = 0) in; y [n, d_out] bf16 and adj [n,
// d_in] f32 = d y[:, channel] / d x out.
extern "C" int mms_chain_adj_fwd(const k1::Geom* G, const void* x, int x_bf16, int n,
                                 int channel, const void* wfw, const void* wbw, const void* bpk,
                                 void* y, int d_out, void* adj, void* scratch, void* stream) {
  mms::Enc E{};
  E.width = G->d_in;
  k1::AdjFwdIo I{};
  I.front = k1::FRONT_ROWS;
  I.x = x;
  I.x_bf16 = x_bf16;
  I.y = (k1::bf16*)y;
  I.width = d_out;
  I.adj = (float*)adj;
  I.channel = channel;
  return adj_fwd_launch(*G, E, mms::SlotParams{}, I, n, wfw, wbw, bpk, scratch, stream);
}

// K3 (table_f32 0) or K3f (1): positions [n, 3] f32 and the f32 table parameter [rows,
// 128] (rounded to bf16 as it is read for K3) in; sdf [n] f32, geo [n, geo_width]
// bf16 and grad [n, 3] f32 out; where given, the training mode's residuals zs and ss
// [L-1, n, H] bf16 and adj [n, d_in] f32, and x0 [n, x0_width] bf16. P: the grid and
// the encoding (slot.cuh).
extern "C" int mms_slot_sdf_fwd(const k1::Geom* G, const mms::SlotParams* P, const void* pos,
                                int n, const void* table, int table_f32, const void* lmask,
                                const void* wfw, const void* wbw, const void* bpk, void* sdf,
                                void* geo, int geo_width, void* grad, void* zs, void* ss,
                                void* adj, void* x0, int x0_width, void* scratch, void* stream) {
  if (P->levels < 1 || P->levels > mms::MAXLV || P->feats < 1 || P->feats > 16 ||
      P->pe_freqs < 1 || P->pe_freqs > mms::MAXPE || P->pw + P->levels * P->feats > G->d_in ||
      (x0 && (x0_width < G->d_in || x0_width > G->P0)))
    return -1;
  mms::Enc E{};
  E.width = G->d_in;
  k1::AdjFwdIo I{};
  I.front = k1::FRONT_SLOT;
  I.table_f32 = table_f32;
  I.pos = (const float*)pos;
  I.table = (const float*)table;
  I.lmask = (const float*)lmask;
  I.sdf = (float*)sdf;
  I.y = (k1::bf16*)geo;
  I.width = geo_width;
  I.grad = (float*)grad;
  I.adj = (float*)adj;
  I.zs = (k1::bf16*)zs;
  I.ss = (k1::bf16*)ss;
  I.x0 = (k1::bf16*)x0;
  I.x0_width = x0_width;
  return adj_fwd_launch(*G, E, *P, I, n, wfw, wbw, bpk, scratch, stream);
}
