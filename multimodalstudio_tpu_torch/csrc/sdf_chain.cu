// The backwards of K4 (NeRF encoding in front) and K5 (an already-encoded input) for
// Hopper, on K1's building blocks: adj_pass.cuh's per-tile pass at the width classes
// WC_NARROW and WC_WIDE (WC_DEV: sdf_chain_dev.cu) and the entry points. Their
// forwards, and K3's, are adj_fwd.cu's pass, linked into the same library.
//
// Replaces the Pallas TPU kernel multimodalstudio_tpu/ops/pallas/fused_mlp.py
// _bwd_adj_kernel (:410), built by _build_adj_chain (:930) and reached through
// fused_sdf_chain (:1145, mode="adjoint", the encoding inside) and fused_chain_adjoint
// (:1215, enc=None): reverse over reverse, the chain's gW / gb f32 (packed) and d pos
// [N, 3] f32 (K4) or gx [N, D] bf16 (K5).
//
// A per-tile pass on wgmma writes the stacks of every gW operand, and chain_wgrad
// (fused_chain.cu) adds each CTA's gW tile once; see adj_pass.cuh. Only the front
// end, the outputs and the backward's ga and d pos / gx steps differ between K4 and
// K5: the pass reads the encoding's frequency count (0 for K5) at run time, one
// kernel for both.
//
// Cast points follow the reference: z stored bf16 and act' / act'' read from it; v
// rounded to bf16 before each product; s stored bf16 after the skip scale; the
// adjoint's cotangent ga (K4: sum_k g3_k bf16(t0_k); K5: the f32 input) kept f32 and
// rounded to bf16 at each product (re-injected at a skip as bf16(ga / sqrt 2)); e_l =
// bf16(m * s * act''(z)); the last layer's cotangent bf16 (K4: its sdf column f32 for
// gb); gz rounded to bf16 before both products and gb summing the f32 gz; gW = hin^T
// gz + qin^T v; K5's gx rounded to bf16. The gW / gb sums across CTAs are f32 atomics,
// so their order changes from run to run.
//
// Bound on an H100: per sample the backward runs the chain about six times (recompute
// primal and adjoint, the ga-forward chain and its gW, gW and gh of the reverse sweep)
// against a few hundred bytes of positions and cotangents: the tensor cores bound it.
// The stacks (about 15 KB per sample at the mlp_raw_tpu widths, written once and read
// by chain_wgrad) put its memory traffic near the tensor-core time; PERF.md has the
// times.
#include "adj_pass.cuh"

namespace k1 {

// Launch plan and scratch of the pass over n rows: the column sums of gb and of
// qin_{L-1} and the last layer's weight column in shared memory beside K1's
// backward layout.
static int adj_plan(const Geom& G, int n, Launch* P) {
  const int wc = width_class(G);
  const void* kernel = wc == WC_DEV    ? adj_pass_kernel_dev()
                       : wc == WC_WIDE ? adj_pass_kernel<WC_WIDE>()
                                       : adj_pass_kernel<WC_NARROW>();
  const int tiles = (n + 63) / 64;
  const size_t extra = ((size_t)((G.din_true[G.L - 1] + 3) & ~3) + G.din_pad[G.L - 1]) * 4;
  if (plan_chain(G, tiles, true, extra, P)) return ERR_SMEM;
  if (allow_smem(width_class(G), kernel) != cudaSuccess) return -1;
  if (persistent(kernel, P, (tiles + P->nwg - 1) / P->nwg) != cudaSuccess) return -1;
  return 0;
}

static bool adj_ok(const Geom& G, const mms::Enc& E, int channel) {
  return geom_ok(G) && E.width == G.d_in && channel >= 0 && channel < G.dout_true[G.L - 1];
}

}  // namespace k1

// ------------------------------------------------------------- backward entry points
//
// G: the chain's layout (fused_mlp.py chain_layout with two stack tiles per row
// tile below the last layer); wfw, wbw, bpk: what mms_k1_pack wrote for it. The
// pass accumulates into gw (the last layer's column `channel` term) and gb, and
// leaves the stacks at the start of scratch for mms_k1_wgrad over (n + 63) / 64
// row tiles. count (or null) receives the number of gW atomics the pass issued.

static int adj_bwd_launch(const k1::Geom& G, const mms::Enc& E, const k1::AdjIo& I, int n,
                          const void* wfw, const void* wbw, const void* bpk, void* gw, void* gb,
                          void* scratch, void* count, void* stream) {
  if (!k1::adj_ok(G, E, I.channel) || n < 1) return -1;
  k1::Launch P;
  const int st = k1::adj_plan(G, n, &P);
  if (st) return st;
  size_t s[6];
  k1::adj_scratch_sizes(G, (n + 63) / 64, P.grid * P.nwg, P.act_bytes, s);
  uint8_t* p = (uint8_t*)scratch;
  const k1::AdjScratch S{(k1::bf16*)p, (k1::bf16*)(p + s[0]), (uint32_t*)(p + s[0] + s[1]),
                         (uint32_t*)(p + s[0] + s[1] + s[2]),
                         (float*)(p + s[0] + s[1] + s[2] + s[3]),
                         s[5] ? (k1::bf16*)(p + s[0] + s[1] + s[2] + s[3] + s[4]) : nullptr};
  const auto launch = k1::width_class(G) == k1::WC_DEV    ? k1::adj_pass_launch_dev
                     : k1::width_class(G) == k1::WC_WIDE ? k1::adj_pass_launch<k1::WC_WIDE>
                                                         : k1::adj_pass_launch<k1::WC_NARROW>;
  return launch(G, E, I, n, wfw, wbw, bpk, gw, gb, S, P, count, (cudaStream_t)stream);
}

// Bytes of the backward's device scratch (stacks and per-CTA slabs) for n rows.
extern "C" long long mms_adj_bwd_bytes(const k1::Geom* G, int n) {
  if (!k1::geom_ok(*G) || n < 1) return -1;
  k1::Launch P;
  const int st = k1::adj_plan(*G, n, &P);
  if (st) return st;
  size_t s[6];
  k1::adj_scratch_sizes(*G, (n + 63) / 64, P.grid * P.nwg, P.act_bytes, s);
  return (long long)(s[0] + s[1] + s[2] + s[3] + s[4] + s[5]);
}

// K4's backward pass: positions [n, 3] f32 and the cotangents gsdf [n] f32, ggeo
// [n, geo_width] bf16 and g3 [n, 3] f32 in; d_pos [n, 3] f32 out.
extern "C" int mms_sdf_chain_bwd(const k1::Geom* G, const void* pos, int n, int pe_freqs,
                                 const float* pe_scale, const void* gsdf, const void* ggeo,
                                 int geo_width, const void* g3, const void* wfw, const void* wbw,
                                 const void* bpk, void* d_pos, void* gw, void* gb, void* scratch,
                                 void* count, void* stream) {
  if (pe_freqs < 1 || pe_freqs > mms::MAXPE || geo_width >= G->dout_true[G->L - 1]) return -1;
  mms::Enc E;
  E.freqs = pe_freqs;
  for (int i = 0; i < pe_freqs; ++i) E.scale[i] = pe_scale[i];
  E.width = 3 + 6 * pe_freqs;
  const k1::AdjIo I{(const float*)pos, nullptr, (const float*)gsdf, (const k1::bf16*)ggeo,
                    (const float*)g3, (float*)d_pos, nullptr, geo_width, 0};
  return adj_bwd_launch(*G, E, I, n, wfw, wbw, bpk, gw, gb, scratch, count, stream);
}

// K5's backward pass: x [n, d_in] bf16, gy [n, d_out] bf16 and ga [n, d_in] f32 in;
// gx [n, d_in] bf16 out.
extern "C" int mms_chain_adj_bwd(const k1::Geom* G, const void* x, int n, int channel,
                                 const void* gy, const void* ga, const void* wfw, const void* wbw,
                                 const void* bpk, void* gx, void* gw, void* gb, void* scratch,
                                 void* count, void* stream) {
  mms::Enc E;
  E.freqs = 0;
  E.width = G->d_in;
  const k1::AdjIo I{nullptr, (const k1::bf16*)x, nullptr, (const k1::bf16*)gy, (const float*)ga,
                    nullptr, (k1::bf16*)gx, G->dout_true[G->L - 1], channel};
  return adj_bwd_launch(*G, E, I, n, wfw, wbw, bpk, gw, gb, scratch, count, stream);
}
