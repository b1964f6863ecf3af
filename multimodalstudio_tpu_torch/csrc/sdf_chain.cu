// Fused MLP chain + reverse-mode input gradient (adjoint mode) for Hopper: kernels
// K4 (NeRF encoding in front) and K5 (an already-encoded input), forward and backward.
//
// Replaces two Pallas TPU kernels of multimodalstudio_tpu/ops/pallas/fused_mlp.py, built
// by _build_adj_chain (:930) and reached through fused_sdf_chain (:1145, mode="adjoint",
// the encoding inside) and fused_chain_adjoint (:1215, enc=None):
//   _fwd_adj_kernel (:362): the chain and one reverse (adjoint) sweep of it from one
//      output channel. K4: raw positions [N, 3] in, the encoding built in the kernel;
//      sdf [N] f32, geo [N, G] bf16 and grad = J_enc^T adj [N, 3] f32 out. K5: a bf16
//      input [N, D] in; y [N, D_out] bf16 and adj = d y_c / d x [N, D] f32 out;
//   _bwd_adj_kernel (:410): their backward, reverse over reverse: the chain's gW / gb
//      f32 (packed) and d pos [N, 3] f32 (K4) or gx [N, D] bf16 (K5).
//
// The forwards (the first design): a CTA owns 64 samples at a time. The chain input x0
// is built in shared memory as bf16 (front: the encoding [x, sin(x_d s_i), cos(x_d s_i)]
// of enc.cuh, or the input's rows), the chain runs on the tensor cores with chain.cuh's
// wmma helper and epilogues, and the adjoint sweep splits a skip layer's s into its h
// part (into the next v) and its x0 part (added to adj), as _adj_sweep (:327-359) does.
// The forward is persistent (at most max_ctas CTAs walk the tiles) and keeps the
// tile's z stack (7 x 64 x 256 x 2 = 229,376 B at the mlp_raw_tpu widths, about a
// block's whole shared memory) in a per-CTA slab of device scratch. Shared memory
// holds the two activation tiles, x0, and the f32 adjoint rows [64, p0].
//
// The backwards (redesigned for Hopper on K1's building blocks, k1.cuh): a per-tile
// pass on wgmma that writes the stacks of every gW operand, and chain_wgrad
// (fused_chain.cu), which adds each CTA's gW tile once; see "backward" below. Only the
// front end, the outputs and the backward's ga and d pos / gx steps differ between K4
// and K5: the forwards take a template flag ENC, the backward pass reads the
// encoding's frequency count (0 for K5) at run time, one kernel for both. The pass
// (adj_pass.cuh) compiles once per width class (k1.cuh WC), the device-memory class
// in sdf_chain_dev.cu.
//
// Cast points follow the reference: z stored bf16 and act' / act'' read from it; the
// last layer f32 (K4's sdf) and rounded to bf16 (geo, K5's y); v rounded to bf16 before
// each product; s stored bf16 after the skip scale; the adjoint's cotangent ga (K4:
// sum_k g3_k bf16(t0_k); K5: the f32 input) kept f32 and rounded to bf16 at each product
// (re-injected at a skip as bf16(ga / sqrt 2)); e_l = bf16(m * s * act''(z)); the last
// layer's cotangent bf16 (K4: its sdf column f32 for gb); gz rounded to bf16 before both
// products and gb summing the f32 gz; gW = hin^T gz + qin^T v; K5's gx rounded to bf16.
// The gW / gb sums across CTAs are f32 atomics, so their order changes from run to run.
//
// Bound on an H100: per sample the forward runs the chain twice (primal and adjoint,
// ~1.9 MFLOP at 8 x 256) and the backward about six times (recompute primal and
// adjoint, the ga-forward chain and its gW, gW and gh of the reverse sweep) against
// 12 + 4 + 512 + 12 bytes of positions and outputs per sample: the tensor cores bound
// both. The backward's stacks (about 15 KB per sample at those widths, written once
// and read by chain_wgrad) put its memory traffic near the tensor-core time; PERF.md
// has the times.
#include "enc.cuh"
#include "k1.cuh"

using namespace mms;

// The tile's chain input x0 into buf [64, lds] and x0 [64, ldx0] (zero past E.width,
// to p0, and past n): the bf16 encoding of the positions pos [n, 3] (ENC) or the rows
// of the bf16 input x [n, E.width]. Ends with __syncthreads().
template <bool ENC>
__device__ __forceinline__ void front(const Enc& E, int p0, const float* pos, const bf16* x,
                                      int n, long long row0, bf16* buf, int lds, bf16* x0,
                                      int ldx0) {
  for (int i = threadIdx.x; i < TILE_M * p0; i += NTHREADS) {
    const int r = i / p0, c = i % p0;
    bf16 b = __float2bfloat16(0.f);
    if (c < E.width && row0 + r < n)
      b = ENC ? __float2bfloat16(pe_col(pos + (row0 + r) * 3, E.freqs, E.scale, c))
              : x[(row0 + r) * E.width + c];
    buf[r * lds + c] = b;
    x0[r * ldx0 + c] = b;
  }
  __syncthreads();
}

// The adjoint sweep (fused_mlp.py:327-359) from v = e_channel in va: for l = L-1 .. 1,
// s = bf16(v) W_l^T; a skip layer adds its x0 part * (1/sqrt 2) to sAdj and scales
// its h part; v = s * act'(z_{l-1}). Layer 0 adds s to sAdj, which must be zero on
// entry. With ss != nullptr the h part of s of layer l goes to ss[l-1] as bf16 (the
// backward's residual). zs / ss: (L-1) x [64, H]. Ends with __syncthreads().
__device__ __forceinline__ void adjoint_sweep(const Chain& C, int channel, const bf16* wpack,
                                              bf16* va, bf16* vb, int lds, const bf16* zs,
                                              bf16* ss, float* sAdj, float* stage) {
  const int L = C.n_layers, H = C.hidden, p0 = C.p0;
  const int lane = threadIdx.x & 31;
  const int dl = C.out_dims[L - 1];
  for (int i = threadIdx.x; i < TILE_M * dl; i += NTHREADS) {
    const int r = i / dl, c = i % dl;
    va[r * lds + c] = __float2bfloat16(c == channel ? 1.f : 0.f);
  }
  __syncthreads();
  for (int l = L - 1; l >= 1; --l) {
    const bool sk = (C.skip_mask >> l) & 1;
    const int hw = sk ? C.in_dims[l] - p0 : C.in_dims[l];
    const bf16* zl = zs + (long long)(l - 1) * TILE_M * H;
    bf16* sl = ss ? ss + (long long)(l - 1) * TILE_M * H : nullptr;
    mma_tile64<true>(va, lds, C.out_dims[l], wpack + C.w_off[l], C.out_dims[l], C.in_dims[l],
                     stage, [&](int r0, int c0, const float* t) {
                       for (int i = lane; i < 256; i += 32) {
                         const int r = r0 + (i >> 4), c = c0 + (i & 15);
                         if (c < hw) {
                           const float s = sk ? t[i] * SKIP_SCALE : t[i];
                           vb[r * lds + c] =
                               __float2bfloat16(s * act_df(C.act, bf(zl[r * H + c]), C.quad_a));
                           if (sl) sl[r * H + c] = __float2bfloat16(s);
                         } else {
                           sAdj[r * p0 + c - hw] += t[i] * SKIP_SCALE;
                         }
                       }
                     });
    __syncthreads();
    bf16* tmp = va;
    va = vb;
    vb = tmp;
  }
  mma_tile64<true>(va, lds, C.out_dims[0], wpack + C.w_off[0], C.out_dims[0], p0, stage,
                   [&](int r0, int c0, const float* t) {
                     for (int i = lane; i < 256; i += 32)
                       sAdj[(r0 + (i >> 4)) * p0 + c0 + (i & 15)] += t[i];
                   });
  __syncthreads();
}

// ------------------------------------------------------------------ forward

// ENC: out_f = sdf [n], out_b = geo [n, out_width], out_g = grad [n, 3].
// !ENC: out_b = y [n, out_width], out_g = adj [n, E.width] (out_f unused).
template <bool ENC>
__global__ void __launch_bounds__(NTHREADS)
adj_chain_fwd_kernel(const float* __restrict__ pos, const bf16* __restrict__ x, int n,
                     const bf16* __restrict__ wpack, const float* __restrict__ bpack, Chain C,
                     Enc E, int lds, int ldx0, int channel, float* __restrict__ out_f,
                     bf16* __restrict__ out_b, int out_width, float* __restrict__ out_g,
                     bf16* scratch) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = C.n_layers, H = C.hidden, p0 = C.p0;
  bf16* buf0 = reinterpret_cast<bf16*>(smem);
  bf16* buf1 = buf0 + TILE_M * lds;
  bf16* x0 = buf1 + TILE_M * lds;                                // [64, ldx0]
  float* sAdj = reinterpret_cast<float*>(x0 + TILE_M * ldx0);    // [64, p0]
  float* stage = sAdj + TILE_M * p0;
  bf16* zs = scratch + (long long)blockIdx.x * (L - 1) * TILE_M * H;  // (L-1) x [64, H]
  const int lane = threadIdx.x & 31;
  const int n_tiles = (n + TILE_M - 1) / TILE_M;
  const float* BL = bpack + C.b_off[L - 1];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = (long long)tile * TILE_M;
    front<ENC>(E, p0, pos, x, n, row0, buf0, lds, x0, ldx0);
    for (int i = threadIdx.x; i < TILE_M * p0; i += NTHREADS) sAdj[i] = 0.f;
    const bf16* h = run_hidden_layers(C, wpack, bpack, buf0, buf1, lds, x0, ldx0, zs, H, stage);
    // last layer: K4's sdf = column 0 in f32 and geo = columns 1 .. out_width in bf16;
    // K5's y = columns 0 .. out_width - 1 in bf16
    mma_tile64<false>(h, lds, C.in_dims[L - 1], wpack + C.w_off[L - 1], C.out_dims[L - 1],
                      C.out_dims[L - 1], stage, [&](int r0, int c0, const float* t) {
                        for (int i = lane; i < 256; i += 32) {
                          const int r = r0 + (i >> 4), c = c0 + (i & 15);
                          if (row0 + r >= n) continue;
                          const float z = t[i] + BL[c];
                          if (!ENC) {
                            if (c < out_width) out_b[(row0 + r) * out_width + c] = __float2bfloat16(z);
                          } else if (c == 0) {
                            out_f[row0 + r] = z;
                          } else if (c <= out_width) {
                            out_b[(row0 + r) * out_width + c - 1] = __float2bfloat16(z);
                          }
                        }
                      });
    __syncthreads();
    adjoint_sweep(C, channel, wpack, buf0, buf1, lds, zs, nullptr, sAdj, stage);
    if (ENC) {
      // d sdf / dx = J_enc^T adj
      if (threadIdx.x < TILE_M && row0 + threadIdx.x < n) {
        const int r = threadIdx.x;
        const float* p = pos + (row0 + r) * 3;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          out_g[(row0 + r) * 3 + k] = pe_jt(sAdj + r * p0, p, E.freqs, E.scale, k);
      }
    } else {
      for (int i = threadIdx.x; i < TILE_M * E.width; i += NTHREADS) {
        const int r = i / E.width, c = i % E.width;
        if (row0 + r < n) out_g[(row0 + r) * E.width + c] = sAdj[r * p0 + c];
      }
    }
    __syncthreads();
  }
}

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

// ------------------------------------------------------------------ entry points

// Checks the chain and fills C, E (width: the chain input's width) and the row strides.
static int setup(Chain& C, Enc& E, int& lds, int& ldx0, int n_layers, const int* in_dims,
                 const int* out_dims, int skip_mask, int hidden, int p0, int act, float quad_a,
                 int pe_freqs, const float* pe_scale, int width) {
  if (fill_chain(C, n_layers, in_dims, out_dims, skip_mask, hidden, p0, act, quad_a)) return -1;
  if (n_layers < 2 || (skip_mask & 1) || pe_freqs < 0 || pe_freqs > MAXPE) return -1;
  if (width < 1 || width > p0 || in_dims[0] != p0) return -1;
  int w = p0;
  for (int l = 0; l < n_layers; ++l) {
    const bool sk = (skip_mask >> l) & 1;
    if (l > 0 && in_dims[l] != hidden + (sk ? p0 : 0)) return -1;
    if (l < n_layers - 1 && out_dims[l] != hidden) return -1;
    w = w > in_dims[l] ? w : in_dims[l];
    w = w > out_dims[l] ? w : out_dims[l];
  }
  E.freqs = pe_freqs;
  for (int i = 0; i < pe_freqs; ++i) E.scale[i] = pe_scale[i];
  E.width = width;
  lds = w + PAD;
  ldx0 = p0 + PAD;
  return 0;
}

// Dynamic shared memory: two activation tiles, x0, and n_rows f32 [64, p0] rows
// (adj; in the backward also ga and gx) and the warps' staging tiles.
static size_t smem_bytes(int lds, int ldx0, int p0, int n_rows) {
  return 2 * (size_t)TILE_M * lds * sizeof(bf16) + (size_t)TILE_M * ldx0 * sizeof(bf16) +
         n_rows * (size_t)TILE_M * p0 * sizeof(float) + NWARPS * 256 * sizeof(float);
}

template <class Kernel, class... Args>
static int launch(Kernel kernel, size_t smem, int n, int max_ctas, void* stream, Args... args) {
  if (max_ctas < 1) return -1;
  if (smem > MAX_SMEM) return ERR_SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int grid;
  err = persistent_grid((const void*)kernel, smem, n, max_ctas, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// Scratch bf16 elements per CTA of the forwards: the z stack.
extern "C" long long mms_sdf_chain_slab(int n_layers, int hidden) {
  return (long long)(n_layers - 1) * TILE_M * hidden;
}

// K4's forward: sdf [n] f32, geo [n, geo_width] bf16, grad [n, 3] f32.
extern "C" int mms_sdf_chain_fwd(const void* pos, int n, const void* wpack, const void* bpack,
                                 int n_layers, const int* in_dims, const int* out_dims,
                                 int skip_mask, int hidden, int p0, int act, float quad_a,
                                 int pe_freqs, const float* pe_scale, void* sdf, void* geo,
                                 int geo_width, void* grad, void* scratch, int max_ctas,
                                 void* stream) {
  Chain C;
  Enc E;
  int lds, ldx0;
  if (pe_freqs < 1 || setup(C, E, lds, ldx0, n_layers, in_dims, out_dims, skip_mask, hidden, p0,
                            act, quad_a, pe_freqs, pe_scale, 3 + 6 * pe_freqs) ||
      geo_width >= out_dims[n_layers - 1])
    return -1;
  return launch(adj_chain_fwd_kernel<true>, smem_bytes(lds, ldx0, p0, 1), n, max_ctas, stream,
                (const float*)pos, (const bf16*)nullptr, n, (const bf16*)wpack,
                (const float*)bpack, C, E, lds, ldx0, 0, (float*)sdf, (bf16*)geo, geo_width,
                (float*)grad, (bf16*)scratch);
}

// K5's forward: x [n, d_in] bf16 in; y [n, d_out] bf16 and adj [n, d_in] f32 out.
extern "C" int mms_chain_adj_fwd(const void* x, int n, const void* wpack, const void* bpack,
                                 int n_layers, const int* in_dims, const int* out_dims,
                                 int skip_mask, int hidden, int p0, int act, float quad_a,
                                 int d_in, int channel, void* y, int d_out, void* adj,
                                 void* scratch, int max_ctas, void* stream) {
  Chain C;
  Enc E;
  int lds, ldx0;
  if (setup(C, E, lds, ldx0, n_layers, in_dims, out_dims, skip_mask, hidden, p0, act, quad_a, 0,
            nullptr, d_in) ||
      d_out > out_dims[n_layers - 1] || channel < 0 || channel >= d_out)
    return -1;
  return launch(adj_chain_fwd_kernel<false>, smem_bytes(lds, ldx0, p0, 1), n, max_ctas, stream,
                (const float*)nullptr, (const bf16*)x, n, (const bf16*)wpack, (const float*)bpack,
                C, E, lds, ldx0, channel, (float*)nullptr, (bf16*)y, d_out, (float*)adj,
                (bf16*)scratch);
}

// ------------------------------------------------------------- backward entry points
//
// G: the chain's layout (fused_mlp.py chain_layout with two stack tiles per row
// tile below the last layer); wfw, wbw, bpk: what mms_k1_pack wrote for it. The
// pass accumulates into gw (the last layer's column `channel` term) and gb, and
// leaves the stacks at the start of scratch for mms_k1_wgrad over (n + 63) / 64
// row tiles. count (or null) receives the number of gW atomics the pass issued.

static int adj_bwd_launch(const k1::Geom& G, const Enc& E, const k1::AdjIo& I, int n,
                          const void* wfw, const void* wbw, const void* bpk, void* gw, void* gb,
                          void* scratch, void* count, void* stream) {
  if (!k1::adj_ok(G, E, I.channel) || n < 1) return -1;
  k1::Launch P;
  const int st = k1::adj_plan(G, n, &P);
  if (st) return st;
  size_t s[6];
  k1::adj_scratch_sizes(G, (n + 63) / 64, P.grid * P.nwg, P.act_bytes, s);
  uint8_t* p = (uint8_t*)scratch;
  const k1::AdjScratch S{(bf16*)p, (bf16*)(p + s[0]), (uint32_t*)(p + s[0] + s[1]),
                         (uint32_t*)(p + s[0] + s[1] + s[2]),
                         (float*)(p + s[0] + s[1] + s[2] + s[3]),
                         s[5] ? (bf16*)(p + s[0] + s[1] + s[2] + s[3] + s[4]) : nullptr};
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
  if (pe_freqs < 1 || pe_freqs > MAXPE || geo_width >= G->dout_true[G->L - 1]) return -1;
  Enc E;
  E.freqs = pe_freqs;
  for (int i = 0; i < pe_freqs; ++i) E.scale[i] = pe_scale[i];
  E.width = 3 + 6 * pe_freqs;
  const k1::AdjIo I{(const float*)pos, nullptr, (const float*)gsdf, (const bf16*)ggeo,
                    (const float*)g3, (float*)d_pos, nullptr, geo_width, 0};
  return adj_bwd_launch(*G, E, I, n, wfw, wbw, bpk, gw, gb, scratch, count, stream);
}

// K5's backward pass: x [n, d_in] bf16, gy [n, d_out] bf16 and ga [n, d_in] f32 in;
// gx [n, d_in] bf16 out.
extern "C" int mms_chain_adj_bwd(const k1::Geom* G, const void* x, int n, int channel,
                                 const void* gy, const void* ga, const void* wfw, const void* wbw,
                                 const void* bpk, void* gx, void* gw, void* gb, void* scratch,
                                 void* count, void* stream) {
  Enc E;
  E.freqs = 0;
  E.width = G->d_in;
  const k1::AdjIo I{nullptr, (const bf16*)x, nullptr, (const bf16*)gy, (const float*)ga,
                    nullptr, (bf16*)gx, G->dout_true[G->L - 1], channel};
  return adj_bwd_launch(*G, E, I, n, wfw, wbw, bpk, gw, gb, scratch, count, stream);
}
