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
// encoding's frequency count (0 for K5) at run time, one kernel for both.
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

// ------------------------------------------------------------------ backward
//
// The backward (reverse over reverse, _bwd_adj_kernel :410-602) on Hopper: a
// per-tile pass on wgmma and the stacked gW product (chain_wgrad of
// fused_chain.cu). It shares K1's layout (k1.cuh): the weights arrive as the
// bf16 images of one k1_pack launch (forward images W^T for z = h W + b and m =
// qin W, backward images W for s = v W^T and gh = gz W^T), streamed through a
// ring that a producer warpgroup feeds with bulk copies, and a consumer
// warpgroup owns a 64-row tile whose activation images live in shared memory.
// Per tile, in the order the producer streams the images:
//  1. the primal recompute of the hidden layers (K1's, the bias seeding the
//     accumulators); stacks hin_l;
//  2. the adjoint sweep from v = e_channel: the last layer's s is column
//     `channel` of W (no product), then s = bf16(v) W_l^T down to layer 0; the
//     h part of s goes to a slab as bf16(s), its stack image bf16(bf16(s)
//     act'(z)) to the v stack and the next A image bf16(s act'(z)) in place;
//     the x0 parts (skip layers, layer 0) add up adj in an f32 slab;
//  3. the ga-forward chain from qin_0 = bf16(ga): m = qin_l W_l, e_l = bf16(m s_l
//     act''(z_l)) over s_l in its slab, q = m act'(z_l), ga re-injected at a skip
//     as bf16(ga / sqrt 2); stacks qin_l; the last layer's term, the column sums
//     of qin_{L-1} into gW_{L-1}[:, channel], summed per CTA in shared memory;
//  4. the reverse sweep (K1's) from the last layer's cotangent, gz_{l-1} = gh
//     act'(z) + e; stacks gz_l; gb as per-CTA column sums; K5's gx = bf16(gh_0 +
//     gx0), K4's d pos = J_enc^T (gh_0 + gx0) + g3 <adj, enc''> reduced over the
//     columns a thread holds and its row's three other lanes.
// gW_l = hin_l^T gz_l + qin_l^T v_l is then one product over 2N stacked rows
// (layer L-1: N rows), the stacks of layer l holding [hin | qin] and [gz | v].
// Where the residuals live: z and s (then e) bf16 and the f32 adj and gx0 rows
// in per-(CTA, warpgroup) device slabs in the accumulator's own order (each
// thread reads back what it wrote, 16 bytes of a warp's row at a time); the
// activation images in shared memory; the stacks in device scratch.
namespace k1 {

struct AdjScratch {
  bf16* hin;         // A stacks: per layer [hin tiles | qin tiles] (layer L-1: hin tiles)
  bf16* gz;          // B stacks: per layer [gz tiles | v tiles] (layer L-1: gz tiles)
  uint32_t* zslab;   // per slot: (L-1) x 64 x H bf16 z, accumulator order
  uint32_t* sslab;   // per slot: (L-1) x 64 x H bf16 s, then e
  float* fslab;      // per slot: adj, then gx0, each 64 x P0 f32 in accumulator order
};

// bytes of the stacks, the z slabs, the s slabs and the f32 slabs
static void adj_scratch_sizes(const Geom& G, int tiles, int slots, size_t* s) {
  stack_sizes(G, tiles, s);
  s[2] = align256((size_t)slots * (G.L - 1) * 64 * G.H * 2);
  s[3] = s[2];
  s[4] = align256((size_t)slots * 2 * 64 * G.P0 * 4);
}

// The chain input and the cotangents of one call (K4: pos, gsdf, ggeo, g3; K5: x,
// gy, ga) and its outputs (K4: d_pos; K5: gx).
struct AdjIo {
  const float* pos;   // K4 [n, 3]
  const bf16* x;      // K5 [n, d_in]
  const float* gsdf;  // K4 [n]
  const bf16* gy;     // [n, gy_width]: K4's ggeo, K5's gy
  const float* g_in;  // K4's g3 [n, 3], K5's ga [n, d_in]
  float* d_pos;       // K4 [n, 3]
  bf16* gx;           // K5 [n, d_in]
  int gy_width, channel;
};

// bf16(W_{L-1}[i, channel]) out of the last layer's backward images
__device__ __forceinline__ float last_column(const Geom& G, const bf16* wbw, int i, int c) {
  const int l = G.L - 1, depth = gcols(G, l);
  long long base = G.bw_off[l];
  for (int p = 0; p < bwd_n_pieces(G, l); ++p) {
    int off, np;
    bool x0part;
    bwd_piece(G, l, p, off, np, x0part);
    if (i >= off && i < off + np)
      return bf(wbw[base + (long long)(c >> 6) * np * 64 + img(i - off, c & 63)]);
    base += (long long)np * depth;
  }
  return 0.f;
}

// The chain input x0 (K4: the encoding of pos; K5: the rows of x) rounded to bf16
// into activation columns [c0, c0 + P0), zero past the input's width and past n.
__device__ __forceinline__ void adj_front(const Geom& G, const mms::Enc& E, const AdjIo& I,
                                          bf16* act, int c0, long long row0, int n) {
  if (!E.freqs) {
    load_rows(act, c0, G.P0, I.x, 1, E.width, row0, n);
    return;
  }
  for (int i = threadIdx.x & 127; i < 64 * G.P0; i += 128) {
    const int r = i / G.P0, c = i % G.P0;
    const long long row = row0 + r;
    const float v =
        c < E.width && row < n ? mms::pe_col(I.pos + row * 3, E.freqs, E.scale, c) : 0.f;
    act[act_el(c0 + c, r)] = __float2bfloat16(v);
  }
}

// bf16(ga * scale) into activation columns [c0, c0 + P0): K4's ga = sum_k g3_k
// bf16(t0_k) (:479), K5's the f32 input (:483).
__device__ __forceinline__ void load_ga(const Geom& G, const mms::Enc& E, const AdjIo& I,
                                        bf16* act, int c0, long long row0, int n, float scale) {
  const int F = E.freqs;
  if (!F && scale == 1.f) {  // K5's rows, read as 16-byte vectors
    load_rows(act, c0, G.P0, I.g_in, 0, E.width, row0, n);
    return;
  }
  for (int i = threadIdx.x & 127; i < 64 * G.P0; i += 128) {
    const int r = i / G.P0, c = i % G.P0;
    const long long row = row0 + r;
    float v = 0.f;
    if (c < E.width && row < n) {
      if (!F) {
        v = I.g_in[row * E.width + c];
      } else if (c < 3) {
        v = I.g_in[row * 3 + c];
      } else {
        const int d = (c - 3) % (3 * F) / F;
        v = I.g_in[row * 3 + d] * mms::pe_tangent(I.pos + row * 3, F, E.scale, c);
      }
    }
    act[act_el(c0 + c, r)] = __float2bfloat16(v * scale);
  }
}

// The last layer's cotangent rounded to bf16 into columns [0, gcols): K4 [gsdf,
// ggeo, 0], K5 [gy, 0]; zero past n.
__device__ __forceinline__ void load_last_cotangent(const Geom& G, const AdjIo& I, bf16* act,
                                                    long long row0, int n) {
  const int gl = gcols(G, G.L - 1);
  if (!I.gsdf) {
    load_rows(act, 0, gl, I.gy, 1, I.gy_width, row0, n);
    return;
  }
  for (int i = threadIdx.x & 127; i < 64 * gl; i += 128) {
    const int r = i / gl, c = i % gl;
    const long long row = row0 + r;
    bf16 v = __float2bfloat16(0.f);
    if (row < n) {
      if (c == 0)
        v = __float2bfloat16(I.gsdf[row]);
      else if (c - 1 < I.gy_width)
        v = I.gy[row * I.gy_width + c - 1];
    }
    act[act_el(c, r)] = v;
  }
}

// The h part s (f32, skip-scaled) of an adjoint product over the hidden layer l - 1:
// bf16(s) to the s slab; the v stack image bf16(bf16(s) act'(z)) stored; then the
// next adjoint product's A image bf16(s act'(z)) in place.
template <int N>
__device__ __forceinline__ void adjoint_h(const float (&acc)[N / 2], bf16* act, uint32_t* zl,
                                          uint32_t* sl, int act_kind, float qa, const Stacker& st,
                                          bf16* vdst, int wg) {
  const int t = threadIdx.x & 127, r0 = acc_row(), cq = acc_col();
  st.drain(wg);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int w = (2 * j + e) * 128 + t;
      const float2 z = unpack2(zl[w]);
      const uint32_t sb = pack2(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
      sl[w] = sb;
      const float2 s = unpack2(sb);
      *reinterpret_cast<uint32_t*>(act + act_el(8 * j + cq, r0 + 8 * e)) =
          pack2(s.x * act_df(act_kind, z.x, qa), s.y * act_df(act_kind, z.y, qa));
    }
  }
  fence_async_smem();
  wg_sync(1 + wg);
  st.store(vdst, act, N);
  st.drain(wg);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float2 z = unpack2(zl[(2 * j + e) * 128 + t]);
      *reinterpret_cast<uint32_t*>(act + act_el(8 * j + cq, r0 + 8 * e)) =
          pack2(acc[4 * j + 2 * e] * act_df(act_kind, z.x, qa),
                acc[4 * j + 2 * e + 1] * act_df(act_kind, z.y, qa));
    }
  }
  fence_async_smem();
  wg_sync(1 + wg);
}

__global__ void __launch_bounds__(NTHREADS, 1)
adj_bwd_pass_kernel(const Geom G, const mms::Enc E, const AdjIo I, int n,
                    const bf16* __restrict__ wfw, const bf16* __restrict__ wbw,
                    const float* __restrict__ bpk, float* __restrict__ gw, float* __restrict__ gb,
                    AdjScratch S, int nwg, int stages, int sb, int act_bytes,
                    unsigned long long* count) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* csum = reinterpret_cast<float*>(smem + nwg * act_bytes + stages * sb);
  const int L = G.L, H = G.H, P0 = G.P0;
  const bool enc = E.freqs > 0;  // K4 (the encoding in front) or K5
  const int x0c = x0_col(G);
  const int gb_total = G.gb_off[L - 1] + G.dout_true[L - 1];
  const int dlast = G.din_true[L - 1];
  float* csw = csum + ((gb_total + 3) & ~3);  // column sums of qin_{L-1}
  // bf16(W_{L-1}[:, channel]) over the layer's padded input columns: the adjoint's s there
  float* wc = csw + ((dlast + 3) & ~3);
  uint64_t* bars = reinterpret_cast<uint64_t*>(wc + G.din_pad[L - 1]);
  Ring R{smem + nwg * act_bytes, bars, bars + stages, sb, stages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&R.full[s], 1);
      mbar_init(&R.empty[s], nwg);
    }
    fence_mbar_init();
  }
  for (int i = threadIdx.x; i < gb_total; i += blockDim.x) csum[i] = 0.f;
  for (int i = threadIdx.x; i < dlast; i += blockDim.x) csw[i] = 0.f;
  for (int i = threadIdx.x; i < G.din_pad[L - 1]; i += blockDim.x)
    wc[i] = last_column(G, wbw, i, I.channel);
  __syncthreads();
  const int tiles = (n + 63) / 64, groups = (tiles + nwg - 1) / nwg;
  const int warp = threadIdx.x >> 5;
  if (warp >= nwg * 4) {  // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == nwg * 128) {
      for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
        stream_hidden_fwd(R, G, wfw);  // primal recompute
        stream_bwd(R, G, wbw, L - 2);  // adjoint sweep
        stream_hidden_fwd(R, G, wfw);  // ga-forward m
        stream_bwd(R, G, wbw, L - 1);  // reverse sweep
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp >> 2, t = threadIdx.x & 127, lane = threadIdx.x & 31;
  bf16* act = reinterpret_cast<bf16*>(smem + wg * act_bytes);
  {
    uint4* p = reinterpret_cast<uint4*>(act);
    for (int i = t; i < act_bytes / 16; i += 128) p[i] = make_uint4(0, 0, 0, 0);
  }
  wg_sync(1 + wg);
  const int slot = blockIdx.x * nwg + wg;
  const size_t zwords = (size_t)(H / 4) * 128;  // one layer's slab words
  uint32_t* zs = S.zslab + (size_t)slot * (L - 1) * zwords;
  uint32_t* ss = S.sslab + (size_t)slot * (L - 1) * zwords;
  float* adj = S.fslab + (size_t)slot * P0 * 128;
  float* gx0 = adj + (size_t)(P0 / 2) * 128;
  const int top_skip = G.skip_mask ? 31 - __clz(G.skip_mask) : -1;
  const int r0 = acc_row(), cq = acc_col();
  const float qa = G.quad_a;
  const int act_kind = G.act;
  const bool own_hin = act_kind == ACT_SOFTPLUS_QUAD;
  unsigned issued = 0;  // atomics into gw
  // a hidden layer's z or s slab into L2 while the products that precede its epilogue run
  auto prefetch = [&](const uint32_t* slab) {
    if (t == 0) bulk_prefetch_l2(slab, (uint32_t)zwords * 4);
  };
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int tile = grp * nwg + wg;
    const long long row0 = (long long)tile * 64;
    const Stacker st{tile < tiles};
    // stack tiles: [first | second] per layer, tiles each
    auto a_at = [&](int l, int half) {
      return S.hin + (size_t)tiles * 64 * G.hs_w[l] +
             (size_t)(half * tiles + tile) * 64 * G.din_pad[l];
    };
    auto b_at = [&](int l, int half) {
      return S.gz + (size_t)tiles * 64 * G.gs_w[l] +
             (size_t)(half * tiles + tile) * 64 * gcols(G, l);
    };
    // ---- 1. primal recompute (K1's), stacks hin_l
    adj_front(G, E, I, act, x0c, row0, n);
    fence_async_smem();
    wg_sync(1 + wg);
    st.store(a_at(0, 0), act + (x0c >> 6) * 4096, P0);
    for (int l = 0; l < L - 1; ++l) {
      const bf16* a = act + (l == 0 ? (x0c >> 6) * 4096 : 0);
      if (l > 0 && !own_hin) st.store(a_at(l, 0), act, G.din_pad[l]);
      const bool next_skip = (G.skip_mask >> (l + 1)) & 1;
      const bool need_h = !own_hin || l + 1 < L - 1;
      uint32_t* zl = zs + l * zwords;
      with_n64(H, [&](auto NC) {
        constexpr int N = decltype(NC)::value;
        float acc[N / 2];
        mma_piece<N>(acc, a, G.din_pad[l] >> 6, R, wg, bpk + G.b_off[l]);
        st.drain(wg);
        if (l == 0 && G.skip_mask) scale_region(act, H, P0);
        if (own_hin) {
          write_hidden<N, true>(acc, act, next_skip, act_kind, qa, zl);
          fence_async_smem();
          wg_sync(1 + wg);
          st.store(a_at(l + 1, 0), act, G.din_pad[l + 1]);
          if (need_h) st.drain(wg);
        }
        if (need_h) {
          write_hidden<N, false>(acc, act, next_skip, act_kind, qa, own_hin ? nullptr : zl);
          fence_async_smem();
          wg_sync(1 + wg);
        }
      });
    }
    if (!own_hin) st.store(a_at(L - 1, 0), act, G.din_pad[L - 1]);
    // ---- 2. adjoint sweep; the last layer's s is column `channel` of W_{L-1}
    prefetch(zs + (L - 2) * zwords);
    {
      const bool skip = (G.skip_mask >> (L - 1)) & 1;
      const float sc = skip ? SKIP_SCALE : 1.f;
      with_n64(H, [&](auto NC) {
        constexpr int N = decltype(NC)::value;
        float acc[N / 2];
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
#pragma unroll
          for (int q = 0; q < 2; ++q) acc[4 * j + q] = acc[4 * j + 2 + q] = sc * wc[8 * j + cq + q];
        }
        adjoint_h<N>(acc, act, zs + (L - 2) * zwords, ss + (L - 2) * zwords, act_kind, qa, st,
                     b_at(L - 2, 1), wg);
      });
      if (skip) {
        for (int p = 0; p < n_pieces(P0); ++p) {
          int off, np;
          piece(P0, p, off, np);
          with_n64(np, [&](auto NC) {
            constexpr int N = decltype(NC)::value;
            float acc[N / 2];
#pragma unroll
            for (int j = 0; j < N / 8; ++j) {
#pragma unroll
              for (int q = 0; q < 2; ++q)
                acc[4 * j + q] = acc[4 * j + 2 + q] = wc[H + off + 8 * j + cq + q];
            }
            slab_accumulate<N>(adj, off, acc, SKIP_SCALE, true);
          });
        }
      }
    }
    for (int l = L - 2; l >= 0; --l) {
      const int kcs = gcols(G, l) >> 6, npc = bwd_n_pieces(G, l);
      const bool skip = (G.skip_mask >> l) & 1;
      if (l > 0) prefetch(zs + (l - 1) * zwords);
      for (int p = 0; p < npc; ++p) {
        int off, np;
        bool x0part;
        bwd_piece(G, l, p, off, np, x0part);
        with_n64(np, [&](auto NC) {
          constexpr int N = decltype(NC)::value;
          float acc[N / 2];
          mma_piece<N>(acc, act, kcs, R, wg, nullptr);
          if (x0part) {  // adj += the x0 part (times 1/sqrt 2 at a skip layer)
            const int xoff = l == 0 ? off : off - H;
            const bool first = l == 0 ? top_skip < 0 : l == top_skip;
            slab_accumulate<N>(adj, xoff, acc, l == 0 ? 1.f : SKIP_SCALE, first);
          } else {
            if (skip) {
#pragma unroll
              for (int i = 0; i < N / 2; ++i) acc[i] *= SKIP_SCALE;
            }
            adjoint_h<N>(acc, act, zs + (l - 1) * zwords, ss + (l - 1) * zwords, act_kind, qa, st,
                         b_at(l - 1, 1), wg);
          }
        });
      }
    }
    // ---- 3. the ga-forward chain; stacks qin_l
    load_ga(G, E, I, act, x0c, row0, n, 1.f);
    fence_async_smem();
    wg_sync(1 + wg);
    for (int l = 0; l < L - 1; ++l) {
      const bf16* a = act + (l == 0 ? (x0c >> 6) * 4096 : 0);
      st.store(a_at(l, 1), a, G.din_pad[l]);
      const bool next_skip = (G.skip_mask >> (l + 1)) & 1;
      uint32_t* zl = zs + l * zwords;
      uint32_t* sl = ss + l * zwords;
      prefetch(zl);
      prefetch(sl);
      with_n64(H, [&](auto NC) {
        constexpr int N = decltype(NC)::value;
        float acc[N / 2];
        mma_piece<N>(acc, a, G.din_pad[l] >> 6, R, wg, nullptr);
        st.drain(wg);
        if (l == 0 && G.skip_mask) load_ga(G, E, I, act, H, row0, n, SKIP_SCALE);
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int w = (2 * j + e) * 128 + t;
            const float2 z = unpack2(zl[w]), s = unpack2(sl[w]);
            const float m0 = acc[4 * j + 2 * e], m1 = acc[4 * j + 2 * e + 1];
            sl[w] = pack2(m0 * s.x * act_ddf(act_kind, z.x, qa),
                          m1 * s.y * act_ddf(act_kind, z.y, qa));
            float q0 = m0 * act_df(act_kind, z.x, qa), q1 = m1 * act_df(act_kind, z.y, qa);
            if (next_skip) {
              q0 *= SKIP_SCALE;
              q1 *= SKIP_SCALE;
            }
            *reinterpret_cast<uint32_t*>(act + act_el(8 * j + cq, r0 + 8 * e)) = pack2(q0, q1);
          }
        }
        fence_async_smem();
        wg_sync(1 + wg);
      });
    }
    // the last layer's v is e_channel: gW_{L-1}[:, channel] += column sums of qin_{L-1}
    for (int c = t; c < dlast; c += 128) {
      float s = 0.f;
      for (int r = 0; r < 64; ++r) s += bf(act[act_el(c, r)]);
      atomicAdd(&csw[c], s);
    }
    wg_sync(1 + wg);
    // ---- 4. the reverse sweep from the last layer's cotangent; stacks gz_l
    const int dl = G.dout_true[L - 1], gl = gcols(G, L - 1);
    load_last_cotangent(G, I, act, row0, n);
    fence_async_smem();
    wg_sync(1 + wg);
    st.store(b_at(L - 1, 0), act, gl);
    for (int c = t; c < dl; c += 128) {  // gb_{L-1}: the f32 cotangent (K4's gsdf unrounded)
      float s = 0.f;
      if (enc && c == 0) {
        for (int r = 0; r < 64 && row0 + r < n; ++r) s += I.gsdf[row0 + r];
      } else {
        for (int r = 0; r < 64; ++r) s += bf(act[act_el(c, r)]);
      }
      atomicAdd(&csum[G.gb_off[L - 1] + c], s);
    }
    float dp[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};  // K4's d pos terms of the two rows
    for (int l = L - 1; l >= 0; --l) {
      const int kcs = gcols(G, l) >> 6, npc = bwd_n_pieces(G, l);
      const bool skip = (G.skip_mask >> l) & 1;
      if (l > 0) {
        prefetch(zs + (l - 1) * zwords);
        prefetch(ss + (l - 1) * zwords);
      }
      for (int p = 0; p < npc; ++p) {
        int off, np;
        bool x0part;
        bwd_piece(G, l, p, off, np, x0part);
        with_n64(np, [&](auto NC) {
          constexpr int N = decltype(NC)::value;
          float acc[N / 2];
          mma_piece<N>(acc, act, kcs, R, wg, nullptr);
          if (l == 0) {  // ghin = gh_0 + gx0
            const float* g0 = gx0 + (off >> 1) * 128 + t;
            const float* a0 = adj + (off >> 1) * 128 + t;
            const bool has_gx0 = top_skip >= 0;
#pragma unroll
            for (int j = 0; j < N / 8; ++j) {
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int i = 4 * j + k, c = off + 8 * j + cq + (k & 1), rr = k >> 1;
                const float gh = acc[i] + (has_gx0 ? g0[i * 128] : 0.f);
                const long long row = row0 + r0 + 8 * rr;
                if (row >= n || c >= E.width) continue;
                if (!enc) {
                  I.gx[row * E.width + c] = __float2bfloat16(gh);
                  continue;
                }
                const float* pp = I.pos + row * 3;
                if (c < 3) {
                  add3(dp[rr], c, gh);
                  continue;
                }
                const int F = E.freqs;
                const bool is_sin = c < 3 + 3 * F;
                const int kk = (is_sin ? c - 3 : c - 3 - 3 * F);
                const int d = kk / F;
                const float s = E.scale[kk % F], arg = pp[d] * s;
                const float sn = sinf(arg), cs = cosf(arg);
                const float g3 = I.g_in[row * 3 + d], av = a0[i * 128];
                add3(dp[rr], d, is_sin ? gh * (cs * s) + g3 * av * (-sn * s * s)
                                       : gh * (-sn * s) + g3 * av * (-cs * s * s));
              }
            }
          } else if (x0part) {  // a skip layer's x0 columns: gx0 += gh / sqrt 2
            slab_accumulate<N>(gx0, off - H, acc, SKIP_SCALE, l == top_skip);
          } else {  // gz_{l-1} = bf16(gh act'(z_{l-1}) + e_{l-1}), in place, and its column sums
            const uint32_t* zl = zs + (l - 1) * zwords;
            const uint32_t* el = ss + (l - 1) * zwords;
            float* cs = csum + G.gb_off[l - 1];
            st.drain(wg);
#pragma unroll
            for (int j = 0; j < N / 8; ++j) {
              float s0 = 0.f, s1 = 0.f;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int w = (2 * j + e) * 128 + t;
                const float2 z = unpack2(zl[w]), ev = unpack2(el[w]);
                float g0 = acc[4 * j + 2 * e], g1 = acc[4 * j + 2 * e + 1];
                if (skip) {
                  g0 *= SKIP_SCALE;
                  g1 *= SKIP_SCALE;
                }
                g0 = g0 * act_df(act_kind, z.x, qa) + ev.x;
                g1 = g1 * act_df(act_kind, z.y, qa) + ev.y;
                s0 += g0;
                s1 += g1;
                *reinterpret_cast<uint32_t*>(act + act_el(8 * j + cq, r0 + 8 * e)) = pack2(g0, g1);
              }
#pragma unroll
              for (int m = 4; m < 32; m <<= 1) {
                s0 += __shfl_xor_sync(0xffffffffu, s0, m);
                s1 += __shfl_xor_sync(0xffffffffu, s1, m);
              }
              if (lane < 4) {
                atomicAdd(&cs[8 * j + cq], s0);
                atomicAdd(&cs[8 * j + cq + 1], s1);
              }
            }
          }
        });
      }
      fence_async_smem();
      wg_sync(1 + wg);
      if (l > 0) st.store(b_at(l - 1, 0), act, H);
    }
    if (enc) {  // d pos: the row's four lanes hold its columns
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float v = dp[rr][k];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          dp[rr][k] = v;
        }
        const long long row = row0 + r0 + 8 * rr;
        if ((lane & 3) == 0 && row < n) {
#pragma unroll
          for (int k = 0; k < 3; ++k) I.d_pos[row * 3 + k] = dp[rr][k];
        }
      }
    }
    st.drain(wg);  // before the next tile's rows land
  }
  if ((threadIdx.x & 127) == 0) bulk_wait_all();
  bar_sync(SUM_BAR, nwg * 128);
  for (int i = threadIdx.x; i < gb_total; i += nwg * 128)
    if (csum[i] != 0.f) atomicAdd(&gb[i], csum[i]);
  const int dout = G.dout_true[L - 1];
  for (int i = threadIdx.x; i < dlast; i += nwg * 128) {
    if (csw[i] != 0.f) {
      atomicAdd(&gw[G.gw_off[L - 1] + (long long)i * dout + I.channel], csw[i]);
      ++issued;
    }
  }
  if (count && issued) atomicAdd(count, (unsigned long long)issued);
}

// Launch plan and scratch of the pass over n rows: the column sums of gb and of
// qin_{L-1} and the last layer's weight column in shared memory beside K1's
// backward layout.
static int adj_plan(const Geom& G, int n, Launch* P) {
  const void* kernel = (const void*)adj_bwd_pass_kernel;
  const int tiles = (n + 63) / 64;
  const size_t extra = ((size_t)((G.din_true[G.L - 1] + 3) & ~3) + G.din_pad[G.L - 1]) * 4;
  if (plan_chain(G, tiles, true, extra, P)) return ERR_SMEM;
  if (allow_smem(0, kernel) != cudaSuccess) return -1;
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
  size_t s[5];
  k1::adj_scratch_sizes(G, (n + 63) / 64, P.grid * P.nwg, s);
  uint8_t* p = (uint8_t*)scratch;
  const k1::AdjScratch S{(bf16*)p, (bf16*)(p + s[0]), (uint32_t*)(p + s[0] + s[1]),
                         (uint32_t*)(p + s[0] + s[1] + s[2]),
                         (float*)(p + s[0] + s[1] + s[2] + s[3])};
  k1::adj_bwd_pass_kernel<<<P.grid, P.threads, P.smem, (cudaStream_t)stream>>>(
      G, E, I, n, (const bf16*)wfw, (const bf16*)wbw, (const float*)bpk, (float*)gw, (float*)gb,
      S, P.nwg, P.stages, P.sb, P.act_bytes, (unsigned long long*)count);
  return (int)cudaGetLastError();
}

// Bytes of the backward's device scratch (stacks and per-CTA slabs) for n rows.
extern "C" long long mms_adj_bwd_bytes(const k1::Geom* G, int n) {
  if (!k1::geom_ok(*G) || n < 1) return -1;
  k1::Launch P;
  const int st = k1::adj_plan(*G, n, &P);
  if (st) return st;
  size_t s[5];
  k1::adj_scratch_sizes(*G, (n + 63) / 64, P.grid * P.nwg, s);
  return (long long)(s[0] + s[1] + s[2] + s[3] + s[4]);
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
