// The per-tile pass of the adjoint backward (K4 with the encoding, K5 without) on
// K1's building blocks, shared by sdf_chain.cu (width classes WC_NARROW and WC_WIDE,
// and the entry points) and sdf_chain_dev.cu (WC_DEV, compiled beside the rest of the
// library, so that the two compile in parallel).
#pragma once

#include "enc.cuh"
#include "k1.cuh"

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
  bf16* act;         // WC_DEV: per slot the activation images
};

// bytes of the stacks, the z slabs, the s slabs, the f32 slabs and (WC_DEV) the
// activation slabs of act_bytes each
inline void adj_scratch_sizes(const Geom& G, int tiles, int slots, int act_bytes, size_t* s) {
  stack_sizes(G, tiles, s);
  s[2] = align256((size_t)slots * (G.L - 1) * 64 * G.H * 2);
  s[3] = s[2];
  s[4] = align256((size_t)slots * 2 * 64 * G.P0 * 4);
  s[5] = width_class(G) == WC_DEV ? align256((size_t)slots * act_bytes) : 0;
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
template <int N, int WC>
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
  fence_act<WC>();
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
  fence_act<WC>();
  wg_sync(1 + wg);
}

template <int WC>
__global__ void __launch_bounds__(NTHREADS, 1)
adj_bwd_pass_kernel(const Geom G, const mms::Enc E, const AdjIo I, int n,
                    const bf16* __restrict__ wfw, const bf16* __restrict__ wbw,
                    const float* __restrict__ bpk, float* __restrict__ gw, float* __restrict__ gb,
                    AdjScratch S, int nwg, int stages, int sb, int act_bytes,
                    unsigned long long* count) {
  constexpr bool dev = WC == WC_DEV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* csum = reinterpret_cast<float*>(smem + nwg * wg_smem<WC>(act_bytes) + stages * sb);
  const int L = G.L, H = G.H, P0 = G.P0;
  const bool enc = E.freqs > 0;  // K4 (the encoding in front) or K5
  const int x0c = x0_col(G);
  const int gb_total = G.gb_off[L - 1] + G.dout_true[L - 1];
  const int dlast = G.din_true[L - 1];
  float* csw = csum + ((gb_total + 3) & ~3);  // column sums of qin_{L-1}
  // bf16(W_{L-1}[:, channel]) over the layer's padded input columns: the adjoint's s there
  float* wc = csw + ((dlast + 3) & ~3);
  uint64_t* bars = reinterpret_cast<uint64_t*>(wc + G.din_pad[L - 1]);
  Ring R{smem + nwg * wg_smem<WC>(act_bytes), bars, bars + stages, sb, stages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&R.full[s], 1);
      mbar_init(&R.empty[s], nwg);
    }
    if (dev) init_astage(bars, stages);
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
  const int slot = blockIdx.x * nwg + wg, sidec = side_cols(G);
  bf16* act = act_images<WC>(smem, wg, act_bytes, S.act, slot);
  AStage as = astage_of(smem, wg, bars, stages);
  AStage* asp = dev ? &as : nullptr;
  {
    uint4* p = reinterpret_cast<uint4*>(act);
    for (int i = t; i < act_bytes / 16; i += 128) p[i] = make_uint4(0, 0, 0, 0);
  }
  wg_sync(1 + wg);
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
    const Stacker st{tile < tiles, dev};
    const int nph = hidden_pieces<WC>(H);  // pieces of a hidden-width product
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
    fence_act<WC>();
    wg_sync(1 + wg);
    st.store(a_at(0, 0), act + (x0c >> 6) * 4096, P0);
    for (int l = 0; l < L - 1; ++l) {
      const bf16* a = act + (l == 0 ? (x0c >> 6) * 4096 : 0);
      if (l > 0 && !own_hin) st.store(a_at(l, 0), act, G.din_pad[l]);
      const bool next_skip = (G.skip_mask >> (l + 1)) & 1;
      const bool need_h = !own_hin || l + 1 < L - 1;
      for (int p = 0; p < nph; ++p) {
        int off, np;
        hidden_piece<WC>(H, p, off, np);
        bf16* dst = piece_dst<WC>(act, act_bytes, sidec, p, nph, off);
        uint32_t* zl = zs + l * zwords + (off >> 2) * 128;
        with_n64(np, [&](auto NC) {
          constexpr int N = decltype(NC)::value;
          float acc[N / 2];
          mma_piece<N>(acc, a, G.din_pad[l] >> 6, R, wg, bpk + G.b_off[l] + off, 3, asp);
          st.drain(wg);
          if (l == 0 && G.skip_mask && p + 1 == nph) scale_region(act, H, P0);
          if (own_hin) {
            write_hidden<N, true>(acc, dst, next_skip, act_kind, qa, zl);
            fence_act<WC>();
            wg_sync(1 + wg);
            st.store(a_at(l + 1, 0) + off * 64, dst, p + 1 < nph ? N : G.din_pad[l + 1] - off);
            if (need_h) st.drain(wg);
          }
          if (need_h) {
            write_hidden<N, false>(acc, dst, next_skip, act_kind, qa, own_hin ? nullptr : zl);
            if (p + 1 == nph) {
              side_back<WC>(act, act_bytes, sidec, wg);
              fence_act<WC>();
              wg_sync(1 + wg);
            }
          }
        });
      }
    }
    if (!own_hin) st.store(a_at(L - 1, 0), act, G.din_pad[L - 1]);
    // ---- 2. adjoint sweep; the last layer's s is column `channel` of W_{L-1}
    prefetch(zs + (L - 2) * zwords);
    {
      const bool skip = (G.skip_mask >> (L - 1)) & 1;
      const float sc = skip ? SKIP_SCALE : 1.f;
      for (int p = 0; p < nph; ++p) {  // no product reads act here: every piece in place
        int off, np;
        hidden_piece<WC>(H, p, off, np);
        with_n64(np, [&](auto NC) {
          constexpr int N = decltype(NC)::value;
          float acc[N / 2];
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
#pragma unroll
            for (int q = 0; q < 2; ++q)
              acc[4 * j + q] = acc[4 * j + 2 + q] = sc * wc[off + 8 * j + cq + q];
          }
          const size_t w0 = (L - 2) * zwords + (off >> 2) * 128;
          adjoint_h<N, WC>(acc, act + (off >> 6) * 4096, zs + w0, ss + w0, act_kind, qa, st,
                       b_at(L - 2, 1) + off * 64, wg);
        });
      }
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
          mma_piece<N>(acc, act, kcs, R, wg, nullptr, 3, asp);
          if (x0part) {  // adj += the x0 part (times 1/sqrt 2 at a skip layer)
            const int xoff = l == 0 ? off : off - H;
            const bool first = l == 0 ? top_skip < 0 : l == top_skip;
            slab_accumulate<N>(adj, xoff, acc, l == 0 ? 1.f : SKIP_SCALE, first);
          } else {
            if (skip) {
#pragma unroll
              for (int i = 0; i < N / 2; ++i) acc[i] *= SKIP_SCALE;
            }
            const int hoff = WC ? off : 0;  // the h part's one piece starts at 0
            const size_t w0 = (l - 1) * zwords + (hoff >> 2) * 128;
            adjoint_h<N, WC>(acc, piece_dst<WC>(act, act_bytes, sidec, p, npc, hoff), zs + w0,
                             ss + w0, act_kind, qa, st, b_at(l - 1, 1) + hoff * 64, wg);
          }
        });
      }
      if (WC && l > 0) {
        side_back<WC>(act, act_bytes, sidec, wg);
        fence_act<WC>();
        wg_sync(1 + wg);
      }
    }
    // ---- 3. the ga-forward chain; stacks qin_l
    load_ga(G, E, I, act, x0c, row0, n, 1.f);
    fence_act<WC>();
    wg_sync(1 + wg);
    for (int l = 0; l < L - 1; ++l) {
      const bf16* a = act + (l == 0 ? (x0c >> 6) * 4096 : 0);
      st.store(a_at(l, 1), a, G.din_pad[l]);
      const bool next_skip = (G.skip_mask >> (l + 1)) & 1;
      prefetch(zs + l * zwords);
      prefetch(ss + l * zwords);
      for (int p = 0; p < nph; ++p) {
        int off, np;
        hidden_piece<WC>(H, p, off, np);
        bf16* dst = piece_dst<WC>(act, act_bytes, sidec, p, nph, off);
        uint32_t* zl = zs + l * zwords + (off >> 2) * 128;
        uint32_t* sl = ss + l * zwords + (off >> 2) * 128;
        with_n64(np, [&](auto NC) {
          constexpr int N = decltype(NC)::value;
          float acc[N / 2];
          mma_piece<N>(acc, a, G.din_pad[l] >> 6, R, wg, nullptr, 3, asp);
          st.drain(wg);
          // the x0 part again, scaled, once layer 0's last product read x0
          if (l == 0 && G.skip_mask && p + 1 == nph)
            load_ga(G, E, I, act, H, row0, n, SKIP_SCALE);
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
              *reinterpret_cast<uint32_t*>(dst + act_el(8 * j + cq, r0 + 8 * e)) = pack2(q0, q1);
            }
          }
        });
      }
      side_back<WC>(act, act_bytes, sidec, wg);
      fence_act<WC>();
      wg_sync(1 + wg);
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
    fence_act<WC>();
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
          mma_piece<N>(acc, act, kcs, R, wg, nullptr, 3, asp);
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
          } else {  // gz_{l-1} = bf16(gh act'(z_{l-1}) + e_{l-1}) (the first of two pieces to
                    // the side images), and its column sums
            const int hoff = WC ? off : 0;  // the h part's one piece starts at 0
            const uint32_t* zl = zs + (l - 1) * zwords + (hoff >> 2) * 128;
            const uint32_t* el = ss + (l - 1) * zwords + (hoff >> 2) * 128;
            float* cs = csum + G.gb_off[l - 1] + hoff;
            bf16* dst = piece_dst<WC>(act, act_bytes, sidec, p, npc, hoff);
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
                *reinterpret_cast<uint32_t*>(dst + act_el(8 * j + cq, r0 + 8 * e)) = pack2(g0, g1);
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
      if (l > 0) side_back<WC>(act, act_bytes, sidec, wg);
      fence_act<WC>();
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

// The pass of width class WC on launch plan P; count (or null) receives the gW
// atomics it issues.
template <int WC>
int adj_pass_launch(const Geom& G, const mms::Enc& E, const AdjIo& I, int n, const void* wfw,
                    const void* wbw, const void* bpk, void* gw, void* gb, const AdjScratch& S,
                    const Launch& P, void* count, cudaStream_t stream) {
  adj_bwd_pass_kernel<WC><<<P.grid, P.threads, P.smem, stream>>>(
      G, E, I, n, (const bf16*)wfw, (const bf16*)wbw, (const float*)bpk, (float*)gw, (float*)gb,
      S, P.nwg, P.stages, P.sb, P.act_bytes, (unsigned long long*)count);
  return (int)cudaGetLastError();
}

template <int WC>
const void* adj_pass_kernel() {
  return (const void*)adj_bwd_pass_kernel<WC>;
}

// WC_DEV's, in sdf_chain_dev.cu
int adj_pass_launch_dev(const Geom& G, const mms::Enc& E, const AdjIo& I, int n, const void* wfw,
                        const void* wbw, const void* bpk, void* gw, void* gb,
                        const AdjScratch& S, const Launch& P, void* count, cudaStream_t stream);
const void* adj_pass_kernel_dev();

}  // namespace k1
