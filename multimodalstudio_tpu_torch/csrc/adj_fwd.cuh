// The adjoint forward on K1's building blocks (k1.cuh): the chain and one reverse
// (adjoint) sweep of it from one output column, for a 64-row tile per consumer
// warpgroup, with one of three fronts and its epilogue. Shared by adj_fwd.cu (width
// classes WC_NARROW and WC_WIDE, and the entry points) and adj_fwd_dev.cu (WC_DEV,
// compiled beside it, so that the two compile in parallel).
//
// It replaces the first designs of three forwards, which held two activation tiles of
// the widest layer in shared memory and so stopped short of the hidden widths JAX
// fuses (every multiple of 128, fields/mlp.py can_fuse):
//   K4 (fused_mlp.py::_fwd_adj_kernel :362, the NeRF encoding in front): sdf [N] f32,
//      geo [N, G] bf16, grad = J_enc^T adj [N, 3] f32;
//   K5 (the same body with enc = None, fused_chain_adjoint :1215): y [N, D_out] bf16
//      and adj = d y_c / d x [N, D] f32;
//   K3 and K3f (slot_fused.py::_fused_fwd_kernel :353, the slot grid and the encoding
//      in front, bf16 or f32 table): sdf, geo, and grad through the PE Jacobian and the
//      trilerp's smoothstep derivative; in training mode also the residuals the
//      backward pass (slot_chain_bwd.cu) reads: zs and ss [L-1, N, H] bf16 row-major,
//      adj [N, d_in] f32, and for the split x0 [N, x0_width] bf16.
//
// Per tile, in the order the producer warpgroup streams the images (k1_pack's, the
// backward images included, which the call's backward reuses):
//  1. the chain (K1's: wgmma on the staged forward images, the bias seeding the
//     accumulators), the hidden layers' bf16 z into a per-slot device slab in the
//     accumulator's order (each thread reads back its own words) and, in training
//     mode, row-major into zs; the last layer's pieces to the outputs;
//  2. the adjoint sweep from v = e_channel (adj_pass.cuh's step 2 without its
//     stacks): the last layer's s is column `channel` of W_{L-1} (no product), then
//     s = bf16(v) W_l^T down to layer 0 on the backward images; the h part of s
//     (times 1/sqrt 2 at a skip layer) gives the next A image bf16(s act'(z)) in
//     place, and in training mode bf16(s) to ss; the x0 parts (skip layers, times
//     1/sqrt 2, and layer 0) add up adj in f32, row-major into a per-slot slab;
//  3. the front's epilogue from the adj rows.
//
// Cast points: those of _fwd_adj_kernel (_adj_sweep :327-359) and _fused_fwd_kernel
// (slot_fused.py:353-473): x0 bf16; z f32 accumulated with the f32 bias, stored bf16;
// h = bf16(act(z)) from the f32 z; a skip layer's input bf16(concat(h, x0) / sqrt 2);
// the last layer f32 (sdf), geo and K5's y rounded to bf16; act' taken on the bf16
// z; v rounded to bf16 before each product; adj and grad f32; K3's grid term sum T
// r(D_t cs) r(adj_grid mask), r the table type's rounding.
//
// Bound on an H100: the chain twice (primal and adjoint, the last layer's adjoint a
// column of W) on the tensor cores against the positions or rows in and the outputs:
// the tensor cores bound K4 at the mlp_raw_tpu widths, memory K5's and K3's small
// chains; PERF.md has the times.
#pragma once

#include "slot_rows.cuh"

namespace k1 {

// the chain input of a launch
enum FrontKind { FRONT_ENC = 0, FRONT_ROWS = 1, FRONT_SLOT = 2 };

// One call's operands and outputs (null: not written).
struct AdjFwdIo {
  int front;           // FrontKind
  int table_f32;       // FRONT_SLOT: the table's type (K3f: f32)
  const float* pos;    // K4, K3 [n, 3]
  const void* x;       // K5 [n, d_in], bf16 (x_bf16) or f32
  int x_bf16;
  const float* table;  // K3 [rows, 128], the f32 parameter
  const float* lmask;  // K3 [K F]
  float* sdf;          // K4, K3 [n]: column 0; then y holds columns 1 .. width
  bf16* y;             // K4, K3: geo [n, width]; K5: y [n, width], columns 0 .. width - 1
  int width;
  float* grad;         // K4, K3 [n, 3]
  float* adj;          // K5 [n, d_in]; K3 in training mode [n, d_in]
  bf16* zs;            // K3 in training mode [L-1, n, H]
  bf16* ss;            // K3 in training mode [L-1, n, H]
  bf16* x0;            // K3 for the split backward [n, x0_width]
  int x0_width;
  int channel;         // the adjoint's output column
};

struct AdjFwdScratch {
  uint32_t* zslab;  // per slot: (L-1) x 64 x H bf16 z, accumulator order
  float* fslab;     // per slot: the skip layers' adj parts (accumulator order), then adj
                    // [64][P0] row-major
  bf16* act;        // WC_DEV: per slot the activation images
};

// bytes of the z slabs, the f32 slabs and (WC_DEV) the activation slabs of `slots`
// (CTA, warpgroup) slots
inline void adj_fwd_scratch_sizes(const Geom& G, int slots, int act_bytes, size_t* s) {
  s[0] = align256((size_t)slots * (G.L - 1) * 64 * G.H * 2);
  s[1] = align256((size_t)slots * 2 * 64 * G.P0 * 4);
  s[2] = width_class(G) == WC_DEV ? align256((size_t)slots * act_bytes) : 0;
}

// The h part s (f32, skip-scaled) of an adjoint product over the hidden layer whose
// z slab words are zl: the next A image bf16(s act'(z)) into dst, and bf16(s) to row
// row0 + r of layer `layer` of ss at column col0 (in training mode).
template <int N>
__device__ __forceinline__ void adjoint_next(const float (&acc)[N / 2], bf16* dst,
                                             const uint32_t* zl, int act_kind, float qa,
                                             bf16* ss, int n, int H, int layer, long long row0,
                                             int col0) {
  const int t = threadIdx.x & 127, r0 = acc_row(), cq = acc_col();
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float2 z = unpack2(zl[(2 * j + e) * 128 + t]);
      const float s0 = acc[4 * j + 2 * e], s1 = acc[4 * j + 2 * e + 1];
      const long long gr = row0 + r0 + 8 * e;
      if (ss && gr < n)
        *reinterpret_cast<uint32_t*>(ss + ((long long)layer * n + gr) * H + col0 + 8 * j + cq) =
            pack2(s0, s1);
      *reinterpret_cast<uint32_t*>(dst + act_el(8 * j + cq, r0 + 8 * e)) =
          pack2(s0 * act_df(act_kind, z.x, qa), s1 * act_df(act_kind, z.y, qa));
    }
  }
}

// K3's grid term of d sdf / d x at one (sample, level): sum over the entry's
// features and corners of T r(D_t cs) r(adj_grid mask) into gg
template <class TT>
__device__ __forceinline__ void grid_grad(const mms::SlotParams& P, const AdjFwdIo& I, int n,
                                          long long row, int l, const float* a, float (&gg)[3]) {
  const int F = P.feats;
  const float cs = 1.f / (2.f * P.radius);
  float p[3], wa[3][2], dwa[3][2], ddwa[3][2];
  mms::load_pos(I.pos, n, row, p);
  const unsigned e = mms::cell_geom(P, l, p, wa, dwa, ddwa);
  const float* T = I.table + mms::entry_offset(P, l, e);
  float d[8][3];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int t = 0; t < 3; ++t)
      d[c][t] = mms::grid_round<TT>(mms::corner_axis_factor(wa, dwa, c, t) * cs);
  }
  for (int f = 0; f < F; ++f) {
    const float A = mms::grid_round<TT>(a[P.pw + l * F + f] * I.lmask[l * F + f]);
    float v[8];
    entry_corners<TT>(T, f, v);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int t = 0; t < 3; ++t) gg[t] += v[c] * d[c][t] * A;
    }
  }
}

template <int WC>
__global__ void __launch_bounds__(NTHREADS, 1)
adj_fwd_kernel(const Geom G, const mms::Enc E, const mms::SlotParams SP, const AdjFwdIo I,
               int n, const bf16* __restrict__ wfw, const bf16* __restrict__ wbw,
               const float* __restrict__ bpk, AdjFwdScratch S, int nwg, int stages, int sb,
               int act_bytes) {
  constexpr bool dev = WC == WC_DEV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const int L = G.L, H = G.H, P0 = G.P0;
  // bf16(W_{L-1}[:, channel]) over the last layer's padded input columns: its adjoint s
  float* wc = reinterpret_cast<float*>(smem + nwg * wg_smem<WC>(act_bytes) + stages * sb);
  float* rowval = wc + ((G.din_pad[L - 1] + 3) & ~3);  // per warpgroup [64][4]: K3's grad terms
  uint64_t* bars = reinterpret_cast<uint64_t*>(rowval + MAXWG * 256);
  Ring R{smem + nwg * wg_smem<WC>(act_bytes), bars, bars + stages, sb, stages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&R.full[s], 1);
      mbar_init(&R.empty[s], nwg);
    }
    if (dev) init_astage(bars, stages);
    fence_mbar_init();
  }
  for (int i = threadIdx.x; i < G.din_pad[L - 1]; i += blockDim.x)
    wc[i] = last_column(G, wbw, i, I.channel);
  __syncthreads();
  const int tiles = (n + 63) / 64, groups = (tiles + nwg - 1) / nwg;
  const int warp = threadIdx.x >> 5;
  if (warp >= nwg * 4) {  // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == nwg * 128) {
      for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
        stream_fwd(R, G, wfw, L);      // the chain
        stream_bwd(R, G, wbw, L - 2);  // the adjoint sweep
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp >> 2, t = threadIdx.x & 127;
  const int slot = blockIdx.x * nwg + wg, sidec = side_cols(G), x0c = x0_col(G);
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
  float* adjs = S.fslab + (size_t)slot * 2 * 64 * P0;  // the skip layers' parts
  float* ar = adjs + 64 * P0;                           // adj, row-major
  float* rv = rowval + wg * 256;
  const int top_skip = G.skip_mask ? 31 - __clz(G.skip_mask) : -1;
  const int r0 = acc_row(), cq = acc_col();
  const float qa = G.quad_a;
  const int act_kind = G.act;
  const int nph = hidden_pieces<WC>(H);  // pieces of a hidden-width product
  auto prefetch = [&](const uint32_t* slab) {
    if (t == 0) bulk_prefetch_l2(slab, (uint32_t)zwords * 4);
  };
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long row0 = (long long)(grp * nwg + wg) * 64;
    // ---- the chain input
    if (I.front == FRONT_SLOT) {
      if (I.table_f32)
        slot_rows<float>(SP, I.pos, n, row0, I.table, I.lmask, act, x0c, P0);
      else
        slot_rows<bf16>(SP, I.pos, n, row0, I.table, I.lmask, act, x0c, P0);
    } else if (I.front == FRONT_ENC) {
      for (int i = t; i < 64 * P0; i += 128) {
        const int r = i / P0, c = i % P0;
        const long long row = row0 + r;
        const float v =
            c < E.width && row < n ? mms::pe_col(I.pos + row * 3, E.freqs, E.scale, c) : 0.f;
        act[act_el(x0c + c, r)] = __float2bfloat16(v);
      }
    } else {
      load_rows(act, x0c, P0, I.x, I.x_bf16, E.width, row0, n);
    }
    fence_act<WC>();
    wg_sync(1 + wg);
    if (I.x0) {
      const int w = I.x0_width;
      for (int i = t; i < 64 * w; i += 128) {
        const int r = i / w, c = i - r * w;
        if (row0 + r < n) I.x0[(row0 + r) * w + c] = act[act_el(x0c + c, r)];
      }
    }
    // ---- 1. the chain; z to the slab (and zs), the last layer to the outputs
    for (int l = 0; l < L; ++l) {
      const bf16* a = act + (l == 0 ? (x0c >> 6) * 4096 : 0);
      const int kcs = G.din_pad[l] >> 6;
      const float* B = bpk + G.b_off[l];
      if (l == L - 1) {
        for (int p = 0; p < n_pieces(G.dout_pad[l]); ++p) {
          int off, np;
          piece(G.dout_pad[l], p, off, np);
          with_n(np, [&](auto NC) {
            constexpr int N = decltype(NC)::value;
            float acc[N / 2];
            mma_piece<N>(acc, a, kcs, R, wg, B + off, 3, asp);
#pragma unroll
            for (int j = 0; j < N / 8; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const long long gr = row0 + r0 + 8 * e;
                if (gr >= n) continue;
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                  const int c = off + 8 * j + cq + q;
                  const float z = acc[4 * j + 2 * e + q];
                  if (I.sdf) {
                    if (c == 0)
                      I.sdf[gr] = z;
                    else if (c <= I.width)
                      I.y[gr * I.width + c - 1] = __float2bfloat16(z);
                  } else if (c < I.width) {
                    I.y[gr * I.width + c] = __float2bfloat16(z);
                  }
                }
              }
            }
          });
        }
        break;
      }
      const bool next_skip = (G.skip_mask >> (l + 1)) & 1;
      for (int p = 0; p < nph; ++p) {
        int off, np;
        hidden_piece<WC>(H, p, off, np);
        bf16* dst = piece_dst<WC>(act, act_bytes, sidec, p, nph, off);
        uint32_t* zl = zs + l * zwords + (off >> 2) * 128;
        with_n64(np, [&](auto NC) {
          constexpr int N = decltype(NC)::value;
          float acc[N / 2];
          mma_piece<N>(acc, a, kcs, R, wg, B + off, 3, asp);
          if (I.zs) {
#pragma unroll
            for (int j = 0; j < N / 8; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const long long gr = row0 + r0 + 8 * e;
                if (gr < n)
                  *reinterpret_cast<uint32_t*>(I.zs + ((long long)l * n + gr) * H + off + 8 * j +
                                               cq) = pack2(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
              }
            }
          }
          write_hidden<N, false>(acc, dst, next_skip, act_kind, qa, zl);
        });
      }
      side_back<WC>(act, act_bytes, sidec, wg);
      if (l == 0 && G.skip_mask) scale_region(act, H, P0);
      fence_act<WC>();
      wg_sync(1 + wg);
    }
    // ---- 2. the adjoint sweep; the last layer's s is column `channel` of W_{L-1}
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
          adjoint_next<N>(acc, act + (off >> 6) * 4096, zs + (L - 2) * zwords + (off >> 2) * 128,
                          act_kind, qa, I.ss, n, H, L - 2, row0, off);
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
            slab_accumulate<N>(adjs, off, acc, SKIP_SCALE, true);
          });
        }
      }
      fence_act<WC>();
      wg_sync(1 + wg);
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
          if (l == 0) {  // adj = s_0 + the skip layers' parts, row-major
            const float* g0 = adjs + (off >> 1) * 128 + t;
#pragma unroll
            for (int j = 0; j < N / 8; ++j) {
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int i = 4 * j + k, c = off + 8 * j + cq + (k & 1);
                ar[(r0 + 8 * (k >> 1)) * P0 + c] = acc[i] + (top_skip >= 0 ? g0[i * 128] : 0.f);
              }
            }
          } else if (x0part) {  // a skip layer's x0 part (times 1/sqrt 2) into adj
            slab_accumulate<N>(adjs, off - H, acc, SKIP_SCALE, l == top_skip);
          } else {
            if (skip) {
#pragma unroll
              for (int i = 0; i < N / 2; ++i) acc[i] *= SKIP_SCALE;
            }
            const int hoff = WC ? off : 0;  // the h part's one piece starts at 0
            adjoint_next<N>(acc, piece_dst<WC>(act, act_bytes, sidec, p, npc, hoff),
                            zs + (l - 1) * zwords + (hoff >> 2) * 128, act_kind, qa, I.ss, n, H,
                            l - 1, row0, hoff);
          }
        });
      }
      if (l > 0) side_back<WC>(act, act_bytes, sidec, wg);
      fence_act<WC>();
      wg_sync(1 + wg);
    }
    // ---- 3. the front's epilogue from the adj rows
    if (I.adj) {
      const int w = E.width;
      for (int i = t; i < 64 * w; i += 128) {
        const int r = i / w, c = i - r * w;
        if (row0 + r < n) I.adj[(row0 + r) * w + c] = ar[r * P0 + c];
      }
    }
    if (I.front == FRONT_ENC) {  // grad = J_enc^T adj
      for (int i = t; i < 64 * 3; i += 128) {
        const int r = i / 3, k = i - r * 3;
        const long long row = row0 + r;
        if (row < n)
          I.grad[row * 3 + k] = mms::pe_jt(ar + r * P0, I.pos + row * 3, E.freqs, E.scale, k);
      }
    } else if (I.front == FRONT_SLOT) {  // grad = J_enc^T adj + the grid term; thread t takes
                                         // sample t % 64 and the levels of its half
      const int r = t & 63, half = t >> 6;
      const long long row = row0 + r;
      float gg[3] = {0.f, 0.f, 0.f};
      if (row < n) {
        for (int l = half; l < SP.levels; l += 2) {
          if (I.table_f32)
            grid_grad<float>(SP, I, n, row, l, ar + r * P0, gg);
          else
            grid_grad<bf16>(SP, I, n, row, l, ar + r * P0, gg);
        }
      }
      if (half) {
#pragma unroll
        for (int k = 0; k < 3; ++k) rv[r * 4 + k] = gg[k];
      }
      wg_sync(1 + wg);
      if (!half && row < n) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
          I.grad[row * 3 + k] = mms::pe_jt(ar + r * P0, I.pos + row * 3, SP.pe_freqs,
                                           SP.pe_scale, k) + (gg[k] + rv[r * 4 + k]);
      }
    }
    wg_sync(1 + wg);  // the adj rows and rv read before the next tile writes them
  }
}

// The pass of width class WC on launch plan P.
template <int WC>
int adj_fwd_launch(const Geom& G, const mms::Enc& E, const mms::SlotParams& SP,
                   const AdjFwdIo& I, int n, const void* wfw, const void* wbw, const void* bpk,
                   const AdjFwdScratch& S, const Launch& P, cudaStream_t stream) {
  adj_fwd_kernel<WC><<<P.grid, P.threads, P.smem, stream>>>(
      G, E, SP, I, n, (const bf16*)wfw, (const bf16*)wbw, (const float*)bpk, S, P.nwg, P.stages,
      P.sb, P.act_bytes);
  return (int)cudaGetLastError();
}

template <int WC>
const void* adj_fwd_kernel_of() {
  return (const void*)adj_fwd_kernel<WC>;
}

// WC_DEV's, in adj_fwd_dev.cu
int adj_fwd_launch_dev(const Geom& G, const mms::Enc& E, const mms::SlotParams& SP,
                       const AdjFwdIo& I, int n, const void* wfw, const void* wbw, const void* bpk,
                       const AdjFwdScratch& S, const Launch& P, cudaStream_t stream);
const void* adj_fwd_kernel_dev();

}  // namespace k1
