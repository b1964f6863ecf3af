// The backwards of the slot-grid SDF chains, K3 (sdf, geo and d sdf / dx; bf16 table,
// K3f: f32 table) and K2 (sdf only; K2f: f32 table), merged and split, redesigned for
// Hopper on K1's building blocks (k1.cuh): a per-tile pass on wgmma and the stacked
// weight-gradient product (chain_wgrad of fused_chain.cu).
//
// Replaces four Pallas TPU kernels of multimodalstudio_tpu/ops/pallas/slot_fused.py:
//   _fused_bwd_kernel (:474, call :1095, via fused_slot_sdf_chain's op_bwd :1149-1189),
//      K3's merged backward: d pos [N, 3] f32, the table gradient [rows, 128] f32 and
//      the chain's gW / gb f32;
//   _bwd_sample_kernel (:758, call :1056), K3's split per-sample pass
//      (MMS_SLOT_BWD_SPLIT=1): d pos and each (sample, level)'s table cotangent,
//      compact as [N, K, 8F] in the table's type (bf16, or f32 for an f32 table),
//      which the split's scatter (slot_split.cu) adds into the table gradient; its
//      weight gradients (JAX's _wgrads_xla :938) are chain_wgrad's here too;
//   _value_bwd_kernel (:1370, via fused_slot_sdf_value's op_bwd :1737) and
//      _value_bwd_sample_kernel (:1485), K2's merged backward and split pass, in the
//      pass's value mode: the first-order backward of sdf alone, with the weight
//      gradients of the split (_value_wgrads_xla :1567) chain_wgrad's as well.
// One pass serves the eight: the table's type, the split and the value mode are
// run-time flags, so the products compile once per width class (k1.cuh WC).
//
// The pass takes the forward's residuals (adj_fwd.cuh; K2's: slot_value.cu), as the
// reference does: the bf16 pre-activations zs and adjoint rows ss [L-1, N, H] and the
// f32 adjoint adj [N, d_in]; nothing of the forward is recomputed but the tile's chain input x0. The
// weights arrive as the images of one k1_pack launch (forward images W^T for m =
// qin W, backward images W for gh = gz W^T), streamed through the ring by the
// producer warpgroup. A consumer warpgroup owns a 64-row tile. Per tile:
//  0. the slot grid and the encoding in front (slot_rows.cuh), x0 into the
//     activation images and its stack; the stacks hin_l = bf16(act(z_{l-1})) (a skip
//     layer bf16(concat(that, x0) / sqrt 2)) and v_l = bf16(s_l act'(z_l)) written
//     from the residuals, 16 bytes a thread at a time, with no product;
//  1. ga, the cotangent of adj (:586-601): PE columns sum_k g3_k bf16(t0_k), grid
//     columns (sum_p r(T dwg)) * mask with dwg = r(sum_k g3_k dw_k / 2r), r the table
//     type's rounding, f32 in a slab and bf16 in the first A image;
//  2. the ga-forward chain (:603-638): m = qin_l W_l, e_l = bf16(m s_l act''(z_l))
//     into a slab, q = m act'(z_l) into the next A image (bf16(concat(q, ga) /
//     sqrt 2) at a skip layer); stacks qin_l; the last layer's v being e_0, its gW
//     term is the column sums of qin_{L-1} into gW_{L-1}[:, 0], per CTA in shared
//     memory;
//  3. the reverse sweep (:648-694) from [gsdf, ggeo, 0] rounded to bf16 (gb_{L-1}
//     sums the f32 gsdf): gz_{l-1} = bf16(gh act'(z_{l-1}) + e_{l-1}); stacks gz_l;
//     gb per CTA from the f32 gz (split: from bf16(gz), as _wgrads_xla sums the bf16
//     gz stack); the chain input's cotangent ghin = gh_0 + the skip layers' x0 parts,
//     f32 into a slab;
//  4. the grid (:696-735): per (sample, level) the table cotangent r(gc0 dwg + gt0 w)
//     and the trilerp folds, first and second order (_fold_pos_cotangent :330); d pos
//     = J_enc^T ghin + g3 (PE Hessian on adj) + the folds.
// gW_l = hin_l^T gz_l + qin_l^T v_l is then one product over 2N stacked rows (layer
// L-1: N rows), chain_wgrad's over the stacks [hin | qin] and [gz | v].
// The value mode (K2, its chain cut to the sdf column) reads zs alone and runs steps 0,
// 3 and 4 without the adjoint path: no v stacks, no ga, no ga-forward (its images are
// not streamed), e = 0, the last layer's cotangent [gsdf, 0], and the grid's first
// order only, the table cotangent r(gt0 w) and d pos = J_enc^T ghin + the fold of d_w
// (the cast points of _value_bwd_kernel and _value_bwd_sample_kernel); gW_l = hin_l^T
// gz_l over the K1 layout's stacks.
//
// The table cotangent (merged): where the first design added one f32 atomic per
// (sample, level, feature, corner), four corners of one feature, adjacent in the
// entry, go as one vector reduction (atomicAdd of a float4, sm_90), skipped where all
// four are zero; the sums stay f32 and their order changes from run to run. Split: the
// compact cotangent is stored, 16 bytes at a time.
//
// Cast points as the reference's (and the first designs'): gz rounded to
// bf16 before both products; with a bf16 table each sample's table cotangent and d_w,
// gt0, gc0 and dwg rounded to bf16, the table values rounded as they are read from the
// f32 parameter; an f32 table keeps them f32; a skip layer takes bf16(concat / sqrt 2),
// with ga re-injected there.
//
// Bound on an H100: per sample two sweeps of the chain's products (the ga-forward and
// the reverse sweep, 4 N sum(din dout) flops at the main path's widths) against the
// residuals read once (2 (L-1) H bf16 and d_in f32 per sample) and the stacks written
// once (2 x (sum din + sum dout) bf16 per sample, read again by chain_wgrad), plus the
// table cotangent: the bytes bound it; PERF.md has the times.
#include "slot_rows.cuh"

namespace k1 {

// One call's operands: positions, the f32 table parameter and the level mask; the
// residuals; the cotangents; the outputs (merged: d_table accumulated; split: dcomp).
struct SlotBwdIo {
  const float* pos;    // [n, 3]
  const float* table;  // [rows, 128] f32
  const float* lmask;  // [K F]
  const bf16* zs;      // [L-1, n, H]
  const bf16* ss;      // [L-1, n, H]
  const float* adj;    // [n, adj_width]
  const float* gsdf;   // [n]
  const bf16* ggeo;    // [n, geo_width]
  const float* g3;     // [n, 3]
  float* d_pos;        // [n, 3]
  float* d_table;      // merged: [rows, 128] f32
  void* dcomp;         // split: [n, K, 8F] bf16 (f32 for an f32 table)
  int adj_width, geo_width, table_f32, split;
  int value;           // K2's backward: no adjoint path (ss, adj, ggeo, g3 unread)
};

struct SlotScratch {
  bf16* a;          // A stacks: per layer [hin tiles | qin tiles] (layer L-1: hin tiles)
  bf16* b;          // B stacks: per layer [gz tiles | v tiles] (layer L-1: gz tiles)
  uint32_t* eslab;  // per slot: (L-1) x 64 x H bf16 e_l, accumulator order
  float* fslab;     // per slot: ga, then ghin, [64][P0] f32 row-major; gx0 in accumulator order
  bf16* act;        // WC_DEV: per slot the activation images
};

// bytes of the stacks, the e slabs, the f32 slabs and (WC_DEV) the activation slabs
static void slot_scratch_sizes(const Geom& G, int tiles, int slots, int act_bytes, size_t* s) {
  stack_sizes(G, tiles, s);
  s[2] = align256((size_t)slots * (G.L - 1) * 64 * G.H * 2);
  s[3] = align256((size_t)slots * 2 * 64 * G.P0 * 4);
  s[4] = width_class(G) == WC_DEV ? align256((size_t)slots * act_bytes) : 0;
}

// element offset of the 16-byte unit u (columns 8u .. 8u + 7) of row r in a tile's
// activation images or stack images
__device__ __forceinline__ int unit_el(int r, int u) {
  return (u >> 3) * 4096 + r * 64 + (((u ^ r) & 7) << 3);
}

// the 8 bf16 of unit u of row `row` of layer l of a [L-1, n, H] residual stack (zero
// past n)
__device__ __forceinline__ uint4 resid_unit(const bf16* st, int n, int H, int l, long long row,
                                            int u) {
  if (row >= n) return make_uint4(0, 0, 0, 0);
  return __ldg(reinterpret_cast<const uint4*>(st + ((size_t)l * n + row) * H) + u);
}

// the words (2 bf16) of a residual stack at the thread's accumulator columns c, c + 1
// of row `row` (zero past n)
__device__ __forceinline__ uint32_t resid_word(const bf16* st, int n, int H, int l,
                                               long long row, int c) {
  if (row >= n) return 0u;
  return __ldg(reinterpret_cast<const uint32_t*>(st + ((size_t)l * n + row) * H + c));
}

// The residual stacks of the tile: hin_l (l >= 1) into a_at(l), the x0 part of a skip
// layer's bf16(x0 / sqrt 2) from the x0 images at column x0c; v_l (l < L-1) into
// b_at(l), but in value mode. Every unit by the warpgroup's threads, straight to device memory.
template <class AAt, class BAt>
__device__ __forceinline__ void residual_stacks(const Geom& G, const SlotBwdIo& I, int n,
                                                long long row0, const bf16* act, int x0c,
                                                const AAt& a_at, const BAt& b_at) {
  const int L = G.L, H = G.H, hu = G.H / 8, t = threadIdx.x & 127;
  const int act_kind = G.act;
  const float qa = G.quad_a;
  for (int l = 1; l < L; ++l) {
    const bool skip = (G.skip_mask >> l) & 1;
    bf16* dst = a_at(l);
    for (int i = t; i < 64 * hu; i += 128) {
      const int r = i / hu, u = i - r * hu;
      const uint4 zw = resid_unit(I.zs, n, H, l - 1, row0 + r, u);
      const uint32_t* z = reinterpret_cast<const uint32_t*>(&zw);
      uint32_t h[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 zz = unpack2(z[k]);
        h[k] = pack2(act_f(act_kind, zz.x, qa), act_f(act_kind, zz.y, qa));
        if (skip) {
          const float2 v = unpack2(h[k]);
          h[k] = pack2(v.x * SKIP_SCALE, v.y * SKIP_SCALE);
        }
      }
      *reinterpret_cast<uint4*>(dst + unit_el(r, u)) = make_uint4(h[0], h[1], h[2], h[3]);
    }
    if (!skip) continue;
    const int pu = G.P0 / 8;
    for (int i = t; i < 64 * pu; i += 128) {
      const int r = i / pu, u = i - r * pu;
      const uint4 xw = *reinterpret_cast<const uint4*>(act + unit_el(r, x0c / 8 + u));
      const uint32_t* x = reinterpret_cast<const uint32_t*>(&xw);
      uint32_t o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 v = unpack2(x[k]);
        o[k] = pack2(v.x * SKIP_SCALE, v.y * SKIP_SCALE);
      }
      *reinterpret_cast<uint4*>(dst + unit_el(r, hu + u)) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
  for (int l = 0; l < L - 1 && !I.value; ++l) {
    bf16* dst = b_at(l);
    for (int i = t; i < 64 * hu; i += 128) {
      const int r = i / hu, u = i - r * hu;
      const uint4 zw = resid_unit(I.zs, n, H, l, row0 + r, u);
      const uint4 sw = resid_unit(I.ss, n, H, l, row0 + r, u);
      const uint32_t* z = reinterpret_cast<const uint32_t*>(&zw);
      const uint32_t* s = reinterpret_cast<const uint32_t*>(&sw);
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 zz = unpack2(z[k]), ss = unpack2(s[k]);
        v[k] = pack2(ss.x * act_df(act_kind, zz.x, qa), ss.y * act_df(act_kind, zz.y, qa));
      }
      *reinterpret_cast<uint4*>(dst + unit_el(r, u)) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// dwg of the 8 corners: r(sum_k g3_k dw_c / d g_k / 2r)
template <class TT>
__device__ __forceinline__ void corner_dwg(const float (&g3)[3], const float (&wa)[3][2],
                                           const float (&dwa)[3][2], float cs, float (&dwg)[8]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float s = g3[0] * (mms::corner_axis_factor(wa, dwa, c, 0) * cs);
    s = s + g3[1] * (mms::corner_axis_factor(wa, dwa, c, 1) * cs);
    s = s + g3[2] * (mms::corner_axis_factor(wa, dwa, c, 2) * cs);
    dwg[c] = mms::grid_round<TT>(s);
  }
}

// Step 1: ga of the tile, f32, into ga [64][P0] (row-major): the PE columns and the
// padding by every thread's column loop, the grid columns one (sample, level) per thread.
template <class TT>
__device__ __forceinline__ void adj_cotangent(const mms::SlotParams& P, const SlotBwdIo& I, int n,
                                              long long row0, int P0, float* ga) {
  const int t = threadIdx.x & 127, K = P.levels, F = P.feats, pw = P.pw;
  const int grid_end = pw + K * F, FP = P.pe_freqs;
  const float cs = 1.f / (2.f * P.radius);
  for (int i = t; i < 64 * P0; i += 128) {
    const int r = i / P0, c = i - r * P0;
    if (c >= pw && c < grid_end) continue;
    const long long row = row0 + r;
    float v = 0.f;
    if (c < pw && row < n) {
      const float* g3 = I.g3 + row * 3;
      if (c < 3) {
        v = g3[c];
      } else {
        const int d = (c - 3) % (3 * FP) / FP;
        v = g3[d] * mms::pe_tangent(I.pos + row * 3, FP, P.pe_scale, c);
      }
    }
    ga[i] = v;
  }
  for (int i = t; i < 64 * K; i += 128) {
    const int r = i / K, l = i - r * K;
    const long long row = row0 + r;
    float* gr = ga + r * P0 + pw + l * F;
    if (row >= n) {
      for (int f = 0; f < F; ++f) gr[f] = 0.f;
      continue;
    }
    float p[3], g3[3], wa[3][2], dwa[3][2], ddwa[3][2];
    mms::load_pos(I.pos, n, row, p);
#pragma unroll
    for (int k = 0; k < 3; ++k) g3[k] = I.g3[row * 3 + k];
    const unsigned e = mms::cell_geom(P, l, p, wa, dwa, ddwa);
    const float* T = I.table + mms::entry_offset(P, l, e);
    float dwg[8];
    corner_dwg<TT>(g3, wa, dwa, cs, dwg);
    for (int f = 0; f < F; ++f) {
      float v[8];
      entry_corners<TT>(T, f, v);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc += mms::grid_round<TT>(v[c] * dwg[c]);
      gr[f] = acc * I.lmask[l * F + f];
    }
  }
}

// Step 4's grid part of one (sample, level): the table cotangent (merged: vector
// reductions into d_table; split: the compact row) and the trilerp folds into gp.
template <class TT>
__device__ __forceinline__ void grid_cotangent(const mms::SlotParams& P, const SlotBwdIo& I, int n,
                                               long long row, int l, const float* ghin,
                                               float (&gp)[3]) {
  const int F = P.feats, K = P.levels, pw = P.pw;
  const float cs = 1.f / (2.f * P.radius);
  float p[3], g3[3], wa[3][2], dwa[3][2], ddwa[3][2];
  mms::load_pos(I.pos, n, row, p);
#pragma unroll
  for (int k = 0; k < 3; ++k) g3[k] = I.value ? 0.f : I.g3[row * 3 + k];
  const unsigned e = mms::cell_geom(P, l, p, wa, dwa, ddwa);
  const long long eo = mms::entry_offset(P, l, e);
  const float* T = I.table + eo;
  const float* a = I.value ? nullptr : I.adj + row * I.adj_width;
  float dwg[8], wb[8], dw[8], dd[8];
  corner_dwg<TT>(g3, wa, dwa, cs, dwg);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    wb[c] = mms::corner_weight<TT>(wa, c);
    dw[c] = dd[c] = 0.f;
  }
  float* dt = I.split ? nullptr : I.d_table + eo;
  TT* dc = I.split ? static_cast<TT*>(I.dcomp) + (row * K + l) * 8 * F : nullptr;
  for (int f = 0; f < F; ++f) {
    const int col = pw + l * F + f;
    const float m = I.lmask[l * F + f];
    const float gc0 = a ? mms::grid_round<TT>(a[col] * m) : 0.f;
    const float gt0 = mms::grid_round<TT>(ghin[col] * m);
    float v[8], tv[8];
    entry_corners<TT>(T, f, tv);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      v[c] = mms::grid_round<TT>(gc0 * dwg[c] + gt0 * wb[c]);
      dw[c] += mms::grid_round<TT>(tv[c] * gt0);
      dd[c] += mms::grid_round<TT>(tv[c] * gc0);
    }
    if (dc) {
      if constexpr (std::is_same<TT, bf16>::value) {
        *reinterpret_cast<uint4*>(dc + f * 8) = make_uint4(
            pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
      } else {
        reinterpret_cast<float4*>(dc + f * 8)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(dc + f * 8)[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 q = make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
        if (q.x != 0.f || q.y != 0.f || q.z != 0.f || q.w != 0.f)
          atomicAdd(reinterpret_cast<float4*>(dt + f * 8 + 4 * h), q);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int bit[3] = {c & 1, (c >> 1) & 1, (c >> 2) & 1};
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int u = (t + 1) % 3, w = (t + 2) % 3;
      float acc = dw[c] * mms::corner_axis_factor(wa, dwa, c, t);
#pragma unroll
      for (int k = 0; k < 3; ++k) {  // the second order, on adj (none in value mode)
        if (I.value) break;
        float dD;
        if (k == t) {
          dD = ddwa[k][bit[k]] * wa[u][bit[u]] * wa[w][bit[w]];
        } else {
          const int o = 3 - k - t;
          dD = dwa[k][bit[k]] * dwa[t][bit[t]] * wa[o][bit[o]];
        }
        acc = acc + cs * ((g3[k] * dd[c]) * dD);
      }
      gp[t] += acc;
    }
  }
}

template <int WC>
__global__ void __launch_bounds__(NTHREADS, 1)
slot_chain_pass_kernel(const Geom G, const mms::SlotParams P, const SlotBwdIo I, int n,
                       const bf16* __restrict__ wfw, const bf16* __restrict__ wbw,
                       float* __restrict__ gw, float* __restrict__ gb, SlotScratch S, int nwg,
                       int stages, int sb, int act_bytes) {
  constexpr bool dev = WC == WC_DEV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* csum = reinterpret_cast<float*>(smem + nwg * wg_smem<WC>(act_bytes) + stages * sb);
  const int L = G.L, H = G.H, P0 = G.P0;
  const int x0c = x0_col(G);
  const int gb_total = G.gb_off[L - 1] + G.dout_true[L - 1];
  const int dlast = G.din_true[L - 1];
  float* csw = csum + ((gb_total + 3) & ~3);      // column sums of qin_{L-1}
  float* rowval = csw + ((dlast + 3) & ~3);       // per warpgroup [64][4]: d pos terms
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
  for (int i = threadIdx.x; i < gb_total; i += blockDim.x) csum[i] = 0.f;
  for (int i = threadIdx.x; i < dlast; i += blockDim.x) csw[i] = 0.f;
  __syncthreads();
  const int tiles = (n + 63) / 64, groups = (tiles + nwg - 1) / nwg;
  const int warp = threadIdx.x >> 5;
  if (warp >= nwg * 4) {  // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == nwg * 128) {
      for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
        if (!I.value) stream_hidden_fwd(R, G, wfw);  // ga-forward m
        stream_bwd(R, G, wbw, L - 1);                // reverse sweep
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
  float* rv = rowval + wg * 256;
  {
    uint4* p = reinterpret_cast<uint4*>(act);
    for (int i = t; i < act_bytes / 16; i += 128) p[i] = make_uint4(0, 0, 0, 0);
  }
  wg_sync(1 + wg);
  const size_t zwords = (size_t)(H / 4) * 128;  // one layer's slab words
  uint32_t* es = S.eslab + (size_t)slot * (L - 1) * zwords;
  float* ga = S.fslab + (size_t)slot * 2 * 64 * P0;  // ga, then ghin, row-major
  float* gx0 = ga + 64 * P0;                         // accumulator order
  const int top_skip = G.skip_mask ? 31 - __clz(G.skip_mask) : -1;
  const int r0 = acc_row(), cq = acc_col();
  const float qa = G.quad_a;
  const int act_kind = G.act;
  const bool f32t = I.table_f32;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int tile = grp * nwg + wg;
    const long long row0 = (long long)tile * 64;
    const int rows = (int)min(64LL, max(0LL, (long long)n - row0));
    const Stacker st{tile < tiles, dev};
    const int nph = hidden_pieces<WC>(H);  // pieces of a hidden-width product
    auto a_at = [&](int l, int half) {
      return S.a + (size_t)tiles * 64 * G.hs_w[l] +
             (size_t)(half * tiles + tile) * 64 * G.din_pad[l];
    };
    auto b_at = [&](int l, int half) {
      return S.b + (size_t)tiles * 64 * G.gs_w[l] +
             (size_t)(half * tiles + tile) * 64 * gcols(G, l);
    };
    // a layer's residual rows of the tile into L2 while the products run
    auto prefetch = [&](const bf16* stack, int l) {
      if (t == 0 && rows > 0)
        bulk_prefetch_l2(stack + ((size_t)l * n + row0) * H, (uint32_t)rows * H * 2);
    };
    // ---- 0. x0 and its stack; the residual stacks hin_l (l >= 1) and v_l
    if (f32t)
      slot_rows<float>(P, I.pos, n, row0, I.table, I.lmask, act, x0c, P0);
    else
      slot_rows<bf16>(P, I.pos, n, row0, I.table, I.lmask, act, x0c, P0);
    fence_act<WC>();
    wg_sync(1 + wg);
    st.store(a_at(0, 0), act + (x0c >> 6) * 4096, P0);
    if (st.on)
      residual_stacks(G, I, n, row0, act, x0c, [&](int l) { return a_at(l, 0); },
                      [&](int l) { return b_at(l, 1); });
    if (I.value) {
      st.drain(wg);  // x0's stack store and the hin stacks have read the x0 images
    } else {
      // ---- 1. ga, f32 in its slab, bf16 into the x0 images
      if (f32t)
        adj_cotangent<float>(P, I, n, row0, P0, ga);
      else
        adj_cotangent<bf16>(P, I, n, row0, P0, ga);
      st.drain(wg);  // x0's stack store and the residual stacks have read the x0 images
      for (int i = t; i < 64 * P0; i += 128) {
        const int r = i / P0, c = i - r * P0;
        act[act_el(x0c + c, r)] = __float2bfloat16(ga[i]);
      }
      fence_act<WC>();
      wg_sync(1 + wg);
      // ---- 2. the ga-forward chain; stacks qin_l; e_l into its slab
      for (int l = 0; l < L - 1; ++l) {
        const bf16* a = act + (l == 0 ? (x0c >> 6) * 4096 : 0);
        st.store(a_at(l, 1), a, G.din_pad[l]);
        const bool next_skip = (G.skip_mask >> (l + 1)) & 1;
        prefetch(I.zs, l);
        prefetch(I.ss, l);
        for (int p = 0; p < nph; ++p) {
          int off, np;
          hidden_piece<WC>(H, p, off, np);
          bf16* dst = piece_dst<WC>(act, act_bytes, sidec, p, nph, off);
          uint32_t* el = es + l * zwords + (off >> 2) * 128;
          with_n64(np, [&](auto NC) {
            constexpr int N = decltype(NC)::value;
            float acc[N / 2];
            mma_piece<N>(acc, a, G.din_pad[l] >> 6, R, wg, nullptr, 3, asp);
            st.drain(wg);
            // ga again, scaled, once layer 0's last product read it
            if (l == 0 && G.skip_mask && p + 1 == nph) {
              for (int i = t; i < 64 * P0; i += 128) {
                const int r = i / P0, c = i - r * P0;
                act[act_el(H + c, r)] = __float2bfloat16(ga[i] * SKIP_SCALE);
              }
            }
#pragma unroll
            for (int j = 0; j < N / 8; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const long long row = row0 + r0 + 8 * e;
                const int c = off + 8 * j + cq;
                const float2 z = unpack2(resid_word(I.zs, n, H, l, row, c));
                const float2 s = unpack2(resid_word(I.ss, n, H, l, row, c));
                const float m0 = acc[4 * j + 2 * e], m1 = acc[4 * j + 2 * e + 1];
                el[(2 * j + e) * 128 + t] = pack2(m0 * s.x * act_ddf(act_kind, z.x, qa),
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
      // the last layer's v is e_0: gW_{L-1}[:, 0] += column sums of qin_{L-1}
      for (int c = t; c < dlast; c += 128) {
        float s = 0.f;
        for (int r = 0; r < 64; ++r) s += bf(act[act_el(c, r)]);
        atomicAdd(&csw[c], s);
      }
      wg_sync(1 + wg);
    }
    // ---- 3. the reverse sweep from [gsdf, ggeo, 0]; stacks gz_l
    const int dl = G.dout_true[L - 1], gl = gcols(G, L - 1);
    for (int i = t; i < 64 * gl; i += 128) {
      const int r = i / gl, c = i - r * gl;
      const long long row = row0 + r;
      bf16 v = __float2bfloat16(0.f);
      if (row < n) {
        if (c == 0)
          v = __float2bfloat16(I.gsdf[row]);
        else if (c - 1 < I.geo_width)
          v = I.ggeo[row * I.geo_width + c - 1];
      }
      act[act_el(c, r)] = v;
    }
    fence_act<WC>();
    wg_sync(1 + wg);
    st.store(b_at(L - 1, 0), act, gl);
    for (int c = t; c < dl; c += 128) {  // gb_{L-1}: gsdf in f32, ggeo's bf16 values
      float s = 0.f;
      if (c == 0) {
        for (int r = 0; r < rows; ++r) s += I.gsdf[row0 + r];
      } else {
        for (int r = 0; r < 64; ++r) s += bf(act[act_el(c, r)]);
      }
      atomicAdd(&csum[G.gb_off[L - 1] + c], s);
    }
    for (int l = L - 1; l >= 0; --l) {
      const int kcs = gcols(G, l) >> 6, npc = bwd_n_pieces(G, l);
      const bool skip = (G.skip_mask >> l) & 1;
      if (l > 0) {
        prefetch(I.zs, l - 1);
        if (t == 0 && !I.value) bulk_prefetch_l2(es + (l - 1) * zwords, (uint32_t)zwords * 4);
      }
      for (int p = 0; p < npc; ++p) {
        int off, np;
        bool x0part;
        bwd_piece(G, l, p, off, np, x0part);
        with_n64(np, [&](auto NC) {
          constexpr int N = decltype(NC)::value;
          float acc[N / 2];
          mma_piece<N>(acc, act, kcs, R, wg, nullptr, 3, asp);
          if (l == 0) {  // ghin = gh_0 + gx0, f32 into the slab (ga's, now free)
            const bool has_gx0 = top_skip >= 0;
#pragma unroll
            for (int j = 0; j < N / 8; ++j) {
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int i = 4 * j + k, c = off + 8 * j + cq + (k & 1);
                const float g0 = has_gx0 ? gx0[((off >> 1) + i) * 128 + t] : 0.f;
                ga[(r0 + 8 * (k >> 1)) * P0 + c] = acc[i] + g0;
              }
            }
          } else if (x0part) {  // a skip layer's x0 columns: gx0 += gh / sqrt 2
            slab_accumulate<N>(gx0, off - H, acc, SKIP_SCALE, l == top_skip);
          } else {  // gz_{l-1} = bf16(gh act'(z_{l-1}) + e_{l-1}) and its column sums
            const int hoff = WC ? off : 0;  // the h part's one piece starts at 0
            const uint32_t* el = es + (l - 1) * zwords + (hoff >> 2) * 128;
            float* cs = csum + G.gb_off[l - 1] + hoff;
            bf16* dst = piece_dst<WC>(act, act_bytes, sidec, p, npc, hoff);
            st.drain(wg);
#pragma unroll
            for (int j = 0; j < N / 8; ++j) {
              float s0 = 0.f, s1 = 0.f;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const long long row = row0 + r0 + 8 * e;
                const float2 z = unpack2(resid_word(I.zs, n, H, l - 1, row, hoff + 8 * j + cq));
                const float2 ev = I.value ? make_float2(0.f, 0.f)
                                          : unpack2(el[(2 * j + e) * 128 + t]);
                float g0 = acc[4 * j + 2 * e], g1 = acc[4 * j + 2 * e + 1];
                if (skip) {
                  g0 *= SKIP_SCALE;
                  g1 *= SKIP_SCALE;
                }
                g0 = g0 * act_df(act_kind, z.x, qa) + ev.x;
                g1 = g1 * act_df(act_kind, z.y, qa) + ev.y;
                const uint32_t gzb = pack2(g0, g1);
                if (I.split) {  // the split's gb sums the bf16 gz
                  const float2 gr = unpack2(gzb);
                  g0 = gr.x;
                  g1 = gr.y;
                }
                s0 += g0;
                s1 += g1;
                *reinterpret_cast<uint32_t*>(dst + act_el(8 * j + cq, r0 + 8 * e)) = gzb;
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
    // ---- 4. the grid: table cotangent and folds, then d pos. Thread t takes sample
    // t % 64 and the levels of its half.
    {
      const int r = t & 63, half = t >> 6;
      const long long row = row0 + r;
      float gp[3] = {0.f, 0.f, 0.f};
      if (row < n) {
        for (int l = half; l < P.levels; l += 2) {
          if (f32t)
            grid_cotangent<float>(P, I, n, row, l, ga + r * P0, gp);
          else
            grid_cotangent<bf16>(P, I, n, row, l, ga + r * P0, gp);
        }
      }
      if (half) {
#pragma unroll
        for (int k = 0; k < 3; ++k) rv[r * 4 + k] = gp[k];
      }
      wg_sync(1 + wg);
      if (!half && row < n) {
        float p[3];
        mms::load_pos(I.pos, n, row, p);
        const float cs = 1.f / (2.f * P.radius);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          // the PE Hessian term on adj (none in value mode)
          const float hess = I.value ? 0.f
                                     : I.g3[row * 3 + k] * mms::pe_hess(I.adj + row * I.adj_width,
                                                                        p, P.pe_freqs,
                                                                        P.pe_scale, k);
          const float gs = gp[k] + rv[r * 4 + k];
          I.d_pos[row * 3 + k] = mms::pe_jt(ga + r * P0, p, P.pe_freqs, P.pe_scale, k) +
                                 (hess + gs * (mms::clip_gate(P, p[k]) * cs));
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
  for (int i = threadIdx.x; i < dlast; i += nwg * 128)
    if (csw[i] != 0.f) atomicAdd(&gw[G.gw_off[L - 1] + (long long)i * dout], csw[i]);
}

// Launch plan of the pass over n rows: the column sums of gb and of qin_{L-1} and the
// d pos terms in shared memory beside K1's backward layout.
static int slot_pass_plan(const Geom& G, int n, Launch* P) {
  const void* kernel = with_wc(
      G, [](auto WC) { return (const void*)slot_chain_pass_kernel<decltype(WC)::value>; });
  const int tiles = (n + 63) / 64;
  const size_t extra = ((size_t)((G.din_true[G.L - 1] + 3) & ~3) + MAXWG * 256) * 4;
  if (plan_chain(G, tiles, true, extra, P)) return ERR_SMEM;
  if (allow_smem(width_class(G), kernel) != cudaSuccess) return -1;
  if (persistent(kernel, P, (tiles + P->nwg - 1) / P->nwg) != cudaSuccess) return -1;
  return 0;
}

static bool slot_pass_ok(const Geom& G, const mms::SlotParams& P, const SlotBwdIo& I, int n) {
  return geom_ok(G) && n >= 1 && P.levels >= 1 && P.levels <= mms::MAXLV && P.feats >= 1 &&
         P.feats <= 16 && P.pe_freqs >= 1 && P.pe_freqs <= mms::MAXPE &&
         P.pw + P.levels * P.feats <= G.d_in && (I.value || I.adj_width >= G.d_in) &&
         I.geo_width < G.dout_true[G.L - 1] &&
         (I.split ? I.dcomp != nullptr : I.d_table != nullptr);
}

}  // namespace k1

// Bytes of the pass's device scratch (stacks and per-CTA slabs) for n rows.
extern "C" long long mms_slot_chain_pass_bytes(const k1::Geom* G, int n) {
  if (!k1::geom_ok(*G) || n < 1) return -1;
  k1::Launch P;
  const int st = k1::slot_pass_plan(*G, n, &P);
  if (st) return st;
  size_t s[5];
  k1::slot_scratch_sizes(*G, (n + 63) / 64, P.grid * P.nwg, P.act_bytes, s);
  return (long long)(s[0] + s[1] + s[2] + s[3] + s[4]);
}

// The pass: d_pos, and d_table (merged, accumulated) or dcomp (split); gb and the last
// layer's column term of gW accumulated; the stacks of (n + 63) / 64 row tiles at the
// start of scratch for mms_k1_wgrad. G: the chain's layout (fused_mlp.py chain_layout
// with two stack tiles per row tile below the last layer); P: the grid and the encoding
// (slot.cuh); wfw, wbw: what mms_k1_pack wrote for the chain.
extern "C" int mms_slot_chain_pass(const k1::Geom* G, const mms::SlotParams* P,
                                   const k1::SlotBwdIo* I, int n, const void* wfw,
                                   const void* wbw, void* gw, void* gb, void* scratch,
                                   void* stream) {
  if (!k1::slot_pass_ok(*G, *P, *I, n)) return -1;
  k1::Launch L;
  const int st = k1::slot_pass_plan(*G, n, &L);
  if (st) return st;
  size_t s[5];
  k1::slot_scratch_sizes(*G, (n + 63) / 64, L.grid * L.nwg, L.act_bytes, s);
  uint8_t* p = (uint8_t*)scratch;
  const k1::SlotScratch S{(k1::bf16*)p, (k1::bf16*)(p + s[0]), (uint32_t*)(p + s[0] + s[1]),
                          (float*)(p + s[0] + s[1] + s[2]),
                          s[4] ? (k1::bf16*)(p + s[0] + s[1] + s[2] + s[3]) : nullptr};
  k1::with_wc(*G, [&](auto WC) {
    k1::slot_chain_pass_kernel<decltype(WC)::value>
        <<<L.grid, L.threads, L.smem, (cudaStream_t)stream>>>(
            *G, *P, *I, n, (const k1::bf16*)wfw, (const k1::bf16*)wbw, (float*)gw, (float*)gb,
            S, L.nwg, L.stages, L.sb, L.act_bytes);
    return 0;
  });
  return (int)cudaGetLastError();
}
