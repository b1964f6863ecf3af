// K2's backward kernel (the slot-grid SDF value chain) for Hopper, shared by the merged
// backward (slot_fused_bwd.cu, SPLIT = false) and the per-sample pass of the split
// backward (slot_split.cu, SPLIT = true). K3's backward, merged and split, is a pass on
// K1's blocks of its own (slot_chain_bwd.cu).
//
// Merged, it replaces the Pallas TPU kernel multimodalstudio_tpu/ops/pallas/slot_fused.py
// _value_bwd_kernel (:1370), via op_bwd (:1737): first-order backward of sdf, returning
// d pos [N, 3] f32, d table [rows, 128] f32 and the chain's gW / gb f32 (packed). Split,
// it replaces _value_bwd_sample_kernel (:1485, K2s): the same per-sample math without the
// gW / gb / table atomics, writing instead the gz stack the weight-gradient products
// contract and each (sample, level)'s table cotangent, compact as [N, K, 8F] in the
// entry's layout (the TPU's lane-padded [N, K * 128] serves its one-hot MXU scatter only).
// The scatter into the table is a kernel of its own (slot_split.cu).
//
// It takes the residuals the training-mode forward wrote (slot_value.cu). A CTA owns 64
// samples. It rebuilds the tile's chain input and reads its cell entries again (the table
// stays in L2; the reference instead saved the gathered rows; an f32 tile reads them from
// L2 where it uses them, slot.cuh), loads the residuals into shared memory and runs the
// sweep on the tensor cores (chain.cuh). Merged, the TPU kernel's one-hot MXU scatter
// becomes one f32 atomic per (sample, level, feature, corner) into the table gradient,
// and the cross-tile sums of gW and gb are atomics too, so the order of those sums
// changes from run to run.
//
// Cast points follow the reference: gz rounded to bf16 before both products; gb sums the
// f32 gz (merged); the split's stack holds bf16(gz_l). On the grid side a bf16 table
// rounds to bf16 (slot.cuh grid_round): each sample's table cotangent before the f32 sum,
// the trilerp weight cotangent's products d_w = sum_f bf16(T * gt0) and gt0; an f32 table
// (K2f) keeps them f32, and its split pass writes the table cotangent f32
// (slot_fused.py:1652). A skip layer (bit l of the chain's skip mask) takes
// bf16(concat(h, x0) / sqrt 2); its input cotangent's x0 part, scaled, joins the chain
// input's cotangent.
//
// Bound on an H100: merged, per sample the chain's products three times on the tensor
// cores against the residual bytes; the tensor cores bound it at the flagship widths, and
// this first design adds the atomics. Split, only the products of d pos remain and the
// stack it writes makes it bound by bytes.
#pragma once

#include "slot.cuh"

namespace mms {

#define SLOT_COMMON_PARAMS                                                                     \
  const void *pos, int n, const void *table, const void *lmask, const void *wpack,           \
      const void *bpack, int n_layers, const int *in_dims, const int *out_dims, int hidden,  \
      int p0, int act, float quad_a, int levels, int feats, int pk_shift, const int *res,    \
      const int *dense, const int *ent_mask, const int *row_off, float radius, float clip_hi, \
      int smooth, int pe_freqs, const float *pe_scale, int skip_mask, int table_f32

// The split pass's outputs (null in the merged backward): each (sample, level)'s table
// cotangent [N, K, 8F] (bf16, or f32 for an f32 table) and the gz stack [L-1, N, H].
struct SplitOut {
  void* dcomp;
  bf16* gzs;
};

// rows [L-1, N, H] of a residual stack into shared [L-1][64, ldz] (zero past n)
__device__ __forceinline__ void load_stack(const bf16* src, int n, long long row0, int layers,
                                           int H, bf16* dst, int ldz) {
  for (int i = threadIdx.x; i < layers * TILE_M * H; i += NTHREADS) {
    const int l = i / (TILE_M * H), r = (i / H) % TILE_M, c = i % H;
    dst[(l * TILE_M + r) * ldz + c] =
        row0 + r < n ? src[((long long)l * n + row0 + r) * H + c] : __float2bfloat16(0.f);
  }
}

// row r (< 64) of layer l of the tile's [L-1, N, H] output stack
__device__ __forceinline__ bf16* stack_row(bf16* stack, int n, long long row0, int l, int H,
                                           int r) {
  return stack + ((long long)l * n + row0 + r) * H;
}

// The tile's residual stacks: after the shared buffers (smem_next), or in this CTA's slab
// of device scratch when they do not fit in shared memory (then the grid is persistent and
// each CTA walks tiles blockIdx.x, blockIdx.x + gridDim.x, ...).
__device__ __forceinline__ bf16* stack_base(bf16* scratch, long long slab, bf16* smem_next) {
  return scratch ? scratch + blockIdx.x * slab : smem_next;
}

// hin_l = bf16(act(z_{l-1})) into Hb [64, lds]; for a skip layer bf16(concat(that, x0) /
// sqrt 2), x0 read from X [64, ldx]
__device__ __forceinline__ void hidden_input(const Chain& C, const bf16* zp, int ldz, bf16* Hb,
                                             int lds, bool skip, const bf16* X, int ldx) {
  for (int i = threadIdx.x; i < TILE_M * C.hidden; i += NTHREADS) {
    const int r = i / C.hidden, c = i % C.hidden;
    float h = act_f(C.act, bf(zp[r * ldz + c]), C.quad_a);
    if (skip) h = round_bf16(h) * SKIP_SCALE;
    Hb[r * lds + c] = __float2bfloat16(h);
  }
  if (skip) {
    for (int i = threadIdx.x; i < TILE_M * C.p0; i += NTHREADS) {
      const int r = i / C.p0, c = i % C.p0;
      Hb[r * lds + C.hidden + c] = __float2bfloat16(bf(X[r * ldx + c]) * SKIP_SCALE);
    }
  }
}

// The reverse sweep from G (the last layer's cotangent, bf16 [64, lds], `last_cols`
// columns live): for l = L-1 .. 0, gh = G W_l^T, a skip layer's gh split into its h part
// (times 1/sqrt 2) and its x0 part (times 1/sqrt 2, added to sGh); for l > 0 gz_{l-1} = gh *
// act'(z_{l-1}) into the next G. Merged, also gW_l += hin_l^T G
// (hin_0 is X) and gb_{l-1} += the column sums of the f32 gz_{l-1}; split, bf16(gz_{l-1})
// goes to row row0 + r of layer l-1 of the gz stack gzs. Leaves the chain input's
// cotangent (f32) in sGh [64, p0].
template <bool SPLIT>
__device__ __forceinline__ void reverse_sweep(const Chain& C, const bf16* wpack, bf16* G,
                                              bf16* Hb, int lds, const bf16* X, int ldx,
                                              const bf16* zs, int ldz,
                                              int last_cols, float* sGh, float* gw, float* gb,
                                              bf16* gzs, int n, long long row0, float* stage) {
  const int lane = threadIdx.x & 31, p0 = C.p0;
  for (int i = threadIdx.x; i < TILE_M * p0; i += NTHREADS) sGh[i] = 0.f;
  for (int l = C.n_layers - 1; l >= 0; --l) {
    const int din = C.in_dims[l];
    const bool sk = (C.skip_mask >> l) & 1;
    const int hw = sk ? din - p0 : din;
    const int dcols = l == C.n_layers - 1 ? last_cols : C.out_dims[l];
    if (!SPLIT) {
      const bf16* hin = X;
      int ldh = ldx;
      if (l > 0) {
        hidden_input(C, zs + (long long)(l - 1) * TILE_M * ldz, ldz, Hb, lds, sk, X, ldx);
        hin = Hb;
        ldh = lds;
      }
      __syncthreads();
      mma_atb64_atomic(hin, ldh, din, G, lds, dcols, gw + C.w_off[l], C.out_dims[l], stage);
    }
    __syncthreads();  // G complete (the caller's last layer cotangent, or the previous gz)
    if (l > 0) {
      const bf16* zp = zs + (long long)(l - 1) * TILE_M * ldz;
      float* gbl = SPLIT ? nullptr : gb + C.b_off[l - 1];
      ColSum cols;
      mma_tile64<true>(G, lds, dcols, wpack + C.w_off[l], C.out_dims[l], din, stage,
                       [&](int r0, int c0, const float* t) {
                         float part = 0.f;
                         for (int i = lane; i < 256; i += 32) {
                           const int r = r0 + (i >> 4), c = c0 + (i & 15);
                           if (c >= hw) {
                             sGh[r * p0 + c - hw] += t[i] * SKIP_SCALE;
                             continue;
                           }
                           const float g = sk ? t[i] * SKIP_SCALE : t[i];
                           const float gz = g * act_df(C.act, bf(zp[r * ldz + c]), C.quad_a);
                           const bf16 gzb = __float2bfloat16(gz);
                           Hb[r * lds + c] = gzb;
                           if (SPLIT && row0 + r < n)
                             stack_row(gzs, n, row0, l - 1, C.hidden, r)[c] = gzb;
                           part += gz;
                         }
                         if (!SPLIT && c0 < hw) cols.add(part, r0, c0, gbl);
                       });
    } else {
      mma_tile64<true>(G, lds, dcols, wpack + C.w_off[0], C.out_dims[0], din, stage,
                       [&](int r0, int c0, const float* t) {
                         for (int i = lane; i < 256; i += 32)
                           sGh[(r0 + (i >> 4)) * p0 + c0 + (i & 15)] += t[i];
                       });
    }
    __syncthreads();
    bf16* tmp = G;
    G = Hb;
    Hb = tmp;
  }
}

// The table cotangent v of one (sample, level, feature, corner): merged, added into the
// entry's value of d_table (f32 atomics; zeros skipped); split, stored in the table's type
// at the same place of the sample's compact [K, 8F] row.
template <bool SPLIT, class TT>
__device__ __forceinline__ void table_cotangent(float* dt, TT* dc, int q, float v) {
  if (SPLIT) store_as(dc + q, v);
  else if (v != 0.f) atomicAdd(dt + q, v);
}

// ------------------------------------------------------------------ K2 backward

template <class TT, bool SPLIT>
__global__ void __launch_bounds__(NTHREADS)
slot_value_bwd_kernel(const float* __restrict__ pos, int n, const TT* __restrict__ table,
                      const float* __restrict__ lmask, const bf16* __restrict__ wpack, Chain C,
                      SlotParams P, int lds, int ldz, int ldx, const bf16* __restrict__ zs_in,
                      const float* __restrict__ gsdf, float* __restrict__ d_pos,
                      float* __restrict__ d_table, float* __restrict__ gw,
                      float* __restrict__ gb, SplitOut so, bf16* __restrict__ scratch,
                      long long slab) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ew = 8 * P.feats, L = C.n_layers, K = P.levels, p0 = C.p0, F = P.feats;
  bf16* buf0 = reinterpret_cast<bf16*>(smem);
  bf16* buf1 = buf0 + TILE_M * lds;
  bf16* X = buf1 + TILE_M * lds;                               // x0 [64, ldx]
  bf16* zs = stack_base(scratch, slab, X + TILE_M * ldx);      // (L-1) x [64, ldz]
  bf16* sT = scratch ? X + TILE_M * ldx : zs + (long long)(L - 1) * TILE_M * ldz;  // bf16: [64, K, 8F]
  float* sGh = reinterpret_cast<float*>(sT + (kStaged<TT> ? TILE_M * K * ew : 0));  // [64, p0]
  float* sGp = sGh + TILE_M * p0;                              // [64, K, 3]
  float* stage = sGp + TILE_M * K * 3;

  for (long long row0 = (long long)blockIdx.x * TILE_M; row0 < n;
       row0 += (long long)gridDim.x * TILE_M) {
    slot_front<TT>(P, p0, pos, n, row0, table, lmask, buf0, lds, sT);
    for (int i = threadIdx.x; i < TILE_M * p0; i += NTHREADS)
      X[(i / p0) * ldx + i % p0] = buf0[(i / p0) * lds + i % p0];
    load_stack(zs_in, n, row0, L - 1, C.hidden, zs, ldz);
    __syncthreads();
    // last layer's cotangent: column 0 = bf16(gsdf); merged, gb_{L-1}[0] += sum(gsdf) in f32
    for (int i = threadIdx.x; i < TILE_M * 16; i += NTHREADS) {
      const int r = i / 16, c = i % 16;
      buf0[r * lds + c] = __float2bfloat16(c == 0 && row0 + r < n ? gsdf[row0 + r] : 0.f);
    }
    if (!SPLIT && threadIdx.x < 32) {
      float s = 0.f;
      for (int r = threadIdx.x; r < TILE_M; r += 32) s += row0 + r < n ? gsdf[row0 + r] : 0.f;
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (threadIdx.x == 0 && s != 0.f) atomicAdd(gb + C.b_off[L - 1], s);
    }
    reverse_sweep<SPLIT>(C, wpack, buf0, buf1, lds, X, ldx, zs, ldz, 16, sGh, gw, gb,
                         so.gzs, n, row0, stage);

    // grid slice -> the table cotangent, and the trilerp weight cotangent's fold into d pos
    for (int i = threadIdx.x; i < TILE_M * K; i += NTHREADS) {
      const int r = i / K, l = i % K;
      float gp[3] = {0.f, 0.f, 0.f};
      if (row0 + r < n) {
        float p[3], wa[3][2], dwa[3][2], ddwa[3][2];
        load_pos(pos, n, row0 + r, p);
        const unsigned e = cell_geom(P, l, p, wa, dwa, ddwa);
        const TT* T = entry_values<TT>(P, table, sT, r, l, e);
        float gt0[16];
        for (int f = 0; f < F; ++f)
          gt0[f] = grid_round<TT>(sGh[r * p0 + P.pw + l * F + f] * lmask[l * F + f]);
        float* dt = SPLIT ? nullptr : d_table + entry_offset(P, l, e);
        TT* dc = SPLIT ? static_cast<TT*>(so.dcomp) + ((row0 + r) * K + l) * ew : nullptr;
        for (int c = 0; c < 8; ++c) {
          const float wb = corner_weight<TT>(wa, c);
          float dw = 0.f;
          for (int f = 0; f < F; ++f) {
            table_cotangent<SPLIT>(dt, dc, f * 8 + c, grid_round<TT>(gt0[f] * wb));
            dw += grid_round<TT>(tval(T[f * 8 + c]) * gt0[f]);
          }
#pragma unroll
          for (int t = 0; t < 3; ++t) gp[t] += dw * corner_axis_factor(wa, dwa, c, t);
        }
      }
#pragma unroll
      for (int t = 0; t < 3; ++t) sGp[(r * K + l) * 3 + t] = gp[t];
    }
    __syncthreads();
    if (threadIdx.x < TILE_M && row0 + threadIdx.x < n) {
      const int r = threadIdx.x;
      float p[3];
      load_pos(pos, n, row0 + r, p);
      const float cs = 1.f / (2.f * P.radius);
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        float s = 0.f;
        for (int l = 0; l < K; ++l) s += sGp[(r * K + l) * 3 + t];
        d_pos[(row0 + r) * 3 + t] =
            pe_jt(sGh + r * p0, p, P.pe_freqs, P.pe_scale, t) + s * (clip_gate(P, p[t]) * cs);
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------ launchers

inline int bwd_setup(Chain& C, SlotParams& P, int& lds, int& ldz, int& ldx, int n_layers,
                     const int* in_dims, const int* out_dims, int hidden, int p0, int act,
                     float quad_a, int levels, int feats, int pk_shift, const int* res,
                     const int* dense, const int* ent_mask, const int* row_off, float radius,
                     float clip_hi, int smooth, int pe_freqs, const float* pe_scale,
                     int skip_mask) {
  if (fill_chain(C, n_layers, in_dims, out_dims, skip_mask, hidden, p0, act, quad_a) ||
      n_layers < 2 || (skip_mask & 1))
    return -1;
  if (fill_slot_params(P, levels, feats, pk_shift, res, dense, ent_mask, row_off, radius,
                       clip_hi, smooth, pe_freqs, pe_scale) || pe_freqs < 1)
    return -1;
  int width = p0 > hidden ? p0 : hidden;
  if (out_dims[n_layers - 1] > width) width = out_dims[n_layers - 1];
  if (skip_mask && hidden + p0 > width) width = hidden + p0;
  lds = width + PAD;
  ldz = hidden + PAD;
  ldx = p0 + PAD;
  return 0;
}

// Shared memory of a backward tile without its residual stack, and the stack's bytes
// (L-1 layers), which goes to device scratch when both do not fit.
inline void bwd_smem(int n_layers, int lds, int ldz, int ldx, int p0, int levels, int feats,
                     int table_f32, size_t& smem, size_t& stack) {
  smem = 2 * (size_t)TILE_M * lds * sizeof(bf16) + (size_t)TILE_M * ldx * sizeof(bf16) +
         staged_bytes(levels, feats, table_f32) + (size_t)TILE_M * p0 * sizeof(float) +
         (size_t)TILE_M * levels * 3 * sizeof(float) + NWARPS * 256 * sizeof(float);
  stack = (size_t)(n_layers - 1) * TILE_M * ldz * sizeof(bf16);
}

// bf16 elements of device scratch per CTA the backward needs for its residual stack: 0
// when it fits in shared memory beside the tile's buffers.
extern "C" long long mms_slot_bwd_slab(int n_layers, int hidden, int p0, int levels, int feats,
                                       int d_out, int skips, int table_f32) {
  int width = (p0 > hidden ? p0 : hidden) > d_out ? (p0 > hidden ? p0 : hidden) : d_out;
  if (skips && hidden + p0 > width) width = hidden + p0;
  size_t smem, stack;
  bwd_smem(n_layers, width + PAD, hidden + PAD, p0 + PAD, p0, levels, feats, table_f32, smem,
           stack);
  return smem + stack <= MAX_SMEM ? 0 : (long long)stack / (long long)sizeof(bf16);
}

// The launch of one backward kernel: the stacks in shared memory (scratch null) or in
// max_ctas slabs of scratch with a persistent grid.
template <class Kernel, class... Args>
inline int launch_bwd(Kernel kernel, int table_f32, const Chain& C, int n, int lds, int ldz,
                      int ldx, const SlotParams& P, void* scratch, int max_ctas, void* stream,
                      Args... args) {
  if (scratch && max_ctas < 1) return -1;
  size_t smem, stack;
  bwd_smem(C.n_layers, lds, ldz, ldx, C.p0, P.levels, P.feats, table_f32, smem, stack);
  if (!scratch) smem += stack;
  if (smem > MAX_SMEM) return ERR_SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int grid = (n + TILE_M - 1) / TILE_M;
  if (scratch) {
    err = persistent_grid((const void*)kernel, smem, n, max_ctas, &grid);
    if (err != cudaSuccess) return (int)err;
  }
  const long long slab = (long long)stack / (long long)sizeof(bf16);
  kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(args..., (bf16*)scratch, slab);
  return (int)cudaGetLastError();
}

template <class TT, bool SPLIT>
inline int launch_value_bwd_t(const Chain& C, const SlotParams& P, int lds, int ldz, int ldx,
                              const void* pos, int n, const void* table, const void* lmask,
                              const void* wpack, const void* zs, const void* gsdf, void* d_pos,
                              void* d_table, void* gw, void* gb, SplitOut so, void* scratch,
                              int max_ctas, void* stream) {
  return launch_bwd(slot_value_bwd_kernel<TT, SPLIT>, !kStaged<TT>, C, n, lds, ldz, ldx, P,
                    scratch, max_ctas, stream, (const float*)pos, n, (const TT*)table,
                    (const float*)lmask, (const bf16*)wpack, C, P, lds, ldz, ldx,
                    (const bf16*)zs, (const float*)gsdf, (float*)d_pos, (float*)d_table,
                    (float*)gw, (float*)gb, so);
}

template <bool SPLIT>
inline int launch_value_bwd(SLOT_COMMON_PARAMS, const void* zs, const void* gsdf, void* d_pos,
                            void* d_table, void* gw, void* gb, SplitOut so, void* scratch,
                            int max_ctas, void* stream) {
  (void)bpack;
  Chain C;
  SlotParams P;
  int lds, ldz, ldx;
  if (bwd_setup(C, P, lds, ldz, ldx, n_layers, in_dims, out_dims, hidden, p0, act, quad_a,
                levels, feats, pk_shift, res, dense, ent_mask, row_off, radius, clip_hi, smooth,
                pe_freqs, pe_scale, skip_mask))
    return -1;
  if (table_f32)
    return launch_value_bwd_t<float, SPLIT>(C, P, lds, ldz, ldx, pos, n, table, lmask, wpack, zs,
                                            gsdf, d_pos, d_table, gw, gb, so, scratch, max_ctas,
                                            stream);
  return launch_value_bwd_t<bf16, SPLIT>(C, P, lds, ldz, ldx, pos, n, table, lmask, wpack, zs,
                                         gsdf, d_pos, d_table, gw, gb, so, scratch, max_ctas,
                                         stream);
}

}  // namespace mms
