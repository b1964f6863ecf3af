// Fused slot-grid + NeRF encoding + MLP chain SDF forward with its gradient for Hopper
// (the first design; K2, the value-only forward, runs on K1's wgmma forward in
// slot_value.cu).
//
// Replaces the Pallas TPU kernel of multimodalstudio_tpu/ops/pallas/slot_fused.py
//   K3 _fused_fwd_kernel (:353), reached through fused_slot_sdf_chain (:1197): sdf, the
//      geometric features and d sdf / d x from one reverse (adjoint) sweep of the chain.
//
// A CTA owns 64 samples. Per (sample, level) one thread computes the cell geometry from
// the raw position (clip, floor, dense index or uint32 XOR hash, smoothstep trilerp
// weights) and reads the cell's packed entry, 8F bf16 values, as one contiguous 32-byte
// load (F = 2), or with an f32 table its 8F f32 values where they are used (512 bytes at
// F = 16, slot.cuh). The TPU kernel's one-hot MXU gather, hi/lo split and lane padding are
// TPU mechanisms; here the entry is read directly. The encoded row goes to shared memory as
// bf16 and the chain runs on the tensor cores (chain.cuh, slot.cuh).
//
// Cast points follow the JAX kernel: with a bf16 table, table and trilerp weight rounded
// to bf16, their product rounded to bf16 before the 8-corner f32 sum, the sum times the
// coarse-to-fine mask rounded to bf16 into the chain input; with an f32 table (K3f, the
// same Pallas body with SlotGeom.bf16 False) the grid side stays f32 up to that last
// rounding (slot.cuh); the NeRF encoding uses sinf / cosf (no fast math); a skip layer's
// input is concat(h, x0) / sqrt(2) rounded to bf16 (slot_fused.py:423, 642), its adjoint
// sweep row split into the h part and the x0 part added to adj; the last layer stays f32
// (sdf) and geo is rounded to bf16; the adjoint sweep evaluates act' on the bf16-stored
// pre-activations.
//
// Training mode (the forward of the autograd Function) also writes what the backward
// kernels (slot_fused_bwd.cu) read, as the reference's forward does (slot_fused.py:
// 1092-1094): the bf16 pre-activations zs [L-1, N, H], the bf16 adjoint-sweep rows ss
// [L-1, N, H] and the f32 adjoint adj [N, d_in]. For the split backward it also writes
// the chain input x0 [N, p0] bf16 (slot_fused.py:1028-1032), which the weight-gradient
// products read.
//
// Bound on an H100: the chain's tensor-core work (2 * N * sum(din * dout) flops) against
// N * (12 + 4 [+ 2 * 256 + 12]) bytes of positions and outputs plus the table: the tensor
// cores bound it. The table (3072 x 128 bf16, 768 KB; or 3072 x 128 f32, 1.57 MB) stays in
// L2. An f32 tile stages no entries (slot.cuh): the trilerp and the gradient path read each
// (sample, level)'s 8F f32 values from L2 where they use them.
#include "slot.cuh"

using namespace mms;

template <class TT>
__global__ void __launch_bounds__(NTHREADS)
slot_sdf_kernel(const float* __restrict__ pos, int n, const TT* __restrict__ table,
                const float* __restrict__ lmask, const bf16* __restrict__ wpack,
                const float* __restrict__ bpack, Chain C, SlotParams P, int lds, int ldz, int ldx,
                float* __restrict__ sdf, bf16* __restrict__ geo, int geo_width,
                float* __restrict__ grad, bf16* __restrict__ zs_out, bf16* __restrict__ ss_out,
                float* __restrict__ adj_out, int adj_width, bf16* __restrict__ x0_out,
                bf16* __restrict__ scratch, long long slab) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = C.n_layers, p0 = C.p0;
  const bool skips = C.skip_mask != 0;
  bf16* buf0 = reinterpret_cast<bf16*>(smem);
  bf16* buf1 = buf0 + TILE_M * lds;
  bf16* X = buf1 + TILE_M * lds;  // skip chains: x0 [64, ldx], read again by the skip layers
  bf16* after_x = X + (skips ? TILE_M * ldx : 0);
  // the z stack (L-1) x [64, ldz] after the tile's buffers, or in this CTA's slab of
  // device scratch when it does not fit in shared memory (then the grid is persistent)
  bf16* zs = scratch ? scratch + blockIdx.x * slab : after_x;
  bf16* sT = scratch ? after_x : zs + (L - 1) * TILE_M * ldz;  // bf16: [64, K, 8F]
  float* sAdj = reinterpret_cast<float*>(sT + (kStaged<TT> ? TILE_M * P.levels * 8 * P.feats : 0));
  float* stage = sAdj + TILE_M * p0;  // sAdj: [64, p0]
  const int lane = threadIdx.x & 31;
  const int H = C.hidden;

  for (long long row0 = (long long)blockIdx.x * TILE_M; row0 < n;
       row0 += (long long)gridDim.x * TILE_M) {
    slot_front<TT>(P, p0, pos, n, row0, table, lmask, buf0, lds, sT);
    if (x0_out || skips) {
      for (int i = threadIdx.x; i < TILE_M * p0; i += NTHREADS) {
        const int r = i / p0, c = i % p0;
        if (skips) X[r * ldx + c] = buf0[r * lds + c];
        if (x0_out && row0 + r < n) x0_out[(row0 + r) * p0 + c] = buf0[r * lds + c];
      }
      __syncthreads();
    }
    const bf16* h = run_hidden_layers(C, wpack, bpack, buf0, buf1, lds, skips ? X : buf0,
                                      skips ? ldx : lds, zs, ldz, stage);
    if (zs_out) {
      for (int i = threadIdx.x; i < (L - 1) * TILE_M * H; i += NTHREADS) {
        const int l = i / (TILE_M * H), r = (i / H) % TILE_M, c = i % H;
        if (row0 + r < n) zs_out[((long long)l * n + row0 + r) * H + c] = zs[(l * TILE_M + r) * ldz + c];
      }
    }
    const float* BL = bpack + C.b_off[L - 1];
    // sdf is column 0 in f32
    mma_tile64<false>(h, lds, C.in_dims[L - 1], wpack + C.w_off[L - 1], C.out_dims[L - 1],
                      C.out_dims[L - 1], stage, [&](int r0, int c0, const float* t) {
                        for (int i = lane; i < 256; i += 32) {
                          const int r = r0 + (i >> 4), c = c0 + (i & 15);
                          if (row0 + r >= n) continue;
                          const float z = t[i] + BL[c];
                          if (c == 0) sdf[row0 + r] = z;
                          else if (c <= geo_width)
                            geo[(row0 + r) * geo_width + c - 1] = __float2bfloat16(z);
                        }
                      });
    __syncthreads();

    // adjoint sweep (fused_mlp.py:327-359): v = e_0; s = bf16(v) W_l^T; a skip layer's s
    // splits into its h part (scaled by 1/sqrt 2) and its x0 part (scaled, added to adj);
    // v = s * act'(z_{l-1}); training mode keeps the h part of s of layers l >= 1 as ss[l-1]
    // (bf16); adj = the x0 parts plus s of layer 0, accumulated in sAdj
    bf16* va = buf0;
    bf16* vb = buf1;
    for (int i = threadIdx.x; i < TILE_M * C.out_dims[L - 1]; i += NTHREADS) {
      const int r = i / C.out_dims[L - 1], c = i % C.out_dims[L - 1];
      va[r * lds + c] = __float2bfloat16(c == 0 ? 1.f : 0.f);
    }
    for (int i = threadIdx.x; i < TILE_M * p0; i += NTHREADS) sAdj[i] = 0.f;
    __syncthreads();
    for (int l = L - 1; l >= 1; --l) {
      const bool sk = (C.skip_mask >> l) & 1;
      const int hw = sk ? C.in_dims[l] - p0 : C.in_dims[l];
      const bf16* zl = zs + (long long)(l - 1) * TILE_M * ldz;
      mma_tile64<true>(va, lds, C.out_dims[l], wpack + C.w_off[l], C.out_dims[l], C.in_dims[l],
                       stage, [&](int r0, int c0, const float* t) {
                         for (int i = lane; i < 256; i += 32) {
                           const int r = r0 + (i >> 4), c = c0 + (i & 15);
                           if (c >= hw) {
                             sAdj[r * p0 + c - hw] += t[i] * SKIP_SCALE;
                             continue;
                           }
                           const float s = sk ? t[i] * SKIP_SCALE : t[i];
                           const float z = bf(zl[r * ldz + c]);
                           vb[r * lds + c] = __float2bfloat16(s * act_df(C.act, z, C.quad_a));
                           if (ss_out && row0 + r < n)
                             ss_out[((long long)(l - 1) * n + row0 + r) * H + c] = __float2bfloat16(s);
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
    if (adj_out) {
      for (int i = threadIdx.x; i < TILE_M * adj_width; i += NTHREADS) {
        const int r = i / adj_width, c = i % adj_width;
        if (row0 + r < n) adj_out[(row0 + r) * adj_width + c] = sAdj[r * p0 + c];
      }
    }

    // d sdf / d x = J_enc^T adj[:, :pw] + sum comp * r(dw_k) * r(adj_grid * mask), r the
    // table type's rounding (grid_round)
    if (threadIdx.x < TILE_M && row0 + threadIdx.x < n) {
      const int r = threadIdx.x;
      const float* a = sAdj + r * p0;
      float p[3];
      load_pos(pos, n, row0 + r, p);
      float g[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) g[k] = pe_jt(a, p, P.pe_freqs, P.pe_scale, k);
      const float cs = 1.f / (2.f * P.radius);
      float gg[3] = {0.f, 0.f, 0.f};
      for (int l = 0; l < P.levels; ++l) {
        float wa[3][2], dwa[3][2], ddwa[3][2];
        const unsigned e = cell_geom(P, l, p, wa, dwa, ddwa);
        const TT* T = entry_values<TT>(P, table, sT, r, l, e);
        float A[16];
        for (int f = 0; f < P.feats; ++f)
          A[f] = grid_round<TT>(a[P.pw + l * P.feats + f] * lmask[l * P.feats + f]);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float d[3];
#pragma unroll
          for (int t = 0; t < 3; ++t) d[t] = grid_round<TT>(corner_axis_factor(wa, dwa, c, t) * cs);
          for (int f = 0; f < P.feats; ++f) {
            const float tv = tval(T[f * 8 + c]);
#pragma unroll
            for (int t = 0; t < 3; ++t) gg[t] += tv * d[t] * A[f];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) grad[(row0 + r) * 3 + k] = g[k] + gg[k];
    }
    __syncthreads();
  }
}

// Row strides and shared memory of the forward: the tile's buffers (smem) and the z
// stack's bytes (stack), which go to device scratch if smem + stack exceeds MAX_SMEM. A
// skip chain's activation rows hold [h | x0] and it keeps x0 apart.
static void fwd_geometry(int n_layers, int hidden, int p0, int levels, int feats, int d_out,
                         int skips, int table_f32, int& lds, int& ldz, int& ldx, size_t& smem,
                         size_t& stack) {
  int width = p0 > hidden ? p0 : hidden;
  if (d_out > width) width = d_out;
  if (skips && hidden + p0 > width) width = hidden + p0;
  lds = width + PAD;
  ldz = hidden + PAD;
  ldx = p0 + PAD;
  smem = 2 * (size_t)TILE_M * lds * sizeof(bf16) + staged_bytes(levels, feats, table_f32) +
         NWARPS * 256 * sizeof(float);
  if (skips) smem += (size_t)TILE_M * ldx * sizeof(bf16);
  smem += (size_t)TILE_M * p0 * sizeof(float);
  stack = (size_t)(n_layers - 1) * TILE_M * ldz * sizeof(bf16);
}

// bf16 elements of device scratch per CTA the forward needs for its z stack: 0 when the
// stack fits in shared memory beside the tile's buffers.
extern "C" long long mms_slot_fwd_slab(int n_layers, int hidden, int p0, int levels, int feats,
                                       int d_out, int skips, int table_f32) {
  int lds, ldz, ldx;
  size_t smem, stack;
  fwd_geometry(n_layers, hidden, p0, levels, feats, d_out, skips, table_f32, lds, ldz, ldx, smem,
               stack);
  return smem + stack <= MAX_SMEM ? 0 : (long long)stack / (long long)sizeof(bf16);
}

template <class TT>
static int launch_fwd(size_t smem, int n, int max_ctas, void* scratch, void* stream,
                      const void* pos, const void* table, const void* lmask, const void* wpack,
                      const void* bpack, const Chain& C, const SlotParams& P, int lds, int ldz,
                      int ldx, void* sdf, void* geo, int geo_width, void* grad, void* zs_out,
                      void* ss_out, void* adj_out, int adj_width, void* x0_out) {
  if (smem > MAX_SMEM) return ERR_SMEM;
  cudaError_t err = cudaFuncSetAttribute(slot_sdf_kernel<TT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int grid = (n + TILE_M - 1) / TILE_M;
  if (scratch) {
    err = persistent_grid((const void*)slot_sdf_kernel<TT>, smem, n, max_ctas, &grid);
    if (err != cudaSuccess) return (int)err;
  }
  const long long slab = (long long)(C.n_layers - 1) * TILE_M * ldz;
  slot_sdf_kernel<TT><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const float*)pos, n, (const TT*)table, (const float*)lmask, (const bf16*)wpack,
      (const float*)bpack, C, P, lds, ldz, ldx, (float*)sdf, (bf16*)geo, geo_width, (float*)grad,
      (bf16*)zs_out, (bf16*)ss_out, (float*)adj_out, adj_width, (bf16*)x0_out, (bf16*)scratch,
      slab);
  return (int)cudaGetLastError();
}

// scratch: null, or max_ctas slabs of mms_slot_fwd_slab elements for the z stack.
// skip_mask: bit l set for a skip layer l (never layer 0); table_f32: the table is f32
// [rows, 128] (K2f / K3f), else bf16.
extern "C" int mms_slot_sdf_fwd(const void* pos, int n, const void* table, const void* lmask,
                                const void* wpack, const void* bpack, int n_layers,
                                const int* in_dims, const int* out_dims, int hidden, int p0,
                                int act, float quad_a, int levels, int feats, int pk_shift,
                                const int* res, const int* dense, const int* ent_mask,
                                const int* row_off, float radius, float clip_hi, int smooth,
                                int pe_freqs, const float* pe_scale, int skip_mask, int table_f32,
                                void* sdf, void* geo, int geo_width, void* grad, void* zs_out,
                                void* ss_out, void* adj_out, int adj_width, void* x0_out,
                                void* scratch, int max_ctas, void* stream) {
  Chain C;
  if (fill_chain(C, n_layers, in_dims, out_dims, skip_mask, hidden, p0, act, quad_a) ||
      (skip_mask & 1))
    return -1;
  SlotParams P;
  if (fill_slot_params(P, levels, feats, pk_shift, res, dense, ent_mask, row_off, radius,
                       clip_hi, smooth, pe_freqs, pe_scale) || n_layers < 2 || pe_freqs < 1)
    return -1;
  if (scratch && max_ctas < 1) return -1;
  int lds, ldz, ldx;
  size_t smem, stack;
  fwd_geometry(n_layers, hidden, p0, levels, feats, out_dims[n_layers - 1], skip_mask != 0,
               table_f32, lds, ldz, ldx, smem, stack);
  if (!scratch) smem += stack;
  if (table_f32)
    return launch_fwd<float>(smem, n, max_ctas, scratch, stream, pos, table, lmask, wpack, bpack,
                             C, P, lds, ldz, ldx, sdf, geo, geo_width, grad, zs_out, ss_out,
                             adj_out, adj_width, x0_out);
  return launch_fwd<bf16>(smem, n, max_ctas, scratch, stream, pos, table, lmask, wpack, bpack, C,
                          P, lds, ldz, ldx, sdf, geo, geo_width, grad, zs_out, ss_out, adj_out,
                          adj_width, x0_out);
}
