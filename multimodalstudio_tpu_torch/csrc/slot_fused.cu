// Fused slot-grid + NeRF encoding + MLP chain SDF forward for Hopper.
//
// Replaces two Pallas TPU kernels of multimodalstudio_tpu/ops/pallas/slot_fused.py:
//   K2 _value_fwd_kernel (:1307), reached through fused_slot_sdf_value (:1772): sdf only;
//   K3 _fused_fwd_kernel (:353), reached through fused_slot_sdf_chain (:1197): sdf, the
//      geometric features and d sdf / d x from one reverse (adjoint) sweep of the chain.
//
// A CTA owns 64 samples. Per (sample, level) one thread computes the cell geometry from
// the raw position (clip, floor, dense index or uint32 XOR hash, smoothstep trilerp
// weights) and reads the cell's packed entry, 8F bf16 values, as one contiguous 32-byte
// load (F = 2). The TPU kernel's one-hot MXU gather, hi/lo split and lane padding are TPU
// mechanisms; here the entry is read directly. The encoded row goes to shared memory as
// bf16 and the chain runs on the tensor cores (chain.cuh, slot.cuh).
//
// Cast points follow the JAX kernel: table and trilerp weight rounded to bf16, their
// product rounded to bf16 before the 8-corner f32 sum, the sum times the coarse-to-fine
// mask rounded to bf16 into the chain input; the NeRF encoding uses sinf / cosf (no fast
// math); the last layer stays f32 (sdf) and geo is rounded to bf16; the adjoint sweep
// evaluates act' on the bf16-stored pre-activations.
//
// Training mode (the forward of the autograd Functions) also writes what the backward
// kernels (slot_fused_bwd.cu) read, as the reference's forward does (slot_fused.py:
// 1092-1094, 1622-1625): the bf16 pre-activations zs [L-1, N, H], and with the gradient
// the bf16 adjoint-sweep rows ss [L-1, N, H] and the f32 adjoint adj [N, d_in]. For the
// split backward it also writes the chain input x0 [N, p0] bf16 (slot_fused.py:1028-1032,
// 1626-1630), which the weight-gradient products read.
//
// Bound on an H100: the chain's tensor-core work (2 * N * sum(din * dout) flops) against
// N * (12 + 4 [+ 2 * 256 + 12]) bytes of positions and outputs plus the table: the tensor
// cores bound it. The table (3072 x 128 bf16, 768 KB) stays in L2.
#include "slot.cuh"

using namespace mms;

template <bool GRAD>
__global__ void __launch_bounds__(NTHREADS)
slot_sdf_kernel(const float* __restrict__ pos, int n, const bf16* __restrict__ table,
                const float* __restrict__ lmask, const bf16* __restrict__ wpack,
                const float* __restrict__ bpack, Chain C, SlotParams P, int lds, int ldz,
                float* __restrict__ sdf, bf16* __restrict__ geo, int geo_width,
                float* __restrict__ grad, bf16* __restrict__ zs_out, bf16* __restrict__ ss_out,
                float* __restrict__ adj_out, int adj_width, bf16* __restrict__ x0_out,
                bf16* __restrict__ scratch, long long slab) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ew = 8 * P.feats;  // bf16 values per entry
  const int L = C.n_layers;
  const bool keep_z = GRAD || zs_out != nullptr;
  bf16* buf0 = reinterpret_cast<bf16*>(smem);
  bf16* buf1 = buf0 + TILE_M * lds;
  // keep_z: the z stack (L-1) x [64, ldz] after buf1, or in this CTA's slab of device
  // scratch when it does not fit in shared memory (then the grid is persistent)
  bf16* zs = scratch ? scratch + blockIdx.x * slab : buf1 + TILE_M * lds;
  bf16* sT = scratch || !keep_z ? buf1 + TILE_M * lds : zs + (L - 1) * TILE_M * ldz;  // [64, K, 8F]
  float* sAdj = reinterpret_cast<float*>(sT + TILE_M * P.levels * ew);  // GRAD: [64, p0]
  float* stage = sAdj + (GRAD ? TILE_M * C.p0 : 0);
  const int lane = threadIdx.x & 31;
  const int H = C.hidden;

  for (long long row0 = (long long)blockIdx.x * TILE_M; row0 < n;
       row0 += (long long)gridDim.x * TILE_M) {
    slot_front(P, C.p0, pos, n, row0, table, lmask, buf0, lds, sT);
    if (x0_out) {
      for (int i = threadIdx.x; i < TILE_M * C.p0; i += NTHREADS) {
        const int r = i / C.p0, c = i % C.p0;
        if (row0 + r < n) x0_out[(row0 + r) * C.p0 + c] = buf0[r * lds + c];
      }
    }
    const bf16* h = run_hidden_layers(C, wpack, bpack, buf0, buf1, lds, buf0, lds,
                                      keep_z ? zs : nullptr, ldz, stage);
    if (zs_out) {
      for (int i = threadIdx.x; i < (L - 1) * TILE_M * H; i += NTHREADS) {
        const int l = i / (TILE_M * H), r = (i / H) % TILE_M, c = i % H;
        if (row0 + r < n) zs_out[((long long)l * n + row0 + r) * H + c] = zs[(l * TILE_M + r) * ldz + c];
      }
    }
    const float* BL = bpack + C.b_off[L - 1];
    // sdf is column 0 in f32; without GRAD only the first 16-column tile is computed
    mma_tile64<false>(h, lds, C.in_dims[L - 1], wpack + C.w_off[L - 1], C.out_dims[L - 1],
                      GRAD ? C.out_dims[L - 1] : 16, stage, [&](int r0, int c0, const float* t) {
                        for (int i = lane; i < 256; i += 32) {
                          const int r = r0 + (i >> 4), c = c0 + (i & 15);
                          if (row0 + r >= n) continue;
                          const float z = t[i] + BL[c];
                          if (c == 0) sdf[row0 + r] = z;
                          else if (GRAD && c <= geo_width)
                            geo[(row0 + r) * geo_width + c - 1] = __float2bfloat16(z);
                        }
                      });
    __syncthreads();
    if (!GRAD) continue;

    // adjoint sweep (fused_mlp.py:327-359): v = e_0; s = bf16(v) W_l^T; v = s * act'(z_{l-1});
    // training mode keeps s of layers l >= 1 as ss[l-1] (bf16) and adj = s of layer 0
    bf16* va = buf0;
    bf16* vb = buf1;
    for (int i = threadIdx.x; i < TILE_M * C.out_dims[L - 1]; i += NTHREADS) {
      const int r = i / C.out_dims[L - 1], c = i % C.out_dims[L - 1];
      va[r * lds + c] = __float2bfloat16(c == 0 ? 1.f : 0.f);
    }
    __syncthreads();
    for (int l = L - 1; l >= 1; --l) {
      const bf16* zl = zs + (long long)(l - 1) * TILE_M * ldz;
      mma_tile64<true>(va, lds, C.out_dims[l], wpack + C.w_off[l], C.out_dims[l], C.in_dims[l],
                       stage, [&](int r0, int c0, const float* t) {
                         for (int i = lane; i < 256; i += 32) {
                           const int r = r0 + (i >> 4), c = c0 + (i & 15);
                           const float z = bf(zl[r * ldz + c]);
                           vb[r * lds + c] = __float2bfloat16(t[i] * act_df(C.act, z, C.quad_a));
                           if (ss_out && row0 + r < n)
                             ss_out[((long long)(l - 1) * n + row0 + r) * H + c] = __float2bfloat16(t[i]);
                         }
                       });
      __syncthreads();
      bf16* tmp = va;
      va = vb;
      vb = tmp;
    }
    mma_tile64<true>(va, lds, C.out_dims[0], wpack + C.w_off[0], C.out_dims[0], C.p0, stage,
                     [&](int r0, int c0, const float* t) {
                       for (int i = lane; i < 256; i += 32) {
                         const int r = r0 + (i >> 4), c = c0 + (i & 15);
                         sAdj[r * C.p0 + c] = t[i];
                         if (adj_out && row0 + r < n && c < adj_width)
                           adj_out[(row0 + r) * adj_width + c] = t[i];
                       }
                     });
    __syncthreads();

    // d sdf / d x = J_enc^T adj[:, :pw] + sum comp * bf16(dw_k) * bf16(adj_grid * mask)
    if (threadIdx.x < TILE_M && row0 + threadIdx.x < n) {
      const int r = threadIdx.x;
      const float* a = sAdj + r * C.p0;
      float p[3];
      load_pos(pos, n, row0 + r, p);
      float g[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) g[k] = pe_jt(a, p, P.pe_freqs, P.pe_scale, k);
      const float cs = 1.f / (2.f * P.radius);
      float gg[3] = {0.f, 0.f, 0.f};
      for (int l = 0; l < P.levels; ++l) {
        float wa[3][2], dwa[3][2], ddwa[3][2];
        cell_geom(P, l, p, wa, dwa, ddwa);
        const bf16* T = sT + (r * P.levels + l) * ew;
        float A[16];
        for (int f = 0; f < P.feats; ++f)
          A[f] = round_bf16(a[P.pw + l * P.feats + f] * lmask[l * P.feats + f]);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float d[3];
#pragma unroll
          for (int t = 0; t < 3; ++t) d[t] = round_bf16(corner_axis_factor(wa, dwa, c, t) * cs);
          for (int f = 0; f < P.feats; ++f) {
            const float tv = bf(T[f * 8 + c]);
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

// Row strides and shared memory of the forward: the tile's buffers (smem) and, when the
// z stack is kept, the stack's bytes (stack), which go to device scratch if smem + stack
// exceeds MAX_SMEM.
static void fwd_geometry(int n_layers, int hidden, int p0, int levels, int feats, int d_out,
                         int with_grad, int keep_z, int& lds, int& ldz, size_t& smem,
                         size_t& stack) {
  int width = p0 > hidden ? p0 : hidden;
  if (with_grad && d_out > width) width = d_out;
  lds = width + PAD;
  ldz = hidden + PAD;
  smem = 2 * (size_t)TILE_M * lds * sizeof(bf16) +
         (size_t)TILE_M * levels * 8 * feats * sizeof(bf16) + NWARPS * 256 * sizeof(float);
  if (with_grad) smem += (size_t)TILE_M * p0 * sizeof(float);
  stack = keep_z ? (size_t)(n_layers - 1) * TILE_M * ldz * sizeof(bf16) : 0;
}

// bf16 elements of device scratch per CTA the forward needs for its z stack: 0 when the
// stack fits in shared memory beside the tile's buffers.
extern "C" long long mms_slot_fwd_slab(int n_layers, int hidden, int p0, int levels, int feats,
                                       int d_out, int with_grad, int keep_z) {
  int lds, ldz;
  size_t smem, stack;
  fwd_geometry(n_layers, hidden, p0, levels, feats, d_out, with_grad, keep_z, lds, ldz, smem,
               stack);
  return smem + stack <= MAX_SMEM ? 0 : (long long)stack / (long long)sizeof(bf16);
}

template <bool GRAD>
static int launch_fwd(size_t smem, int n, int max_ctas, void* scratch, void* stream,
                      const void* pos, const void* table, const void* lmask, const void* wpack,
                      const void* bpack, const Chain& C, const SlotParams& P, int lds, int ldz,
                      void* sdf, void* geo, int geo_width, void* grad, void* zs_out,
                      void* ss_out, void* adj_out, int adj_width, void* x0_out) {
  if (smem > MAX_SMEM) return ERR_SMEM;
  cudaError_t err = cudaFuncSetAttribute(slot_sdf_kernel<GRAD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int grid = (n + TILE_M - 1) / TILE_M;
  if (scratch) {
    err = persistent_grid((const void*)slot_sdf_kernel<GRAD>, smem, n, max_ctas, &grid);
    if (err != cudaSuccess) return (int)err;
  }
  const long long slab = (long long)(C.n_layers - 1) * TILE_M * ldz;
  slot_sdf_kernel<GRAD><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const float*)pos, n, (const bf16*)table, (const float*)lmask, (const bf16*)wpack,
      (const float*)bpack, C, P, lds, ldz, (float*)sdf, (bf16*)geo, geo_width, (float*)grad,
      (bf16*)zs_out, (bf16*)ss_out, (float*)adj_out, adj_width, (bf16*)x0_out, (bf16*)scratch,
      slab);
  return (int)cudaGetLastError();
}

// scratch: null, or max_ctas slabs of mms_slot_fwd_slab elements for the z stack.
extern "C" int mms_slot_sdf_fwd(const void* pos, int n, const void* table, const void* lmask,
                                const void* wpack, const void* bpack, int n_layers,
                                const int* in_dims, const int* out_dims, int hidden, int p0,
                                int act, float quad_a, int levels, int feats, int pk_shift,
                                const int* res, const int* dense, const int* ent_mask,
                                const int* row_off, float radius, float clip_hi, int smooth,
                                int pe_freqs, const float* pe_scale, void* sdf, void* geo,
                                int geo_width, void* grad, int with_grad, void* zs_out,
                                void* ss_out, void* adj_out, int adj_width, void* x0_out,
                                void* scratch, int max_ctas, void* stream) {
  Chain C;
  if (fill_chain(C, n_layers, in_dims, out_dims, 0, hidden, p0, act, quad_a)) return -1;
  SlotParams P;
  if (fill_slot_params(P, levels, feats, pk_shift, res, dense, ent_mask, row_off, radius,
                       clip_hi, smooth, pe_freqs, pe_scale) || n_layers < 2 || pe_freqs < 1)
    return -1;
  if (scratch && max_ctas < 1) return -1;
  int lds, ldz;
  size_t smem, stack;
  fwd_geometry(n_layers, hidden, p0, levels, feats, out_dims[n_layers - 1], with_grad,
               with_grad || zs_out, lds, ldz, smem, stack);
  if (!scratch) smem += stack;
  if (with_grad)
    return launch_fwd<true>(smem, n, max_ctas, scratch, stream, pos, table, lmask, wpack, bpack,
                            C, P, lds, ldz, sdf, geo, geo_width, grad, zs_out, ss_out, adj_out,
                            adj_width, x0_out);
  return launch_fwd<false>(smem, n, max_ctas, scratch, stream, pos, table, lmask, wpack, bpack, C,
                           P, lds, ldz, sdf, nullptr, 0, nullptr, zs_out, nullptr, nullptr, 0,
                           x0_out);
}
