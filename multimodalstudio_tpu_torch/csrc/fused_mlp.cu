// Fused dense-chain (MLP) forward and backward for Hopper: the whole layer
// chain of a 64-sample tile runs out of shared memory, so inter-layer
// activations never touch device memory.
//
// Replaces the Pallas TPU kernel multimodalstudio_tpu/ops/pallas/fused_mlp.py
// _fwd_kernel (:265), reached through fused_chain (:1080), without forward
// tangents. Arithmetic follows chain_reference (:1263): bf16 inputs and
// weights, f32 accumulation plus f32 bias, activation in f32 rounded to bf16
// between layers, the last layer rounded to bf16 for y.
//
// Bound on an H100: at the slice's widths (<= 288 in, 256 hidden, N = 64K)
// the chain does ~2 * N * sum(din * dout) flops against N * (din + dout) * 2
// bytes of input and output, well above the card's ~295 flop/byte ridge, so
// the bound is the tensor-core rate. This first kernel uses wmma 16x16x16
// fragments with weights read from L2 (no TMA, no wgmma), which leaves it far
// below that bound; see PERF.md for its measured time.
#include "chain.cuh"

using namespace mms;

__global__ void __launch_bounds__(NTHREADS)
fused_chain_fwd_kernel(const bf16* __restrict__ x, int ldx, int d_in,
                       const bf16* __restrict__ wpack, const float* __restrict__ bpack,
                       bf16* __restrict__ y, int d_out, int n, Chain C, int lds, int ldx0) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* buf0 = reinterpret_cast<bf16*>(smem);
  bf16* buf1 = buf0 + TILE_M * lds;
  bf16* x0 = C.skip_mask ? buf1 + TILE_M * lds : buf0;
  float* stage = reinterpret_cast<float*>(C.skip_mask ? x0 + TILE_M * ldx0 : buf1 + TILE_M * lds);
  const long long row0 = (long long)blockIdx.x * TILE_M;

  // x0 = bf16 input rows, zero past d_in (to p0) and past n
  for (int i = threadIdx.x; i < TILE_M * C.p0; i += NTHREADS) {
    const int r = i / C.p0, c = i % C.p0;
    bf16 v = __float2bfloat16(0.f);
    if (row0 + r < n && c < d_in) v = x[(row0 + r) * ldx + c];
    buf0[r * lds + c] = v;
    if (C.skip_mask) x0[r * ldx0 + c] = v;
  }
  __syncthreads();

  const bf16* h = run_hidden_layers(C, wpack, bpack, buf0, buf1, lds, x0, ldx0, nullptr, 0, stage);

  const int l = C.n_layers - 1;
  const float* B = bpack + C.b_off[l];
  const int lane = threadIdx.x & 31;
  mma_tile64<false>(h, lds, C.in_dims[l], wpack + C.w_off[l], C.out_dims[l], C.out_dims[l],
                    stage, [&](int r0, int c0, const float* t) {
                      for (int i = lane; i < 256; i += 32) {
                        const int r = r0 + (i >> 4), c = c0 + (i & 15);
                        if (row0 + r < n && c < d_out)
                          y[(row0 + r) * d_out + c] = __float2bfloat16(t[i] + B[c]);
                      }
                    });
}

extern "C" int mms_fused_chain_fwd(const void* x, int d_in, const void* wpack, const void* bpack,
                                   void* y, int d_out, int n, int n_layers, const int* in_dims,
                                   const int* out_dims, int skip_mask, int hidden, int p0,
                                   int act, float quad_a, void* stream) {
  Chain C;
  if (fill_chain(C, n_layers, in_dims, out_dims, skip_mask, hidden, p0, act, quad_a)) return -1;
  int width = p0;
  for (int l = 0; l < n_layers; ++l) width = width > in_dims[l] ? width : in_dims[l];
  for (int l = 0; l + 1 < n_layers; ++l) width = width > out_dims[l] ? width : out_dims[l];
  const int lds = width + PAD;
  const int ldx0 = p0 + PAD;
  size_t smem = 2 * TILE_M * lds * sizeof(bf16) + NWARPS * 256 * sizeof(float);
  if (skip_mask) smem += TILE_M * ldx0 * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(fused_chain_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + TILE_M - 1) / TILE_M;
  fused_chain_fwd_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, d_in, d_in, (const bf16*)wpack, (const float*)bpack, (bf16*)y, d_out, n, C,
      lds, ldx0);
  return (int)cudaGetLastError();
}

// Backward of the chain. Replaces the Pallas TPU kernel
// multimodalstudio_tpu/ops/pallas/fused_mlp.py _bwd_kernel (:607), reached
// through chain_bwd (:904), without forward tangents. Per 64-sample tile:
// recompute the hidden layers keeping the bf16 pre-activations z, then sweep
// back: gz = gh * act'(z) rounded to bf16 (the last layer's gz is gy),
// gW_l += hin_l^T gz and gb_l += sum(gz) (f32, unrounded) with atomics across
// tiles, gh = gz W_l^T; hin_l is recomputed as bf16(act(z_{l-1})) from the
// stored bf16 z, as the reference does. gx is bf16.
//
// Where the z stack lives: an 8-layer 256-wide chain with a skip (the
// mlp_raw_tpu radiance trunk, 285 inputs) needs 7 x 64 x 264 bf16 of z
// (236,544 B) beside its two activation tiles (141,312 B): more than a
// block's 232,448 B. So the grid is persistent: at most `max_ctas` CTAs, each
// walking tiles blockIdx.x, blockIdx.x + gridDim.x, ..., and each owns one
// slab of a device-memory scratch that the wrapper allocates: the tile's z
// stack [L-1, 64, H] and its bf16 input x0 [64, p0] (read again by the skip
// layers). A slab is written and read back by the same CTA within a tile; for
// the trunk it is 266 KB and one CTA fits on an SM, so the resident slabs take
// 35 MB, inside the 50 MB L2. The 64-row tile, and with it each CTA reading every weight
// once per layer per tile, stays as it was; shared memory keeps the two
// activation tiles, the f32 skip cotangent gx0 [64, p0] and the staging.
//
// Bound on an H100: three chain-sized products per layer (forward
// recompute, gW, gh) on the tensor cores against N * (d_in + d_out) * 2 * 2
// bytes: the tensor cores bound it; this first design also pays one f32
// atomic per gW element per tile.
__global__ void __launch_bounds__(NTHREADS)
fused_chain_bwd_kernel(const bf16* __restrict__ x, int d_in, const bf16* __restrict__ gy,
                       int d_out, const bf16* __restrict__ wpack, const float* __restrict__ bpack,
                       bf16* __restrict__ gx, float* __restrict__ gw, float* __restrict__ gb,
                       int n, Chain C, int lds, bf16* scratch) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = C.n_layers, H = C.hidden, p0 = C.p0;
  const bool skips = C.skip_mask != 0;
  bf16* buf0 = reinterpret_cast<bf16*>(smem);
  bf16* buf1 = buf0 + TILE_M * lds;
  float* gx0 = reinterpret_cast<float*>(buf1 + TILE_M * lds);  // skip chains: [64, p0]
  float* stage = gx0 + (skips ? TILE_M * p0 : 0);
  // this CTA's slab: z stack (L-1) x [64, H], then x0 [64, p0]
  bf16* zs = scratch + (long long)blockIdx.x * ((L - 1) * TILE_M * H + TILE_M * p0);
  bf16* x0 = zs + (long long)(L - 1) * TILE_M * H;
  const int lane = threadIdx.x & 31;
  const int n_tiles = (n + TILE_M - 1) / TILE_M;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = (long long)tile * TILE_M;
    // x0 = bf16 input rows, zero past d_in (to p0) and past n
    for (int i = threadIdx.x; i < TILE_M * p0; i += NTHREADS) {
      const int r = i / p0, c = i % p0;
      bf16 v = __float2bfloat16(0.f);
      if (row0 + r < n && c < d_in) v = x[(row0 + r) * d_in + c];
      buf0[r * lds + c] = v;
      x0[r * p0 + c] = v;
      if (skips) gx0[r * p0 + c] = 0.f;
    }
    __syncthreads();
    run_hidden_layers(C, wpack, bpack, buf0, buf1, lds, x0, p0, zs, H, stage);

    // G = gy (bf16, zero past d_out and n); gb_{L-1} = its column sums
    bf16* G = buf0;
    bf16* Hb = buf1;
    const int dl = C.out_dims[L - 1];
    for (int i = threadIdx.x; i < TILE_M * dl; i += NTHREADS) {
      const int r = i / dl, c = i % dl;
      bf16 v = __float2bfloat16(0.f);
      if (row0 + r < n && c < d_out) v = gy[(row0 + r) * d_out + c];
      G[r * lds + c] = v;
    }
    __syncthreads();
    colsum_bf16(G, lds, d_out, gb + C.b_off[L - 1]);

    for (int l = L - 1; l >= 0; --l) {
      const bool sk = (C.skip_mask >> l) & 1;
      const int din = C.in_dims[l], dout = C.out_dims[l];
      const int hw = sk ? din - p0 : din;  // width of the h part of the layer input
      // hin_l: x0, or bf16(act(z_{l-1})) (and the skip's x0 part) for l > 0
      const bf16* hin = x0;
      int ldh = p0;
      if (l > 0) {
        const bf16* zp = zs + (long long)(l - 1) * TILE_M * H;
        for (int i = threadIdx.x; i < TILE_M * H; i += NTHREADS) {
          const int r = i / H, c = i % H;
          float h = round_bf16(act_f(C.act, bf(zp[r * H + c]), C.quad_a));
          if (sk) h = h * SKIP_SCALE;
          Hb[r * lds + c] = __float2bfloat16(h);
        }
        if (sk) {
          for (int i = threadIdx.x; i < TILE_M * p0; i += NTHREADS) {
            const int r = i / p0, c = i % p0;
            Hb[r * lds + H + c] = __float2bfloat16(bf(x0[r * p0 + c]) * SKIP_SCALE);
          }
        }
        hin = Hb;
        ldh = lds;
      }
      __syncthreads();
      mma_atb64_atomic(hin, ldh, din, G, lds, dout, gw + C.w_off[l], dout, stage);
      __syncthreads();
      // gh = gz W_l^T
      if (l > 0) {
        const bf16* zp = zs + (long long)(l - 1) * TILE_M * H;
        float* gbl = gb + C.b_off[l - 1];
        ColSum cols;
        mma_tile64<true>(G, lds, dout, wpack + C.w_off[l], dout, din, stage,
                         [&](int r0, int c0, const float* t) {
                           float part = 0.f;
                           for (int i = lane; i < 256; i += 32) {
                             const int r = r0 + (i >> 4), c = c0 + (i & 15);
                             if (c < hw) {
                               const float g = sk ? t[i] * SKIP_SCALE : t[i];
                               const float gz = g * act_df(C.act, bf(zp[r * H + c]), C.quad_a);
                               Hb[r * lds + c] = __float2bfloat16(gz);
                               part += gz;
                             } else {
                               gx0[r * p0 + c - hw] += t[i] * SKIP_SCALE;
                             }
                           }
                           if (c0 < hw) cols.add(part, r0, c0, gbl);
                         });
      } else {
        mma_tile64<true>(G, lds, dout, wpack + C.w_off[0], dout, din, stage,
                         [&](int r0, int c0, const float* t) {
                           for (int i = lane; i < 256; i += 32) {
                             const int r = r0 + (i >> 4), c = c0 + (i & 15);
                             if (row0 + r < n && c < d_in) {
                               const float v = skips ? t[i] + gx0[r * p0 + c] : t[i];
                               gx[(row0 + r) * d_in + c] = __float2bfloat16(v);
                             }
                           }
                         });
      }
      __syncthreads();
      bf16* tmp = G;
      G = Hb;
      Hb = tmp;
    }
  }
}

// Scratch bf16 elements per CTA of the backward (its z stack and x0 slab).
extern "C" long long mms_fused_chain_bwd_slab(int n_layers, int hidden, int p0) {
  return (long long)(n_layers - 1) * TILE_M * hidden + (long long)TILE_M * p0;
}

extern "C" int mms_fused_chain_bwd(const void* x, int d_in, const void* gy, const void* wpack,
                                   const void* bpack, void* gx, void* gw, void* gb, int d_out,
                                   int n, int n_layers, const int* in_dims, const int* out_dims,
                                   int skip_mask, int hidden, int p0, int act, float quad_a,
                                   void* scratch, int max_ctas, void* stream) {
  Chain C;
  if (fill_chain(C, n_layers, in_dims, out_dims, skip_mask, hidden, p0, act, quad_a)) return -1;
  if ((skip_mask & 1) || max_ctas < 1) return -1;
  int width = p0;
  for (int l = 0; l < n_layers; ++l) {
    width = width > in_dims[l] ? width : in_dims[l];
    width = width > out_dims[l] ? width : out_dims[l];
  }
  const int lds = width + PAD;
  size_t smem = 2 * (size_t)TILE_M * lds * sizeof(bf16) + NWARPS * 256 * sizeof(float);
  if (skip_mask) smem += (size_t)TILE_M * p0 * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_chain_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int grid;
  err = persistent_grid((const void*)fused_chain_bwd_kernel, smem, n, max_ctas, &grid);
  if (err != cudaSuccess) return (int)err;
  fused_chain_bwd_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, d_in, (const bf16*)gy, d_out, (const bf16*)wpack, (const float*)bpack,
      (bf16*)gx, (float*)gw, (float*)gb, n, C, lds, (bf16*)scratch);
  return (int)cudaGetLastError();
}
