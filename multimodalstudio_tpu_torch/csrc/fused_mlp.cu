// Fused dense-chain (MLP) forward for Hopper: the whole layer chain of a
// 64-sample tile runs out of shared memory, so inter-layer activations
// never touch device memory.
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
