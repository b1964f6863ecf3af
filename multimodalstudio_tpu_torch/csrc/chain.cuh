// Shared pieces of the fused dense-chain kernels (fused_mlp.cu, slot_fused.cu).
//
// A CTA owns a tile of 64 samples. Activations live in shared memory as
// bf16 [64, ld] row-major; each layer is a 64 x N x K product on the tensor
// cores through nvcuda::wmma (bf16 16x16x16 fragments, f32 accumulators).
// Weights are read straight from global memory as wmma B fragments, so
// they stream through L2 one 16-deep k-tile at a time; a warp keeps its
// B fragment for the 4 row tiles of the CTA, so each CTA reads every
// weight once per layer. Finished 16x16 accumulator tiles are staged
// through a per-warp float scratch and handed to an epilogue functor.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace mms {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int TILE_M = 64;    // samples per CTA
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAXL = 8;       // max layers of a chain
constexpr int PAD = 8;        // bf16 row padding of shared activation tiles

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SOFTPLUS_QUAD = 2 };

// hidden activation and its derivative, in f32 (fused_mlp.py:122-147)
__device__ __forceinline__ float act_f(int act, float z, float a) {
  if (act == ACT_RELU) return fmaxf(z, 0.f);
  if (act == ACT_SOFTPLUS_QUAD)
    return fabsf(z) < a ? (z + a) * (z + a) * (0.25f / a) : fmaxf(z, 0.f);
  return z;
}

__device__ __forceinline__ float act_df(int act, float z, float a) {
  if (act == ACT_RELU) return z > 0.f ? 1.f : 0.f;
  if (act == ACT_SOFTPLUS_QUAD)
    return fabsf(z) < a ? (z + a) * (0.5f / a) : (z > 0.f ? 1.f : 0.f);
  return 1.f;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Geometry of one chain: padded (multiple of 16) per-layer widths and the
// element offsets of each layer in the packed weight / bias buffers.
struct Chain {
  int n_layers;
  int in_dims[MAXL];
  int out_dims[MAXL];
  long long w_off[MAXL];
  long long b_off[MAXL];
  int skip_mask;  // bit l: layer l's input is concat(h, x0) / sqrt(2)
  int hidden;
  int p0;         // padded chain input width
  int act;
  float quad_a;   // SoftplusQuad half-width 2 / beta
};

inline int fill_chain(Chain& c, int n_layers, const int* in_dims, const int* out_dims,
                      int skip_mask, int hidden, int p0, int act, float quad_a) {
  if (n_layers < 1 || n_layers > MAXL) return -1;
  c.n_layers = n_layers;
  long long w = 0, b = 0;
  for (int l = 0; l < n_layers; ++l) {
    if (in_dims[l] % 16 || out_dims[l] % 16) return -1;
    c.in_dims[l] = in_dims[l];
    c.out_dims[l] = out_dims[l];
    c.w_off[l] = w;
    c.b_off[l] = b;
    w += (long long)in_dims[l] * out_dims[l];
    b += out_dims[l];
  }
  c.skip_mask = skip_mask;
  c.hidden = hidden;
  c.p0 = p0;
  c.act = act;
  c.quad_a = quad_a;
  return 0;
}

// C[64, ncols] = A[64, kdim] @ B. A: shared bf16 row-major (lda). B: global
// bf16; row-major [kdim, ncols] with ldb when !B_T, or the transpose of a
// row-major [ncols, kdim] matrix (ldb = its row length) when B_T. For each
// finished tile the warp calls epi(row0, col0, tile) with the f32 tile
// (row-major 16 x 16) in its slice of stage[NWARPS * 256]; every lane of
// the warp takes part.
template <bool B_T, class Epi>
__device__ __forceinline__ void mma_tile64(const bf16* A, int lda, int kdim, const bf16* B,
                                           int ldb, int ncols, float* stage, Epi epi) {
  const int warp = threadIdx.x >> 5;
  float* st = stage + warp * 256;  // this warp's 16x16 f32 staging tile
  for (int nt = warp; nt < ncols / 16; nt += NWARPS) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0.f);
    for (int kt = 0; kt < kdim / 16; ++kt) {
      if (B_T) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, B + (long long)nt * 16 * ldb + kt * 16, ldb);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, A + i * 16 * lda + kt * 16, lda);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        }
      } else {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, B + (long long)kt * 16 * ldb + nt * 16, ldb);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, A + i * 16 * lda + kt * 16, lda);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wmma::store_matrix_sync(st, acc[i], 16, wmma::mem_row_major);
      __syncwarp();
      epi(i * 16, nt * 16, st);
      __syncwarp();
    }
  }
}

// Hidden layers 0..L-2 of a chain: reads `in` (x0 in cols [0, p0)), writes
// bf16(act(z)) ping-ponging between buf0/buf1 (row stride lds). A skip layer
// gets concat(h, x0) * (1/sqrt(2)) rounded to bf16 (fused_mlp.py:284-291);
// x0 must then stay readable in `x0` (row stride ldx0). When zs != nullptr
// the bf16 pre-activations of layer l go to zs + l * 64 * ldz. Returns the
// buffer holding the last hidden activation (the last layer's input).
__device__ __forceinline__ bf16* run_hidden_layers(const Chain& C, const bf16* __restrict__ wpack,
                                                   const float* __restrict__ bpack, bf16* buf0,
                                                   bf16* buf1, int lds, const bf16* x0, int ldx0,
                                                   bf16* zs, int ldz, float* stage) {
  const float skip_scale = 0.70710678118654752f;
  bf16* in = buf0;
  bf16* out = buf1;
  const int lane = threadIdx.x & 31;
  for (int l = 0; l < C.n_layers - 1; ++l) {
    const bf16* W = wpack + C.w_off[l];
    const float* B = bpack + C.b_off[l];
    const bool next_skip = (C.skip_mask >> (l + 1)) & 1;
    bf16* zl = zs ? zs + (long long)l * TILE_M * ldz : nullptr;
    mma_tile64<false>(in, lds, C.in_dims[l], W, C.out_dims[l], C.out_dims[l], stage,
                      [&](int r0, int c0, const float* t) {
                        for (int i = lane; i < 256; i += 32) {
                          const int r = r0 + (i >> 4), c = c0 + (i & 15);
                          const float z = t[i] + B[c];
                          if (zl) zl[r * ldz + c] = __float2bfloat16(z);
                          float h = round_bf16(act_f(C.act, z, C.quad_a));
                          if (next_skip) h = h * skip_scale;
                          out[r * lds + c] = __float2bfloat16(h);
                        }
                      });
    if (next_skip) {
      for (int i = threadIdx.x; i < TILE_M * C.p0; i += NTHREADS) {
        const int r = i / C.p0, c = i % C.p0;
        out[r * lds + C.hidden + c] =
            __float2bfloat16(__bfloat162float(x0[r * ldx0 + c]) * skip_scale);
      }
    }
    __syncthreads();
    bf16* t = in;
    in = out;
    out = t;
  }
  return in;
}

}  // namespace mms
