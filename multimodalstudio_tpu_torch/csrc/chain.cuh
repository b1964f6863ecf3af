// Shared pieces of the fused dense-chain kernels (fused_mlp.cu, slot_fused.cu,
// slot_fused_bwd.cu, sdf_chain.cu).
//
// A CTA owns a tile of 64 samples. Activations live in shared memory as
// bf16 [64, ld] row-major; each layer is a 64 x N x K product on the tensor
// cores through nvcuda::wmma (bf16 16x16x16 fragments, f32 accumulators).
// Weights are read straight from global memory as wmma B fragments, so
// they stream through L2 one 16-deep k-tile at a time; a warp keeps its
// B fragment for the 4 row tiles of the CTA, so each CTA reads every
// weight once per layer. Finished 16x16 accumulator tiles are staged
// through a per-warp float scratch and handed to an epilogue functor.
//
// Each 16-deep k-step is accumulated from zero and added to the running f32
// sum with an IEEE add (add_partial), instead of carrying the whole sum
// through the tensor cores, whose internal additions are not IEEE
// round-to-nearest. In one call on an H100 (chip_ab.py, PERF.md), K4's
// former wmma backward (8 x 256, N = 163,840) agreed with its plain version to rel-L2
// 4.6e-3 / 6.4e-3 / 7.8e-3 (d pos / gW / gb) this way and to 7.0e-3 /
// 9.8e-3 / 1.2e-2 the other way, at about the same kernel times.
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
constexpr int MAXL = 32;      // max layers of a chain (build.py MAX_LAYERS)
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

// act'' (nonzero only for SoftplusQuad: 1 / (2a) on |z| < a)
__device__ __forceinline__ float act_ddf(int act, float z, float a) {
  if (act == ACT_SOFTPLUS_QUAD) return fabsf(z) < a ? 0.5f / a : 0.f;
  return 0.f;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

constexpr float SKIP_SCALE = 0.70710678118654752f;  // 1 / sqrt(2)
constexpr size_t MAX_SMEM = 232448;                 // per block on sm_90
// Status of an entry point whose tile needs more shared memory than MAX_SMEM
// (build.py check; -1: arguments the kernels do not take).
constexpr int ERR_SMEM = -2;

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc += a @ b, the k-step summed from zero and added with IEEE adds
template <class FA, class FB>
__device__ __forceinline__ void add_partial(Acc& acc, const FA& a, const FB& b) {
  Acc part;
  wmma::fill_fragment(part, 0.f);
  wmma::mma_sync(part, a, b, part);
#pragma unroll
  for (int e = 0; e < part.num_elements; ++e) acc.x[e] += part.x[e];
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

// Grid of a persistent kernel (one whose CTAs walk tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...): as many CTAs as fit on the card at once, at
// most max_ctas (the slabs of scratch the caller allocated) and at most one
// per 64-sample tile of n.
inline cudaError_t persistent_grid(const void* kernel, size_t smem, int n, int max_ctas,
                                   int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n + TILE_M - 1) / TILE_M;
  int g = (per_sm > 0 ? per_sm : 1) * sms;
  if (g > max_ctas) g = max_ctas;
  if (g > tiles) g = tiles;
  *grid = g > 0 ? g : 1;
  return cudaSuccess;
}

// C[64, ncols] = A[64, kdim] @ B. A: shared bf16 row-major (lda). B: global
// bf16; row-major [kdim, ncols] with ldb when !B_T, or the transpose of a
// row-major [ncols, kdim] matrix (ldb = its row length) when B_T. For each
// finished tile the warp calls epi(row0, col0, tile) with the f32 tile
// (row-major 16 x 16) in its slice of stage[NWARPS * 256]; every lane of
// the warp takes part. One warp owns a column tile and hands its four row
// tiles to epi in order, so an epilogue may read what the same lane wrote
// for an earlier row tile of the same columns.
template <bool B_T, class Epi>
__device__ __forceinline__ void mma_tile64(const bf16* A, int lda, int kdim, const bf16* B,
                                           int ldb, int ncols, float* stage, Epi epi) {
  const int warp = threadIdx.x >> 5;
  float* st = stage + warp * 256;  // this warp's 16x16 f32 staging tile
  for (int nt = warp; nt < ncols / 16; nt += NWARPS) {
    Acc acc[4];
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
          add_partial(acc[i], a, b);
        }
      } else {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, B + (long long)kt * 16 * ldb + nt * 16, ldb);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, A + i * 16 * lda + kt * 16, lda);
          add_partial(acc[i], a, b);
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
// buffer holding the last hidden activation (the last layer's input). zs and
// x0 may point into shared memory or into a CTA's slab of device scratch.
__device__ __forceinline__ bf16* run_hidden_layers(const Chain& C, const bf16* __restrict__ wpack,
                                                   const float* __restrict__ bpack, bf16* buf0,
                                                   bf16* buf1, int lds, const bf16* x0, int ldx0,
                                                   bf16* zs, int ldz, float* stage) {
  const float skip_scale = SKIP_SCALE;
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

// gW[m, n] += A^T B summed over the tile's 64 rows: A and B are bf16
// [64, lda] / [64, ldb] in shared memory or a CTA's scratch slab (m and n
// columns used, multiples of 16, 32-byte aligned rows); gW is a
// global f32 row-major matrix with row length ldw. The blocks of the grid
// run in any order, so each warp adds its finished 16 x 16 tiles with
// atomics (the sum's order changes from run to run).
__device__ __forceinline__ void mma_atb64_atomic(const bf16* A, int lda, int m, const bf16* B,
                                                 int ldb, int n, float* gW, int ldw,
                                                 float* stage) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* st = stage + warp * 256;
  const int tn = n / 16;
  for (int t = warp; t < (m / 16) * tn; t += NWARPS) {
    const int mt = t / tn, nt = t % tn;
    Acc acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int k = 0; k < TILE_M / 16; ++k) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, A + k * 16 * lda + mt * 16, lda);
      wmma::load_matrix_sync(b, B + k * 16 * ldb + nt * 16, ldb);
      add_partial(acc, a, b);
    }
    wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      const float v = st[i];
      if (v != 0.f) atomicAdd(gW + (long long)(mt * 16 + (i >> 4)) * ldw + nt * 16 + (i & 15), v);
    }
    __syncwarp();
  }
}

// Column sums of a warp's epilogue tiles into gb. Inside an mma_tile64
// epilogue each lane owns column c0 + (lane & 15) of every 16 x 16 tile;
// call add(part) with the lane's partial sum for the tile at rows r0: the
// two half-warps are combined and, after the last row tile, lanes 0-15 add
// their column's total to gb[c0 + lane].
struct ColSum {
  float acc = 0.f;
  __device__ __forceinline__ void add(float part, int r0, int c0, float* gb) {
    part += __shfl_xor_sync(0xffffffffu, part, 16);
    acc += part;
    if (r0 == TILE_M - 16) {
      if ((threadIdx.x & 31) < 16 && acc != 0.f) atomicAdd(gb + c0 + (threadIdx.x & 15), acc);
      acc = 0.f;
    }
  }
};

}  // namespace mms
