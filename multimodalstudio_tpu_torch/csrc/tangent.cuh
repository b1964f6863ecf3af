// The tile layout of the tangent chains K1t and K4j on K1's building blocks (k1.cuh),
// shared by their forward pass (tangent_fwd.cu) and their backward pass (fused_mlp.cu):
// one m64 wgmma a layer over the primal and tangent rows of b samples (b = 32 for K =
// 1 tangent, else 16), placed so that a sample's rows meet in registers. In the
// accumulator layout the thread of lane l in warp w holds rows 16 w + l / 4 and that
// + 8; with K = 1 those are one sample's primal and tangent rows; with K = 2, 3 lanes
// l < 16 hold a sample's primal row and tangent 2, lane l ^ 16 tangents 1 and 3 (3
// idle with K = 2), so one shuffle exchanges what a row needs of its sample's others
// (tan_kind, tan_sample).
#pragma once

#include "enc.cuh"
#include "k1.cuh"

namespace k1 {

// Output of the tangent forward. mode 0: y [n, width] bf16 and ty [K, n, width] bf16;
// mode 1: y and column `channel` of the tangents as tyf [n, K] f32; mode 2 (split, K4j):
// sdf [n] f32 = column 0, y = geo [n, width] bf16 = columns 1 .. width, tyf = grad
// [n, K] f32 = column 0 of the tangents.
struct TanOut {
  int mode, channel, width;
  bf16* y;
  bf16* ty;
  float* tyf;
  float* sdf;
};

// One call's inputs, cotangents and outputs. mode 0: gy [n, width] bf16 and gty
// [K, n, width] bf16; mode 1: gy and gtyf [n, K] f32 on column `channel`; mode 2
// (K4j): gsdf [n] f32 and gy = ggeo [n, width] bf16 (columns 1 ..), gtyf = g3 [n, K]
// f32 on column 0.
struct TanIo {
  const float* pos;   // K4j [n, 3]
  const bf16* x;      // K1t [n, d_in]
  const bf16* tx;     // K1t [K, n, d_in]
  const bf16* gy;
  const bf16* gty;
  const float* gtyf;
  const float* gsdf;
  bf16* gx;           // K1t [n, d_in]
  bf16* gtx;          // K1t [K, n, d_in]
  float* d_pos;       // K4j [n, 3]
  int mode, channel, width, K, b;
  int x_f32;          // K1t: x and tx are f32 (else bf16)
};

// The kind of tile row r (0: primal, k: tangent k - 1; 3 is idle with K = 2) and
// its sample within the tile, and the row of (sample s, kind)
__device__ __forceinline__ int tan_kind(int r, int K) {
  return K == 1 ? (r >> 3) & 1 : 2 * ((r >> 3) & 1) + ((r & 7) >> 2);
}
__device__ __forceinline__ int tan_sample(int r, int K) {
  return K == 1 ? 8 * (r >> 4) + (r & 7) : 4 * (r >> 4) + (r & 3);
}
__device__ __forceinline__ int tan_row(int s, int kind, int K) {
  return K == 1 ? 16 * (s >> 3) + 8 * kind + (s & 7)
                : 16 * (s >> 2) + 8 * (kind >> 1) + 4 * (kind & 1) + (s & 3);
}

// the last layer's f32 cotangent at (kind, row, c): gh for kind 0, gt_{kind-1} else
__device__ __forceinline__ float tan_cotangent(const TanIo& I, int n, int kind, long long row,
                                               int c) {
  if (kind == 0) {
    if (I.mode == 2) {
      if (c == 0) return I.gsdf[row];
      return c - 1 < I.width ? bf(I.gy[row * I.width + c - 1]) : 0.f;
    }
    return c < I.width ? bf(I.gy[row * I.width + c]) : 0.f;
  }
  if (I.mode == 0)
    return c < I.width ? bf(I.gty[((kind - 1) * (long long)n + row) * I.width + c]) : 0.f;
  return c == I.channel ? I.gtyf[row * I.K + kind - 1] : 0.f;
}

// The tile's chain input rows into activation columns [c0, c0 + P0), zero past
// the input's width, past n and past the K tangents: primal rows from x or the
// encoding of pos (E.freqs > 0); tangent rows from tx or the encoding's bf16 basis
// tangents (the unit column of x_k and coordinate k's derivative columns, _enc_fwd
// :199-211).
__device__ __forceinline__ void tan_front(const Geom& G, const mms::Enc& E, const TanIo& I,
                                          bf16* act, int c0, long long s0, int n) {
  const int F = E.freqs, P0 = G.P0;
  for (int i = threadIdx.x & 127; i < 64 * P0; i += 128) {
    const int r = i / P0, c = i % P0;
    const int kind = tan_kind(r, I.K);
    const long long row = s0 + tan_sample(r, I.K);
    float v = 0.f;
    if (kind <= I.K && row < n && c < E.width) {
      if (!F) {
        const long long at = kind == 0 ? row * E.width + c
                                       : ((kind - 1) * (long long)n + row) * E.width + c;
        const void* src = kind == 0 ? (const void*)I.x : (const void*)I.tx;
        v = I.x_f32 ? static_cast<const float*>(src)[at] : bf(static_cast<const bf16*>(src)[at]);
      } else if (kind == 0) {
        v = mms::pe_col(I.pos + row * 3, F, E.scale, c);
      } else if (c < 3) {
        v = c == kind - 1 ? 1.f : 0.f;
      } else if ((c - 3) % (3 * F) / F == kind - 1) {
        v = mms::pe_tangent(I.pos + row * 3, F, E.scale, c);
      }
    }
    act[act_el(c0 + c, r)] = __float2bfloat16(v);
  }
}

// The pair of words (2 bf16) of the thread's samples' primal row, given the word of
// its row r0 (w0): its own with K = 1 and on lanes < 16, lane ^ 16's on the others.
// Every lane of the warp calls it.
__device__ __forceinline__ uint32_t primal_word(uint32_t w0, int K) {
  const uint32_t other = __shfl_xor_sync(0xffffffffu, w0, 16);
  return K == 1 || (threadIdx.x & 16) == 0 ? w0 : other;
}

}  // namespace k1
