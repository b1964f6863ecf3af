// Slot-grid lookup for Hopper: kernels K6 (cell layout) and K6v (vertex layout), forward and
// backward.
//
// Replaces two Pallas TPU kernels of multimodalstudio_tpu/ops/pallas/slot_grid.py, reached
// through slot_grid_lookup (:890) and _lookup_fn's custom VJP (:768-884), in the cell
// layout with packed entries (F = 2, 4, 8, 16 features, 128 / (8F) entries per 128-lane
// row) and an f32 or bf16 table:
//   _fwd_kernel (:415): enc [N, k*F] (and with tangents tenc [N, 3*k*F], column
//      t*k*F + l*F + f) from the sample's entry per level and the trilerp weights
//      w [N, k*8] (and their spatial derivatives dw [N, 3*k*8]);
//   _bwd_kernel (:536): d_table [rows, 128] by scatter-add, d_w [N, k*8] and d_dw.
//
// The TPU gathers a level's rows with a one-hot matrix product over the level's rows and
// keeps the gathered rows (`comp`, [N, k*128] f32: 503 MB at 163,840 samples) for the
// backward. Here one thread owns one (sample, level): it reads the sample's 8F values of
// the entry directly (the entry's absolute index e; its values are floats e*8F ..
// e*8F + 8F - 1 of the table, lane f*8 + p for feature f of corner p), and the backward
// reads them again instead of a residual. The scatter into d_table is f32 atomics, one per
// nonzero lane, so its summation order changes from run to run; the dense coarse levels
// take every sample, so their entries are contended.
//
// Cast points in bf16-table mode (_fwd_kernel :509-523, _bwd_kernel :578-629): T, w and dw
// rounded to bf16; enc = sum_p bf16(T * w_p) and tenc_t = sum_p bf16(T * dw_t,p) in f32;
// gt = bf16(genc), gtk = bf16(gtenc_t); d_w[p] = sum_f bf16(T * gt), d_dw the same with gtk;
// u = gt * w + sum_t gtk * dw_t in f32 (in that order), rounded to bf16 before the atomic
// add. The f32 table runs the same sums without the roundings. Compiled without fused
// multiply-adds (build.py), so each product is rounded before its sum, as in the reference.
//
// Bound on an H100: per (sample, level) the forward reads 32 + 96 bytes of weights (with
// tangents), an 8-byte index and 8F table values (the table is L2-resident: 1.5 MB at the
// flagship size), writes 16F bytes and does about 32F multiply-adds: the bytes bound it.
//
// K6v replaces the same two Pallas kernels in the vertex layout (exact C0; F = 16, an f32
// table, the TPU's copy gather: _fwd_kernel's vertex branch :487-507, _bwd_kernel's
// :645-662). idx is [N, k*8]: column l*8 + p is the absolute row of the corner of parity p,
// and that corner's feature f is lane f*8 + p of its row. One thread owns one (sample,
// level) and reads 16 floats at a 32-byte stride from each of its 8 rows, so each corner
// touches its whole 512-byte row (4 KB of L2 sectors for 512 B of data); enc and tenc follow
// in exact f32 (the TPU's float32 dots). The backward adds u[n, l, f, p] into lane f*8 + p of
// row idx[n, l*8 + p] by f32 atomics; every sample's corners on a dense coarse level land
// in that level's few hundred rows, so those atomics contend.
#include "chain.cuh"

using namespace mms;

namespace {

constexpr int BLOCK = 256;

__device__ __forceinline__ float rnd(float x, bool bf) { return bf ? round_bf16(x) : x; }

template <int F, bool TANG>
__global__ void __launch_bounds__(BLOCK)
slot_lookup_fwd_kernel(const float* __restrict__ table, const long long* __restrict__ idx,
                       const float* __restrict__ w, const float* __restrict__ dw, int n, int k,
                       bool bf, float* __restrict__ enc, float* __restrict__ tenc) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= (long long)n * k) return;
  const long long s = i / k;
  const int l = (int)(i % k);
  const float* T = table + idx[i] * (8 * F);
  float wb[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) wb[p] = rnd(w[i * 8 + p], bf);
  float dwb[3][8];
  if (TANG) {
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int p = 0; p < 8; ++p) dwb[t][p] = rnd(dw[(s * 3 + t) * k * 8 + l * 8 + p], bf);
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float v[8];
    const float4* T4 = reinterpret_cast<const float4*>(T + f * 8);
    const float4 lo = T4[0], hi = T4[1];
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    float acc = 0.f, ta[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const float tv = rnd(v[p], bf);
      acc += rnd(tv * wb[p], bf);
      if (TANG) {
#pragma unroll
        for (int t = 0; t < 3; ++t) ta[t] += rnd(tv * dwb[t][p], bf);
      }
    }
    enc[i * F + f] = acc;
    if (TANG) {
#pragma unroll
      for (int t = 0; t < 3; ++t) tenc[(s * 3 + t) * k * F + l * F + f] = ta[t];
    }
  }
}

template <int F, bool TANG>
__global__ void __launch_bounds__(BLOCK)
slot_lookup_bwd_kernel(const float* __restrict__ table, const long long* __restrict__ idx,
                       const float* __restrict__ w, const float* __restrict__ dw,
                       const float* __restrict__ genc, const float* __restrict__ gtenc, int n,
                       int k, bool bf, float* __restrict__ d_table, float* __restrict__ d_w,
                       float* __restrict__ d_dw) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= (long long)n * k) return;
  const long long s = i / k;
  const int l = (int)(i % k);
  const long long e0 = idx[i] * (8 * F);
  const float* T = table + e0;
  float wb[8], gw[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    wb[p] = rnd(w[i * 8 + p], bf);
    gw[p] = 0.f;
  }
  float dwb[3][8], gdw[3][8];
  if (TANG) {
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        dwb[t][p] = rnd(dw[(s * 3 + t) * k * 8 + l * 8 + p], bf);
        gdw[t][p] = 0.f;
      }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float gt = rnd(genc[i * F + f], bf);
    float gtk[3] = {0.f, 0.f, 0.f};
    if (TANG) {
#pragma unroll
      for (int t = 0; t < 3; ++t) gtk[t] = rnd(gtenc[(s * 3 + t) * k * F + l * F + f], bf);
    }
    float v[8];
    const float4* T4 = reinterpret_cast<const float4*>(T + f * 8);
    const float4 lo = T4[0], hi = T4[1];
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const float tv = rnd(v[p], bf);
      gw[p] += rnd(tv * gt, bf);
      float u = gt * wb[p];
      if (TANG) {
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          gdw[t][p] += rnd(tv * gtk[t], bf);
          u = u + gtk[t] * dwb[t][p];
        }
      }
      u = rnd(u, bf);
      if (u != 0.f) atomicAdd(d_table + e0 + f * 8 + p, u);
    }
  }
#pragma unroll
  for (int p = 0; p < 8; ++p) d_w[i * 8 + p] = gw[p];
  if (TANG) {
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int p = 0; p < 8; ++p) d_dw[(s * 3 + t) * k * 8 + l * 8 + p] = gdw[t][p];
  }
}


constexpr int VF = 16;  // features per vertex in the vertex layout

template <bool TANG>
__global__ void __launch_bounds__(BLOCK)
slot_vertex_fwd_kernel(const float* __restrict__ table, const long long* __restrict__ idx,
                       const float* __restrict__ w, const float* __restrict__ dw, int n, int k,
                       float* __restrict__ enc, float* __restrict__ tenc) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= (long long)n * k) return;
  const long long s = i / k;
  const int l = (int)(i % k);
  const float* R[8];
  float wb[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    R[p] = table + idx[i * 8 + p] * 128 + p;  // parity p's lanes of corner p's row
    wb[p] = w[i * 8 + p];
  }
  float dwb[3][8];
  if (TANG) {
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int p = 0; p < 8; ++p) dwb[t][p] = dw[(s * 3 + t) * k * 8 + l * 8 + p];
  }
#pragma unroll 4
  for (int f = 0; f < VF; ++f) {
    float acc = 0.f, ta[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const float tv = R[p][f * 8];
      acc += tv * wb[p];
      if (TANG) {
#pragma unroll
        for (int t = 0; t < 3; ++t) ta[t] += tv * dwb[t][p];
      }
    }
    enc[i * VF + f] = acc;
    if (TANG) {
#pragma unroll
      for (int t = 0; t < 3; ++t) tenc[(s * 3 + t) * k * VF + l * VF + f] = ta[t];
    }
  }
}

template <bool TANG>
__global__ void __launch_bounds__(BLOCK)
slot_vertex_bwd_kernel(const float* __restrict__ table, const long long* __restrict__ idx,
                       const float* __restrict__ w, const float* __restrict__ dw,
                       const float* __restrict__ genc, const float* __restrict__ gtenc, int n,
                       int k, float* __restrict__ d_table, float* __restrict__ d_w,
                       float* __restrict__ d_dw) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= (long long)n * k) return;
  const long long s = i / k;
  const int l = (int)(i % k);
  long long e[8];
  float wb[8], gw[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    e[p] = idx[i * 8 + p] * 128 + p;
    wb[p] = w[i * 8 + p];
    gw[p] = 0.f;
  }
  float dwb[3][8], gdw[3][8];
  if (TANG) {
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        dwb[t][p] = dw[(s * 3 + t) * k * 8 + l * 8 + p];
        gdw[t][p] = 0.f;
      }
  }
#pragma unroll 2
  for (int f = 0; f < VF; ++f) {
    const float gt = genc[i * VF + f];
    float gtk[3] = {0.f, 0.f, 0.f};
    if (TANG) {
#pragma unroll
      for (int t = 0; t < 3; ++t) gtk[t] = gtenc[(s * 3 + t) * k * VF + l * VF + f];
    }
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const float tv = table[e[p] + f * 8];
      gw[p] += tv * gt;
      float u = gt * wb[p];
      if (TANG) {
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          gdw[t][p] += tv * gtk[t];
          u = u + gtk[t] * dwb[t][p];
        }
      }
      if (u != 0.f) atomicAdd(d_table + e[p] + f * 8, u);
    }
  }
#pragma unroll
  for (int p = 0; p < 8; ++p) d_w[i * 8 + p] = gw[p];
  if (TANG) {
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int p = 0; p < 8; ++p) d_dw[(s * 3 + t) * k * 8 + l * 8 + p] = gdw[t][p];
  }
}

template <int F>
int fwd_f(const float* table, const long long* idx, const float* w, const float* dw, int n, int k,
          bool bf, float* enc, float* tenc, cudaStream_t stream) {
  const long long work = (long long)n * k;
  const unsigned grid = (unsigned)((work + BLOCK - 1) / BLOCK);
  if (dw)
    slot_lookup_fwd_kernel<F, true><<<grid, BLOCK, 0, stream>>>(table, idx, w, dw, n, k, bf, enc,
                                                                 tenc);
  else
    slot_lookup_fwd_kernel<F, false><<<grid, BLOCK, 0, stream>>>(table, idx, w, dw, n, k, bf,
                                                                  enc, tenc);
  return (int)cudaGetLastError();
}

template <int F>
int bwd_f(const float* table, const long long* idx, const float* w, const float* dw,
          const float* genc, const float* gtenc, int n, int k, bool bf, float* d_table,
          float* d_w, float* d_dw, cudaStream_t stream) {
  const long long work = (long long)n * k;
  const unsigned grid = (unsigned)((work + BLOCK - 1) / BLOCK);
  if (dw)
    slot_lookup_bwd_kernel<F, true><<<grid, BLOCK, 0, stream>>>(table, idx, w, dw, genc, gtenc, n,
                                                                 k, bf, d_table, d_w, d_dw);
  else
    slot_lookup_bwd_kernel<F, false><<<grid, BLOCK, 0, stream>>>(table, idx, w, dw, genc, gtenc,
                                                                  n, k, bf, d_table, d_w, d_dw);
  return (int)cudaGetLastError();
}

bool bad_args(int n, int k, int feats) {
  return n < 1 || k < 1 || (feats != 2 && feats != 4 && feats != 8 && feats != 16);
}

unsigned grid_of(int n, int k) { return (unsigned)(((long long)n * k + BLOCK - 1) / BLOCK); }

}  // namespace

// enc [n, k*feats] (and tenc [n, 3*k*feats] when dw is not null) from the f32 table
// [rows, 128], idx [n, k] int64 absolute entry indices, w [n, k*8] and dw [n, 3*k*8].
extern "C" int mms_slot_lookup_fwd(const void* table, const void* idx, const void* w,
                                   const void* dw, int n, int k, int feats, int bf16_table,
                                   void* enc, void* tenc, void* stream) {
  if (bad_args(n, k, feats) || (dw != nullptr) != (tenc != nullptr)) return -1;
  const auto* t = (const float*)table;
  const auto* ix = (const long long*)idx;
  const auto s = (cudaStream_t)stream;
  const bool bf = bf16_table != 0;
  switch (feats) {
    case 2: return fwd_f<2>(t, ix, (const float*)w, (const float*)dw, n, k, bf, (float*)enc, (float*)tenc, s);
    case 4: return fwd_f<4>(t, ix, (const float*)w, (const float*)dw, n, k, bf, (float*)enc, (float*)tenc, s);
    case 8: return fwd_f<8>(t, ix, (const float*)w, (const float*)dw, n, k, bf, (float*)enc, (float*)tenc, s);
    default: return fwd_f<16>(t, ix, (const float*)w, (const float*)dw, n, k, bf, (float*)enc, (float*)tenc, s);
  }
}

// d_table [rows, 128] (zeroed by the caller, accumulated), d_w [n, k*8] and, when dw is not
// null, d_dw [n, 3*k*8] from the cotangents genc [n, k*feats] (and gtenc [n, 3*k*feats]).
extern "C" int mms_slot_lookup_bwd(const void* table, const void* idx, const void* w,
                                   const void* dw, const void* genc, const void* gtenc, int n,
                                   int k, int feats, int bf16_table, void* d_table, void* d_w,
                                   void* d_dw, void* stream) {
  if (bad_args(n, k, feats) || (dw != nullptr) != (gtenc != nullptr) ||
      (dw != nullptr) != (d_dw != nullptr))
    return -1;
  const auto* t = (const float*)table;
  const auto* ix = (const long long*)idx;
  const auto* ge = (const float*)genc;
  const auto* gte = (const float*)gtenc;
  const auto s = (cudaStream_t)stream;
  const bool bf = bf16_table != 0;
  switch (feats) {
    case 2: return bwd_f<2>(t, ix, (const float*)w, (const float*)dw, ge, gte, n, k, bf, (float*)d_table, (float*)d_w, (float*)d_dw, s);
    case 4: return bwd_f<4>(t, ix, (const float*)w, (const float*)dw, ge, gte, n, k, bf, (float*)d_table, (float*)d_w, (float*)d_dw, s);
    case 8: return bwd_f<8>(t, ix, (const float*)w, (const float*)dw, ge, gte, n, k, bf, (float*)d_table, (float*)d_w, (float*)d_dw, s);
    default: return bwd_f<16>(t, ix, (const float*)w, (const float*)dw, ge, gte, n, k, bf, (float*)d_table, (float*)d_w, (float*)d_dw, s);
  }
}

// Vertex layout (K6v): enc [n, k*16] (and tenc [n, 3*k*16] when dw is not null) from the f32
// table [rows, 128], idx [n, k*8] int64 absolute rows (column l*8 + p: the corner of parity
// p), w [n, k*8] and dw [n, 3*k*8].
extern "C" int mms_slot_vertex_fwd(const void* table, const void* idx, const void* w,
                                   const void* dw, int n, int k, void* enc, void* tenc,
                                   void* stream) {
  if (n < 1 || k < 1 || (dw != nullptr) != (tenc != nullptr)) return -1;
  const auto* t = (const float*)table;
  const auto* ix = (const long long*)idx;
  const auto s = (cudaStream_t)stream;
  if (dw)
    slot_vertex_fwd_kernel<true><<<grid_of(n, k), BLOCK, 0, s>>>(
        t, ix, (const float*)w, (const float*)dw, n, k, (float*)enc, (float*)tenc);
  else
    slot_vertex_fwd_kernel<false><<<grid_of(n, k), BLOCK, 0, s>>>(
        t, ix, (const float*)w, nullptr, n, k, (float*)enc, nullptr);
  return (int)cudaGetLastError();
}

// Vertex layout (K6v): d_table [rows, 128] (zeroed by the caller, accumulated), d_w [n, k*8]
// and, when dw is not null, d_dw [n, 3*k*8] from genc [n, k*16] (and gtenc [n, 3*k*16]).
extern "C" int mms_slot_vertex_bwd(const void* table, const void* idx, const void* w,
                                   const void* dw, const void* genc, const void* gtenc, int n,
                                   int k, void* d_table, void* d_w, void* d_dw, void* stream) {
  if (n < 1 || k < 1 || (dw != nullptr) != (gtenc != nullptr) ||
      (dw != nullptr) != (d_dw != nullptr))
    return -1;
  const auto* t = (const float*)table;
  const auto* ix = (const long long*)idx;
  const auto s = (cudaStream_t)stream;
  if (dw)
    slot_vertex_bwd_kernel<true><<<grid_of(n, k), BLOCK, 0, s>>>(
        t, ix, (const float*)w, (const float*)dw, (const float*)genc, (const float*)gtenc, n, k,
        (float*)d_table, (float*)d_w, (float*)d_dw);
  else
    slot_vertex_bwd_kernel<false><<<grid_of(n, k), BLOCK, 0, s>>>(
        t, ix, (const float*)w, nullptr, (const float*)genc, nullptr, n, k, (float*)d_table,
        (float*)d_w, nullptr);
  return (int)cudaGetLastError();
}
