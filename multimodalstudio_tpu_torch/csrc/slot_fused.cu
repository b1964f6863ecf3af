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
// bf16 and the chain runs on the tensor cores (chain.cuh).
//
// Cast points follow the JAX kernel: table and trilerp weight rounded to bf16, their
// product rounded to bf16 before the 8-corner f32 sum, the sum times the coarse-to-fine
// mask rounded to bf16 into the chain input; the NeRF encoding uses sinf / cosf (no fast
// math); the last layer stays f32 (sdf) and geo is rounded to bf16; the adjoint sweep
// evaluates act' on the bf16-stored pre-activations.
//
// Bound on an H100: the chain's tensor-core work (2 * N * sum(din * dout) flops) against
// N * (12 + 4 [+ 2 * 256 + 12]) bytes of positions and outputs plus the table: the tensor
// cores bound it. The table (3072 x 128 bf16, 768 KB) stays in L2.
#include "chain.cuh"

using namespace mms;

constexpr int MAXLV = 8;   // max grid levels
constexpr int MAXPE = 16;  // max NeRF-encoding frequencies

struct SlotParams {
  int levels;    // active levels K (<= the table's levels)
  int feats;     // F features per entry
  int pk_shift;  // log2(entries per 128-lane row)
  int res[MAXLV];
  int dense[MAXLV];
  unsigned ent_mask[MAXLV];  // entries - 1 (hashed levels)
  int row_off[MAXLV];        // physical row offset of each level
  float radius;
  float clip_hi;  // float32(1 - 1e-6)
  int smooth;     // Smoothstep (1) or Linear (0)
  int pe_freqs;
  float pe_scale[MAXPE];
  int pw;  // 3 + 6 * pe_freqs
};

// Cell of level l containing p: entry index and per-axis trilerp factors
// wa[t][bit] (bit ? s : 1 - s) and their derivatives dwa[t][bit] = d wa / d x
// (the resolution chain rule included), as slot_grid.py::slot_geometry.
__device__ __forceinline__ unsigned cell_geom(const SlotParams& P, int l, const float p[3],
                                              float wa[3][2], float dwa[3][2]) {
  const float r = P.radius;
  const float resf = (float)P.res[l];
  int b[3];
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    float g = (p[t] + r) / (2.f * r);
    g = fminf(fmaxf(g, 0.f), P.clip_hi);
    const float sc = g * resf;
    const float fl = floorf(sc);
    const float fr = sc - fl;
    b[t] = min(max((int)fl, 0), P.res[l] - 1);
    float s, ds;
    if (P.smooth) {
      s = fr * fr * (3.f - 2.f * fr);
      ds = 6.f * fr * (1.f - fr) * resf;
    } else {
      s = fr;
      ds = resf;
    }
    wa[t][0] = 1.f - s;
    wa[t][1] = s;
    dwa[t][0] = -ds;
    dwa[t][1] = ds;
  }
  if (P.dense[l]) return (unsigned)(b[0] + (b[1] + b[2] * P.res[l]) * P.res[l]);
  const unsigned h = (unsigned)b[0] ^ ((unsigned)b[1] * 2654435761u) ^ ((unsigned)b[2] * 805459861u);
  return h & P.ent_mask[l];
}

template <bool GRAD>
__global__ void __launch_bounds__(NTHREADS)
slot_sdf_kernel(const float* __restrict__ pos, int n, const bf16* __restrict__ table,
                const float* __restrict__ lmask, const bf16* __restrict__ wpack,
                const float* __restrict__ bpack, Chain C, SlotParams P, int lds, int ldz,
                float* __restrict__ sdf, bf16* __restrict__ geo, int geo_width,
                float* __restrict__ grad) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ew = 8 * P.feats;  // bf16 values per entry
  bf16* buf0 = reinterpret_cast<bf16*>(smem);
  bf16* buf1 = buf0 + TILE_M * lds;
  bf16* zs = buf1 + TILE_M * lds;                     // GRAD: (L-1) x [64, ldz]
  bf16* sT = zs + (GRAD ? (C.n_layers - 1) * TILE_M * ldz : 0);  // [64, K, 8F]
  float* sAdj = reinterpret_cast<float*>(sT + TILE_M * P.levels * ew);  // GRAD: [64, p0]
  float* stage = sAdj + (GRAD ? TILE_M * C.p0 : 0);
  const long long row0 = (long long)blockIdx.x * TILE_M;
  const int lane = threadIdx.x & 31;

  // grid part of the chain input: one thread per (sample, level)
  for (int i = threadIdx.x; i < TILE_M * P.levels; i += NTHREADS) {
    const int r = i / P.levels, l = i % P.levels;
    float p[3] = {0.f, 0.f, 0.f};
    if (row0 + r < n) {
#pragma unroll
      for (int t = 0; t < 3; ++t) p[t] = pos[(row0 + r) * 3 + t];
    }
    float wa[3][2], dwa[3][2];
    const unsigned e = cell_geom(P, l, p, wa, dwa);
    const long long phys = P.row_off[l] + (long long)(e >> P.pk_shift);
    const int grp = e & ((1u << P.pk_shift) - 1u);
    const uint4* src = reinterpret_cast<const uint4*>(table + phys * 128 + grp * ew);
    uint4* dst = reinterpret_cast<uint4*>(sT + (r * P.levels + l) * ew);
    for (int q = 0; q < ew / 8; ++q) dst[q] = src[q];
    const bf16* T = sT + (r * P.levels + l) * ew;
    float wb[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      wb[c] = round_bf16(wa[0][c & 1] * wa[1][(c >> 1) & 1] * wa[2][(c >> 2) & 1]);
    for (int f = 0; f < P.feats; ++f) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc += round_bf16(__bfloat162float(T[f * 8 + c]) * wb[c]);
      buf0[r * lds + P.pw + l * P.feats + f] = __float2bfloat16(acc * lmask[l * P.feats + f]);
    }
  }
  // NeRF encoding [x, sin(x_d * 2^i), cos(x_d * 2^i)] (d-major) and zero padding
  const int grid_end = P.pw + P.levels * P.feats;
  const int F = P.pe_freqs;
  for (int i = threadIdx.x; i < TILE_M * C.p0; i += NTHREADS) {
    const int r = i / C.p0, c = i % C.p0;
    if (c >= P.pw && c < grid_end) continue;
    float v = 0.f;
    if (c < P.pw && row0 + r < n) {
      const float* pr = pos + (row0 + r) * 3;
      if (c < 3) {
        v = pr[c];
      } else if (c < 3 + 3 * F) {
        const int k = c - 3;
        v = sinf(pr[k / F] * P.pe_scale[k % F]);
      } else {
        const int k = c - 3 - 3 * F;
        v = cosf(pr[k / F] * P.pe_scale[k % F]);
      }
    }
    buf0[r * lds + c] = __float2bfloat16(v);
  }
  __syncthreads();

  const bf16* h = run_hidden_layers(C, wpack, bpack, buf0, buf1, lds, buf0, lds,
                                    GRAD ? zs : nullptr, ldz, stage);
  const int L = C.n_layers;
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
  if (!GRAD) return;
  __syncthreads();

  // adjoint sweep (fused_mlp.py:327-359): v = e_0; s = bf16(v) W_l^T; v = s * act'(z_{l-1})
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
                         const float z = __bfloat162float(zl[r * ldz + c]);
                         vb[r * lds + c] = __float2bfloat16(t[i] * act_df(C.act, z, C.quad_a));
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
                     }
                   });
  __syncthreads();

  // d sdf / d x = J_enc^T adj[:, :pw] + sum comp * bf16(dw_k) * bf16(adj_grid * mask)
  if (threadIdx.x < TILE_M && row0 + threadIdx.x < n) {
    const int r = threadIdx.x;
    const float* a = sAdj + r * C.p0;
    float p[3];
#pragma unroll
    for (int t = 0; t < 3; ++t) p[t] = pos[(row0 + r) * 3 + t];
    float g[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float acc = 0.f;
      for (int i = 0; i < F; ++i) {
        const float s = P.pe_scale[i];
        const float sc = p[k] * s;
        acc += a[3 + k * F + i] * (cosf(sc) * s) + a[3 + 3 * F + k * F + i] * (-sinf(sc) * s);
      }
      g[k] = a[k] + acc;
    }
    const float cs = 1.f / (2.f * P.radius);
    float gg[3] = {0.f, 0.f, 0.f};
    for (int l = 0; l < P.levels; ++l) {
      float wa[3][2], dwa[3][2];
      cell_geom(P, l, p, wa, dwa);
      const bf16* T = sT + (r * P.levels + l) * ew;
      float A[16];
      for (int f = 0; f < P.feats; ++f)
        A[f] = round_bf16(a[P.pw + l * P.feats + f] * lmask[l * P.feats + f]);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int b0 = c & 1, b1 = (c >> 1) & 1, b2 = (c >> 2) & 1;
        const float d0 = round_bf16(dwa[0][b0] * wa[1][b1] * wa[2][b2] * cs);
        const float d1 = round_bf16(wa[0][b0] * dwa[1][b1] * wa[2][b2] * cs);
        const float d2 = round_bf16(wa[0][b0] * wa[1][b1] * dwa[2][b2] * cs);
        for (int f = 0; f < P.feats; ++f) {
          const float tv = __bfloat162float(T[f * 8 + c]);
          gg[0] += tv * d0 * A[f];
          gg[1] += tv * d1 * A[f];
          gg[2] += tv * d2 * A[f];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) grad[(row0 + r) * 3 + k] = g[k] + gg[k];
  }
}

extern "C" int mms_slot_sdf_fwd(const void* pos, int n, const void* table, const void* lmask,
                                const void* wpack, const void* bpack, int n_layers,
                                const int* in_dims, const int* out_dims, int hidden, int p0,
                                int act, float quad_a, int levels, int feats, int pk_shift,
                                const int* res, const int* dense, const int* ent_mask,
                                const int* row_off, float radius, float clip_hi, int smooth,
                                int pe_freqs, const float* pe_scale, void* sdf, void* geo,
                                int geo_width, void* grad, int with_grad, void* stream) {
  Chain C;
  if (fill_chain(C, n_layers, in_dims, out_dims, 0, hidden, p0, act, quad_a)) return -1;
  if (levels < 1 || levels > MAXLV || pe_freqs < 1 || pe_freqs > MAXPE || feats > 16 ||
      n_layers < 2)
    return -1;
  SlotParams P;
  P.levels = levels;
  P.feats = feats;
  P.pk_shift = pk_shift;
  for (int l = 0; l < levels; ++l) {
    P.res[l] = res[l];
    P.dense[l] = dense[l];
    P.ent_mask[l] = (unsigned)ent_mask[l];
    P.row_off[l] = row_off[l];
  }
  P.radius = radius;
  P.clip_hi = clip_hi;
  P.smooth = smooth;
  P.pe_freqs = pe_freqs;
  for (int i = 0; i < pe_freqs; ++i) P.pe_scale[i] = pe_scale[i];
  P.pw = 3 + 6 * pe_freqs;

  int width = p0 > hidden ? p0 : hidden;
  if (with_grad && out_dims[n_layers - 1] > width) width = out_dims[n_layers - 1];
  const int lds = width + PAD;
  const int ldz = hidden + PAD;
  size_t smem = 2 * (size_t)TILE_M * lds * sizeof(bf16) + (size_t)TILE_M * levels * 8 * feats * sizeof(bf16) +
                NWARPS * 256 * sizeof(float);
  if (with_grad)
    smem += (size_t)(n_layers - 1) * TILE_M * ldz * sizeof(bf16) + (size_t)TILE_M * p0 * sizeof(float);
  const int grid = (n + TILE_M - 1) / TILE_M;
  cudaError_t err;
  if (with_grad) {
    err = cudaFuncSetAttribute(slot_sdf_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    slot_sdf_kernel<true><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
        (const float*)pos, n, (const bf16*)table, (const float*)lmask, (const bf16*)wpack,
        (const float*)bpack, C, P, lds, ldz, (float*)sdf, (bf16*)geo, geo_width, (float*)grad);
  } else {
    err = cudaFuncSetAttribute(slot_sdf_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    slot_sdf_kernel<false><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
        (const float*)pos, n, (const bf16*)table, (const float*)lmask, (const bf16*)wpack,
        (const float*)bpack, C, P, lds, ldz, (float*)sdf, nullptr, 0, nullptr);
  }
  return (int)cudaGetLastError();
}
