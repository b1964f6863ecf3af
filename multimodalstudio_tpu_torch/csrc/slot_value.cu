// K2 (bf16 table) and K2f (f32 table), the slot-grid SDF value forward,
// redesigned for Hopper on K1's forward (k1.cuh chain_forward).
//
// Replaces the Pallas TPU kernel multimodalstudio_tpu/ops/pallas/slot_fused.py
// _value_fwd_kernel (:1307, call :1633), reached through fused_slot_sdf_value
// (:1772): sdf only, for the sampler's queries and the curvature taps.
//
// Persistent CTAs; a producer warpgroup streams the chain's forward images,
// which k1_pack wrote (the last layer cut to its sdf column: one 16-column
// piece), through the bulk-copy ring; each consumer warpgroup owns a 64-row
// tile. In place of K1's row loader the tile's chain input is built in the
// activation images: per (sample, level) one thread computes the cell
// geometry from the raw position (slot.cuh: clip, floor, dense index or
// uint32 XOR hash, smoothstep trilerp weights), reads the entry's 8 corners of
// each feature from the f32 table parameter as two 16-byte loads (a bf16
// table rounds them to bf16 as it reads them, in place of a cast of the whole
// table before each call) and sums them;
// per sample the NeRF encoding [x, sin(x_d s_i), cos(x_d s_i)] with sinf /
// cosf (no fast math). The layers then run as K1's: wgmma on the staged
// images, the bias seeding the accumulators, the hidden epilogues writing the
// next layer's images in place.
//
// Cast points as the reference's and as the first design's: with a bf16 table,
// table value, trilerp weight and their product each rounded to bf16 before
// the f32 8-corner sum; with an f32 table the grid side stays f32; the sum
// times the coarse-to-fine mask rounded to bf16 into x0; a skip layer's input
// concat(h, x0) / sqrt(2) rounded to bf16; the hidden activation rounded to
// bf16; sdf, column 0 of the last layer, stays f32 (K1 rounds its y to bf16).
// Training mode also writes what the unchanged backwards read: the bf16
// pre-activations zs [L-1, N, H] row-major (slot_bwd.cuh) and, for the split
// backward, the chain input x0 [N, x0_width] bf16 (slot_fused.py:1626-1630).
//
// Bound on an H100: the chain's tensor-core work (2 N (d_in H + (L-2) H^2 + H)
// flops) against 16 bytes of position and sdf per sample and the table, which
// stays in L2; both are far under the time the front's lookups and the
// layers' epilogues take (PERF.md has the times).
#include "k1.cuh"
#include "slot.cuh"

namespace k1 {

// the 8 corner values of one feature of an entry
__device__ __forceinline__ void corners(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// The tile's chain input x0 = [pos, sin, cos, grid of the active levels, 0]
// rounded to bf16 into activation columns [c0, c0 + P0), zero past n, by the
// warpgroup's 128 threads. TT: the table's type, which sets the grid side's
// roundings; the table arrives as its f32 parameter.
template <class TT>
__device__ __forceinline__ void slot_rows(const mms::SlotParams& P, const float* __restrict__ pos,
                                          int n, long long row0, const float* __restrict__ table,
                                          const float* __restrict__ lmask, bf16* act, int c0,
                                          int P0) {
  const int t = threadIdx.x & 127;
  const int k = P.levels, F = P.feats, pw = P.pw, grid_end = pw + k * F;
  for (int i = t; i < 64 * k; i += 128) {  // grid: one (sample, level) per thread
    const int r = i / k, l = i - r * k;
    const long long row = row0 + r;
    if (row >= n) {
      for (int f = 0; f < F; ++f) act[act_el(c0 + pw + l * F + f, r)] = __float2bfloat16(0.f);
      continue;
    }
    float p[3];
    mms::load_pos(pos, n, row, p);
    float wa[3][2], dwa[3][2], ddwa[3][2];
    const unsigned e = mms::cell_geom(P, l, p, wa, dwa, ddwa);
    float wb[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) wb[c] = mms::corner_weight<TT>(wa, c);
    const float* T = table + mms::entry_offset(P, l, e);
    for (int f = 0; f < F; ++f) {
      float v[8];
      corners(T + f * 8, v);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        acc += mms::grid_round<TT>(mms::grid_round<TT>(v[c]) * wb[c]);
      act[act_el(c0 + pw + l * F + f, r)] = __float2bfloat16(acc * lmask[l * F + f]);
    }
  }
  for (int i = t; i < 64 * pw; i += 128) {  // the NeRF encoding
    const int r = i / pw, c = i - r * pw;
    const long long row = row0 + r;
    const float v = row < n ? mms::pe_col(pos + row * 3, P.pe_freqs, P.pe_scale, c) : 0.f;
    act[act_el(c0 + c, r)] = __float2bfloat16(v);
  }
  const int rest = P0 - grid_end;  // the inactive levels and the padding
  for (int i = t; i < 64 * rest; i += 128) {
    const int r = i / rest;
    act[act_el(c0 + grid_end + i - r * rest, r)] = __float2bfloat16(0.f);
  }
}

// What a launch writes: sdf [n] f32; in training mode (or null) zs [L-1, n, H]
// bf16 and x0 [n, x0_width] bf16.
struct ValueOut {
  float* sdf;
  bf16* zs;
  bf16* x0;
  int x0_width;
};

template <class TT, bool WIDE>
__global__ void __launch_bounds__(NTHREADS, 1)
slot_value_kernel(const Geom G, const mms::SlotParams P, const float* __restrict__ pos, int n,
                  const float* __restrict__ table, const float* __restrict__ lmask,
                  const bf16* __restrict__ wfw, const float* __restrict__ bpk, const ValueOut O,
                  int nwg, int stages, int sb, int act_bytes) {
  extern __shared__ uint8_t smem_raw[];
  const int r0 = acc_row(), cq = acc_col();
  chain_forward<WIDE>(
      align1024(smem_raw), G, n, wfw, bpk, nwg, stages, sb, act_bytes,
      [&](bf16* act, int c0, long long row0) {
        slot_rows<TT>(P, pos, n, row0, table, lmask, act, c0, G.P0);
        if (!O.x0) return;
        wg_sync(1 + (threadIdx.x >> 7));  // the other threads' columns
        const int w = O.x0_width;
        for (int i = threadIdx.x & 127; i < 64 * w; i += 128) {
          const int r = i / w, c = i - r * w;
          if (row0 + r < n) O.x0[(row0 + r) * w + c] = act[act_el(c0 + c, r)];
        }
      },
      [&](int l, int off, auto NC, const auto& acc, long long row0) {  // zs = bf16(z)
        constexpr int N = decltype(NC)::value;
        if (!O.zs) return;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const long long gr = row0 + r0 + 8 * e;
            bf16* z = O.zs + ((long long)l * n + gr) * G.H + off + 8 * j + cq;
            if (gr < n)
              *reinterpret_cast<uint32_t*>(z) = pack2(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
          }
        }
      },
      [&](int off, auto, const auto& acc, long long row0) {  // sdf: column 0, f32
        if (off || cq) return;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long gr = row0 + r0 + 8 * e;
          if (gr < n) O.sdf[gr] = acc[2 * e];
        }
      });
}

template <class TT, bool WIDE>
static int launch_value(const Geom& G, const mms::SlotParams& P, const float* pos, int n,
                        const float* table, const float* lmask, const bf16* wfw, const float* bpk,
                        const ValueOut& O, cudaStream_t stream) {
  const void* kernel = (const void*)slot_value_kernel<TT, WIDE>;
  const int tiles = (n + 63) / 64;
  Launch L;
  if (plan_chain(G, tiles, false, 0, &L)) return ERR_SMEM;
  cudaError_t err = allow_smem(2 * std::is_same<TT, float>::value + WIDE, kernel);
  if (err != cudaSuccess) return (int)err;
  err = persistent(kernel, &L, (tiles + L.nwg - 1) / L.nwg);
  if (err != cudaSuccess) return (int)err;
  slot_value_kernel<TT, WIDE><<<L.grid, L.threads, L.smem, stream>>>(
      G, P, pos, n, table, lmask, wfw, bpk, O, L.nwg, L.stages, L.sb, L.act_bytes);
  return (int)cudaGetLastError();
}

}  // namespace k1

// One launch of K2 (table_f32 0) or K2f (1): sdf [n] f32 and, where given, zs
// and x0. G: the chain with its last layer cut to column 0 (fused_mlp.py
// chain_layout); P: the grid and the encoding (slot.cuh); table: [rows, 128]
// f32, rounded to bf16 as it is read for K2; wfw, bpk: k1_pack's forward images
// and biases of that chain.
extern "C" int mms_slot_value_fwd(const k1::Geom* G, const mms::SlotParams* P, const void* pos,
                                  int n, const void* table, int table_f32, const void* lmask,
                                  const void* wfw, const void* bpk, void* sdf, void* zs, void* x0,
                                  int x0_width, void* stream) {
  if (!k1::geom_ok(*G) || n < 1 || P->levels < 1 || P->levels > mms::MAXLV || P->feats < 1 ||
      P->feats > 16 || P->pe_freqs < 1 || P->pe_freqs > mms::MAXPE ||
      P->pw + P->levels * P->feats > G->d_in || (x0 && (x0_width < G->d_in || x0_width > G->P0)))
    return -1;
  const k1::ValueOut O{(float*)sdf, (k1::bf16*)zs, (k1::bf16*)x0, x0_width};
  const auto launch = table_f32 ? (k1::is_wide(*G) ? k1::launch_value<float, true>
                                                   : k1::launch_value<float, false>)
                                : (k1::is_wide(*G) ? k1::launch_value<k1::bf16, true>
                                                   : k1::launch_value<k1::bf16, false>);
  return launch(*G, *P, (const float*)pos, n, (const float*)table, (const float*)lmask,
                (const k1::bf16*)wfw, (const float*)bpk, O, (cudaStream_t)stream);
}
