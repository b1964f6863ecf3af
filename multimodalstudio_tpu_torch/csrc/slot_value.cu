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
// Training mode also writes what the backward (slot_chain_bwd.cu's value mode) reads:
// the bf16 pre-activations zs [L-1, N, H] row-major, and where asked the chain input x0
// [N, x0_width] bf16 (slot_fused.py:1626-1630).
//
// Bound on an H100: the chain's tensor-core work (2 N (d_in H + (L-2) H^2 + H)
// flops) against 16 bytes of position and sdf per sample and the table, which
// stays in L2; both are far under the time the front's lookups and the
// layers' epilogues take (PERF.md has the times).
#include "slot_rows.cuh"

namespace k1 {

// What a launch writes: sdf [n] f32; in training mode (or null) zs [L-1, n, H]
// bf16 and x0 [n, x0_width] bf16.
struct ValueOut {
  float* sdf;
  bf16* zs;
  bf16* x0;
  int x0_width;
};

template <class TT, int WC>
__global__ void __launch_bounds__(NTHREADS, 1)
slot_value_kernel(const Geom G, const mms::SlotParams P, const float* __restrict__ pos, int n,
                  const float* __restrict__ table, const float* __restrict__ lmask,
                  const bf16* __restrict__ wfw, const float* __restrict__ bpk, const ValueOut O,
                  bf16* dev_act, int nwg, int stages, int sb, int act_bytes) {
  extern __shared__ uint8_t smem_raw[];
  const int r0 = acc_row(), cq = acc_col();
  chain_forward<WC>(
      align1024(smem_raw), G, n, wfw, bpk, nwg, stages, sb, act_bytes, dev_act,
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

// The kernel of G's width class and table type, and its launch plan over n rows.
static int value_plan(const Geom& G, int table_f32, int n, const void** kernel, Launch* L) {
  *kernel = with_wc(G, [&](auto WC) {
    constexpr int wc = decltype(WC)::value;
    return table_f32 ? (const void*)slot_value_kernel<float, wc>
                     : (const void*)slot_value_kernel<bf16, wc>;
  });
  const int tiles = (n + 63) / 64;
  if (plan_chain(G, tiles, false, 0, L)) return ERR_SMEM;
  cudaError_t err = allow_smem(3 * table_f32 + width_class(G), *kernel);
  if (err != cudaSuccess) return (int)err;
  return (int)persistent(*kernel, L, (tiles + L->nwg - 1) / L->nwg);
}

}  // namespace k1

static bool value_ok(const k1::Geom* G, const mms::SlotParams* P, int n) {
  return k1::geom_ok(*G) && n >= 1 && P->levels >= 1 && P->levels <= mms::MAXLV &&
         P->feats >= 1 && P->feats <= 16 && P->pe_freqs >= 1 && P->pe_freqs <= mms::MAXPE &&
         P->pw + P->levels * P->feats <= G->d_in;
}

// Bytes of device scratch a launch over n rows needs: the activation slabs of a
// hidden width over 512 (k1.cuh WC_DEV), else 0.
extern "C" long long mms_slot_value_fwd_bytes(const k1::Geom* G, const mms::SlotParams* P, int n,
                                              int table_f32) {
  if (!value_ok(G, P, n)) return -1;
  if (k1::width_class(*G) != k1::WC_DEV) return 0;
  k1::Launch L;
  const void* kernel;
  const int status = k1::value_plan(*G, table_f32, n, &kernel, &L);
  if (status) return status == k1::ERR_SMEM ? k1::ERR_SMEM : -1;
  return (long long)k1::align256((size_t)L.grid * L.nwg * L.act_bytes);
}

// One launch of K2 (table_f32 0) or K2f (1): sdf [n] f32 and, where given, zs
// and x0. G: the chain with its last layer cut to column 0 (fused_mlp.py
// chain_layout); P: the grid and the encoding (slot.cuh); table: [rows, 128]
// f32, rounded to bf16 as it is read for K2; wfw, bpk: k1_pack's forward images
// and biases of that chain; scratch: mms_slot_value_fwd_bytes of device memory
// (or null).
extern "C" int mms_slot_value_fwd(const k1::Geom* G, const mms::SlotParams* P, const void* pos,
                                  int n, const void* table, int table_f32, const void* lmask,
                                  const void* wfw, const void* bpk, void* sdf, void* zs, void* x0,
                                  int x0_width, void* scratch, void* stream) {
  if (!value_ok(G, P, n) || (x0 && (x0_width < G->d_in || x0_width > G->P0)) ||
      (k1::width_class(*G) == k1::WC_DEV && !scratch))
    return -1;
  const k1::ValueOut O{(float*)sdf, (k1::bf16*)zs, (k1::bf16*)x0, x0_width};
  k1::Launch L;
  const void* kernel;
  const int status = k1::value_plan(*G, table_f32, n, &kernel, &L);
  if (status) return status;
  k1::with_wc(*G, [&](auto WC) {
    constexpr int wc = decltype(WC)::value;
    const auto args = [&](auto kern) {
      kern<<<L.grid, L.threads, L.smem, (cudaStream_t)stream>>>(
          *G, *P, (const float*)pos, n, (const float*)table, (const float*)lmask,
          (const k1::bf16*)wfw, (const float*)bpk, O, (k1::bf16*)scratch, L.nwg, L.stages, L.sb,
          L.act_bytes);
    };
    if (table_f32)
      args(k1::slot_value_kernel<float, wc>);
    else
      args(k1::slot_value_kernel<k1::bf16, wc>);
    return 0;
  });
  return (int)cudaGetLastError();
}
