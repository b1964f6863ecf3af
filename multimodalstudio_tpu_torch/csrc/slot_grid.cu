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
// backward. The card reads each sample's entry directly (the entry's absolute index e; its
// values are floats e*8F .. e*8F + 8F - 1 of the table, lane f*8 + p for feature f of
// corner p), and the backward reads it again instead of a residual.
//
// What bounds K6 on an H100: device-memory bytes. A (sample, level) moves an 8-byte index,
// 32 bytes of w and 96 of dw (with tangents), and 16F bytes of outputs (the table, 1.5 MB at
// the flagship size, stays in L2); the backward adds its cotangents and d_w and d_dw, and
// needs the index and weights only of a (sample, level) whose cotangents are not all zero;
// its reductions on the dense coarse level take every sample. The first design ran a thread
// per (sample, level) both ways, reading w and dw a float at a time, and added each value of
// the backward's table cotangent by its own f32 atomic. The design:
// - the forward keeps a thread per (sample, level) in memory order: every operand is
//   row-major [N, (3,) k, .], so a warp's reads and writes are contiguous runs, and at F = 2
//   a thread does a (sample, level)'s work without the shuffles and repeated roundings that
//   lanes sharing it would need (lane groups walking runs at one level, the backward's
//   design, read those operands level-strided and ran 1.5-2x slower, NVIDIA H100 80GB HBM3,
//   700 W); w, dw and the entry are read as 16-byte loads, the entry's all in flight at once;
// - the backward's block takes one level and 128 / G lane groups of G = 2F lanes: lane j
//   holds 16 bytes of the entry, corners 4h .. 4h + 3 of feature f = j >> 1 (h = j & 1), so a
//   group reads an entry whole and a (sample, level)'s w and dw as whole 32-byte sectors; a
//   group walks a run of up to 32 consecutive samples (group_run), the next sample's index,
//   w, dw and cotangents read a sample ahead into registers (staging a batch of 8 samples in
//   shared memory by cp.async was no faster at the main path's largest calls and slower at
//   the small ones; capping the registers for more warps was slower);
// - the backward skips a block whose cotangents at its level are all zero (the levels the
//   coarse-to-fine mask cuts: no index, weight or entry read, nothing added, its d_w and
//   d_dw written zero), and within a block a sample whose cotangents are all zero (a ballot
//   over the group); a group reads its entry only when it moves (along a ray a coarse level's
//   entry holds for tens of samples). d_w and d_dw sum over the group's features by a
//   butterfly. A lane sums its table cotangent in registers while the group's entry stays
//   and adds it by one red.global.add.v4.f32 when the entry moves or the run ends; the order
//   of those f32 sums changes from run to run.
//
// Cast points in bf16-table mode (_fwd_kernel :509-523, _bwd_kernel :578-629): T, w and dw
// rounded to bf16; enc = sum_p bf16(T * w_p) and tenc_t = sum_p bf16(T * dw_t,p) in f32;
// gt = bf16(genc), gtk = bf16(gtenc_t); d_w[p] = sum_f bf16(T * gt), d_dw the same with gtk;
// u = gt * w + sum_t gtk * dw_t in f32 (in that order), rounded to bf16 per sample before it
// joins a lane's f32 sum, which is never rounded. The f32 table runs the same sums without
// the roundings. Compiled without fused multiply-adds (build.py), so each product is rounded
// before its sum, as in the reference.
//
// K6v replaces the same two Pallas kernels in the vertex layout (exact C0; F = 16, an f32
// table, the TPU's copy gather: _fwd_kernel's vertex branch :487-507, _bwd_kernel's
// :645-662). idx is [N, k*8]: column l*8 + p is the absolute row of the corner of parity p,
// and that corner's feature f is lane f*8 + p of its row, so a corner's 16 values span all
// 16 sectors of its 512-byte row. What bounds it on an H100: the L2 sectors of the distinct
// rows a sample reads at a level (1 to 8, 3.4 on average at uniform positions; the 6.3 MB
// table stays in L2), the device-memory bytes of idx, w, dw and the outputs (448 bytes a
// sample and level with tangents), the instructions a warp spends a sample, and in the
// backward the atomics on the dense coarse level, where every sample lands. The design:
// - a warp walks a run of up to 32 consecutive samples at one level (a block: 4 runs of one
//   level); the run's idx, w and dw, and the backward's cotangents, are staged into shared
//   memory by cp.async, 16 bytes a lane;
// - lane j follows slot j & 7. Per sample the slots whose row moved are found by a ballot,
//   their distinct rows by __match_any_sync, and each distinct row is copied once, 32 lanes
//   x 16 bytes, into the warp's row buffer; a lane then reads its 4 values there (float q
//   of quad j: feature j >> 1 at parity 4(j & 1) + q). A slot whose row did not move keeps
//   its values: along a ray a corner keeps its parity, so its slot, and a coarse level's
//   rows repeat for tens of samples;
// - enc[f] and tenc are the lane's 4 parities plus its pair lane's (one shuffle each, fused
//   multiply-adds: no cast points to keep); even lanes store enc and the first tangent, odd
//   lanes the other two, 64 bytes each;
// - the backward skips a run, and within a run a sample, whose cotangents are all zero (a
//   level the coarse-to-fine mask cuts): no row read, nothing added, d_w and d_dw zero.
//   d_w and d_dw sum over the 16 lanes of a half by a butterfly that halves the values each
//   step (15 shuffles for 32 sums). A slot that keeps its row sums its table cotangent in
//   registers until the row moves or the run ends; then 4 slots of one row go as one
//   red.global.add.v4.f32, 2 adjacent ones as a .v2, others one by one. The order of those
//   f32 sums changes from run to run.
#include <initializer_list>

#include "chain.cuh"
#include "warp.cuh"

using namespace mms;

namespace {

__device__ __forceinline__ float rnd(float x, bool bf) { return bf ? round_bf16(x) : x; }

__device__ __forceinline__ float4 rnd4(float4 v, bool bf) {
  return bf ? make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w)) : v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// ---- K6: the cell layout's lookup.

// 4 corners times 4 weights, each product rounded in bf16 mode, summed in order.
__device__ __forceinline__ float dot4r(const float4& T, const float4& a, bool bf) {
  float s = rnd(T.x * a.x, bf);
  s = s + rnd(T.y * a.y, bf);
  s = s + rnd(T.z * a.z, bf);
  return s + rnd(T.w * a.w, bf);
}

// K6's forward: a thread per (sample, level) in memory order. Every operand is row-major
// [N, (3,) k, .], so a warp's 32 (sample, level)s read idx, w and dw and write enc and tenc as
// contiguous runs; a thread reads its entry as 2F 16-byte loads (L2), all in flight at once,
// and its w and dw as 16-byte loads.
constexpr int FBLOCK = 256;

template <int F, bool TANG>
__global__ void __launch_bounds__(FBLOCK)
slot_lookup_fwd_kernel(const float* __restrict__ table, const long long* __restrict__ idx,
                       const float* __restrict__ w, const float* __restrict__ dw, int n, int k,
                       bool bf, float* __restrict__ enc, float* __restrict__ tenc) {
  const long long i = (long long)blockIdx.x * FBLOCK + threadIdx.x;
  if (i >= (long long)n * k) return;
  const long long s = i / k;
  const int l = (int)(i - s * k);
  const float* T = table + __ldg(idx + i) * (8 * F);
  float4 wq[2], dq[3][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    wq[h] = rnd4(ld4(w + i * 8 + 4 * h), bf);
    if (TANG) {
#pragma unroll
      for (int t = 0; t < 3; ++t)
        dq[t][h] = rnd4(ld4(dw + ((s * 3 + t) * k + l) * 8 + 4 * h), bf);
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float4 lo = rnd4(ld4(T + f * 8), bf), hi = rnd4(ld4(T + f * 8 + 4), bf);
    enc[i * F + f] = dot4r(lo, wq[0], bf) + dot4r(hi, wq[1], bf);
    if (TANG) {
#pragma unroll
      for (int t = 0; t < 3; ++t)
        tenc[((s * 3 + t) * k + l) * F + f] = dot4r(lo, dq[t][0], bf) + dot4r(hi, dq[t][1], bf);
    }
  }
}

// K6's backward.

constexpr int CBLOCK = 128;  // threads of a K6 backward block: 128 / (2F) groups of one level

// A lane's group: G = 2F lanes, lane j holding corners 4h .. 4h + 3 of feature f = j >> 1
// (h = j & 1), 16 bytes of the entry; the group walks samples [sb, se) at level l.
struct CellGroup {
  int l, j, f, h;
  unsigned gm;  // the group's lanes
  long long sb, se;
};

template <int F>
__device__ __forceinline__ CellGroup cell_group(int n, int k, int seg) {
  constexpr int G = 2 * F;
  CellGroup c;
  c.l = (int)(blockIdx.x % k);
  c.j = threadIdx.x % G;
  c.f = c.j >> 1;
  c.h = c.j & 1;
  c.gm = group_mask<G>();
  c.sb = ((long long)(blockIdx.x / k) * (CBLOCK / G) + threadIdx.x / G) * seg;
  c.se = min(c.sb + seg, (long long)n);
  return c;
}

// A sample's inputs at the group's level, read a sample ahead: its entry, the lane's half of
// w and dw and the lane's feature of its cotangents.
template <int NQ>
struct CellIn {
  long long e;
  float4 w, dw[3];
  float g[NQ];
};

template <int F, bool TANG>
__device__ __forceinline__ void cell_load(CellIn<TANG ? 4 : 1>& in, const CellGroup& c,
                                          const long long* __restrict__ idx,
                                          const float* __restrict__ w,
                                          const float* __restrict__ dw,
                                          const float* __restrict__ genc,
                                          const float* __restrict__ gtenc, long long s, int k) {
  const long long sl = s * k + c.l;
  in.e = __ldg(idx + sl);
  in.w = ld4(w + sl * 8 + 4 * c.h);
  in.g[0] = genc[sl * F + c.f];
  if (TANG) {
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      in.dw[t] = ld4(dw + ((s * 3 + t) * k + c.l) * 8 + 4 * c.h);
      in.g[1 + t] = gtenc[((s * 3 + t) * k + c.l) * F + c.f];
    }
  }
}

// Whether any of the F floats at p (8-byte aligned for F = 2, else 16-byte) is not zero.
template <int F>
__device__ __forceinline__ bool any_nonzero(const float* p) {
  if constexpr (F == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    return v.x != 0.f || v.y != 0.f;
  } else {
    bool nz = false;
#pragma unroll
    for (int q = 0; q < F; q += 4) {
      const float4 v = ld4(p + q);
      nz |= v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
    }
    return nz;
  }
}

template <int F, bool TANG>
__global__ void __launch_bounds__(CBLOCK)
slot_lookup_bwd_kernel(const float* __restrict__ table, const long long* __restrict__ idx,
                       const float* __restrict__ w, const float* __restrict__ dw,
                       const float* __restrict__ genc, const float* __restrict__ gtenc, int n,
                       int k, int seg, bool bf, float* __restrict__ d_table,
                       float* __restrict__ d_w, float* __restrict__ d_dw) {
  constexpr int NQ = TANG ? 4 : 1;  // the cotangent's quantities: enc (and 3 tangents)
  constexpr int G = 2 * F;
  const CellGroup c = cell_group<F>(n, k, seg);
  // the (sample, level) row of quantity q: genc and d_w (q = 0), or gtenc and d_dw of
  // tangent q - 1
  const auto at = [&](long long s, int q) {
    return q == 0 ? s * k + c.l : (s * 3 + q - 1) * k + c.l;
  };
  // the block's samples; a block whose cotangents are all zero (a level the coarse-to-fine
  // mask cuts) reads no index, weight or entry and adds nothing: it writes zero d_w and d_dw
  const long long s0 = (long long)(blockIdx.x / k) * (CBLOCK / G) * seg;
  const long long ns = min(s0 + (long long)(CBLOCK / G) * seg, (long long)n) - s0;
  bool nz = false;
#pragma unroll 4
  for (long long i = threadIdx.x; i < ns * NQ; i += CBLOCK) {
    const int q = (int)(i % NQ);
    nz |= any_nonzero<F>((q == 0 ? genc : gtenc) + at(s0 + i / NQ, q) * F);
  }
  if (!__syncthreads_or(nz)) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (long long i = threadIdx.x; i < ns * NQ * 2; i += CBLOCK) {
      const int q = (int)(i % (NQ * 2)) >> 1;
      reinterpret_cast<float4*>((q == 0 ? d_w : d_dw) + at(s0 + i / (NQ * 2), q) * 8)[i & 1] = z;
    }
    return;
  }
  CellIn<NQ> nx;
  if (c.sb < c.se) cell_load<F, TANG>(nx, c, idx, w, dw, genc, gtenc, c.sb, k);
  long long key = -1;
  float4 T = make_float4(0.f, 0.f, 0.f, 0.f);
  float pend[4] = {0.f, 0.f, 0.f, 0.f};  // the lane's table cotangent not yet added
  for (long long s = c.sb; s < c.se; ++s) {
    const CellIn<NQ> in = nx;
    if (s + 1 < c.se) cell_load<F, TANG>(nx, c, idx, w, dw, genc, gtenc, s + 1, k);
    float cq[NQ];
    bool live = false;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      cq[q] = rnd(in.g[q], bf);
      live |= cq[q] != 0.f;
    }
    float v[4 * NQ];  // the lane's d_w (and d_dw) terms of corners 4h + q, then their sums
#pragma unroll
    for (int i = 0; i < 4 * NQ; ++i) v[i] = 0.f;
    // a sample whose cotangents are all zero reads no entry and adds nothing
    if (__any_sync(c.gm, live)) {
      if (in.e != key) {  // the entry moved: add the sums of the old one, read the new one
        if (key >= 0) red4_nonzero(d_table + key * (8 * F) + 4 * c.j, pend);
        key = in.e;
        T = rnd4(ld4(table + key * (8 * F) + 4 * c.j), bf);
#pragma unroll
        for (int q = 0; q < 4; ++q) pend[q] = 0.f;
      }
      const float4 wq = rnd4(in.w, bf);
      float4 dq[3];
      if (TANG) {
#pragma unroll
        for (int t = 0; t < 3; ++t) dq[t] = rnd4(in.dw[t], bf);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float tv = comp(T, q);
        v[q] = rnd(tv * cq[0], bf);
        float u = cq[0] * comp(wq, q);
        if (TANG) {
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            v[4 * (1 + t) + q] = rnd(tv * cq[1 + t], bf);
            u = u + cq[1 + t] * comp(dq[t], q);
          }
        }
        pend[q] += rnd(u, bf);
      }
      // d_w[4h + q] (and d_dw's) sum over the group's features: the lanes of equal h
#pragma unroll
      for (int m = 2; m < G; m <<= 1) {
#pragma unroll
        for (int i = 0; i < 4 * NQ; ++i) v[i] += __shfl_xor_sync(c.gm, v[i], m);
      }
    }
    // lane (f, h) stores half h of quantities f, f + F, ...: d_w, then d_dw's tangents
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if (q % F == c.f)
        reinterpret_cast<float4*>((q == 0 ? d_w : d_dw) + at(s, q) * 8)[c.h] =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  }
  if (key >= 0) red4_nonzero(d_table + key * (8 * F) + 4 * c.j, pend);
}

// ---- K6v: the vertex layout's lookup, a warp per (run of samples, level).

constexpr int VF = 16;       // features per vertex in the vertex layout
constexpr int VRUN = 32;     // the longest run of consecutive samples a warp walks
constexpr int VBLOCK = 128;  // threads of a K6v block: 4 warps of one level
constexpr int VROWS = 8 * 128;  // shared-memory floats of a warp's row buffer, a row a slot

// Shared-memory floats of one warp: its row buffer, then its run's staged inputs: the corner
// rows (int64, 16 words a sample), w (8) and dw (24); the backward adds the cotangents genc
// (16) and gtenc (48).
__host__ __device__ constexpr int stage_words(bool bwd, bool tang) {
  return VROWS + VRUN * ((16 + 8 + (tang ? 24 : 0)) + (bwd ? 16 + (tang ? 48 : 0) : 0));
}

// Copy `rows` of `words` floats each (a multiple of 4), the i-th from src + i * stride, to
// dst + i * words, 16 bytes a lane at a time: 4 lanes share a 64-byte row.
__device__ __forceinline__ void stage(float* dst, const float* src, long long stride, int rows,
                                     int words, int lane) {
  const int chunks = words / 4;
  for (int c = lane; c < rows * chunks; c += 32) {
    const int i = c / chunks, part = c - i * chunks;
    cp16(dst + i * words + part * 4, src + i * stride + part * 4);
  }
}

// A warp's run (a block's 4 warps take 4 consecutive runs at one level, so that a level the
// backward skips frees its blocks at once) and its shared memory.
struct VertexRun {
  int l, cnt;       // level, samples in the run
  long long s0;     // first sample
  float* rows;      // row buffer: slot p's row at rows[p * 128]
  const int* keys;  // staged idx: sample i's corner row of parity p at keys[(i * 8 + p) * 2]
  const float* w;   // staged w, [VRUN][8]
  const float* dw;  // staged dw, [3][VRUN][8]

  __device__ __forceinline__ bool init(int n, int k, int run, float* smem) {
    l = (int)(blockIdx.x % k);
    s0 = ((long long)(blockIdx.x / k) * (VBLOCK / 32) + (threadIdx.x >> 5)) * run;
    if (s0 >= n) return false;
    cnt = (int)min((long long)run, (long long)n - s0);
    rows = smem;
    keys = reinterpret_cast<const int*>(smem + VROWS);
    w = smem + VROWS + VRUN * 16;
    dw = w + VRUN * 8;
    return true;
  }

  // Stage the run's idx, w (and dw) into the warp's shared memory.
  __device__ __forceinline__ void stage_geometry(float* smem, const long long* __restrict__ idx,
                                                 const float* __restrict__ wg,
                                                 const float* __restrict__ dwg, int k, int lane,
                                                 bool tang) const {
    const long long sl = s0 * k + l;
    float* dst = smem + VROWS;
    stage(dst, reinterpret_cast<const float*>(idx + sl * 8), 16LL * k, cnt, 16, lane);
    stage(dst + VRUN * 16, wg + sl * 8, 8LL * k, cnt, 8, lane);
    if (tang) {
#pragma unroll
      for (int t = 0; t < 3; ++t)
        stage(dst + VRUN * 24 + t * VRUN * 8, dwg + (s0 * 3 * k + t * k + l) * 8, 24LL * k, cnt,
              8, lane);
    }
  }
};

// A lane's corners of the warp's current sample. Lane j keeps the row of slot j & 7 (the
// corner of that parity; the 4 lanes of one slot agree) and T[q], its value of slot 4h + q:
// table[row, f*8 + 4h + q] with f = j >> 1, h = j & 1, i.e. float q of the row's quad j.
struct VertexCorners {
  int key = -1;  // the row of slot j & 7
  int next;      // that slot's row at the sample `peek` read
  float T[4];

  // Read sample i's row of the lane's slot; the mask of the slots whose row changes
  // (warp-uniform). Along a ray the next sample shares most corners, and a corner keeps its
  // parity, so its slot: those rows are not read again.
  __device__ __forceinline__ unsigned peek(const VertexRun& r, int i, int lane) {
    next = r.keys[(i * 8 + (lane & 7)) * 2];  // the low word: a table has < 2^31 rows
    return __ballot_sync(FULL, next != key) & 0xffu;
  }

  // Slot p's row (before fetch: the last sample's).
  __device__ __forceinline__ int slot_row(int p) const { return __shfl_sync(FULL, key, p); }

  // Move to the peeked sample, whose slots `moved` changed row: each distinct row among them
  // is copied once into its first slot's buffer, 32 lanes x 16 bytes (all 8 corners share
  // one row where every grid coordinate is even, and a hashed level may alias two groups);
  // then each lane reads its values of the moved slots from there.
  __device__ __forceinline__ void fetch(const VertexRun& r, const float* __restrict__ table,
                                        unsigned moved, int lane) {
    const int a = lane & 7, h = lane & 1;
    const bool mv = moved >> a & 1;
    // the first moved slot with this slot's row (an unmoved slot matches only itself)
    const unsigned same = __match_any_sync(FULL, mv ? next : (int)(0x80000000u | a)) & 0xffu;
    const int src = __ffs(same) - 1;
    unsigned need = __ballot_sync(FULL, mv && src == a) & 0xffu;
    __syncwarp();  // every lane's reads of the last sample's rows are done
    while (need) {
      const int p = __ffs(need) - 1;
      need &= need - 1;
      const unsigned row = (unsigned)__shfl_sync(FULL, next, p);
      cp16(r.rows + p * 128 + 4 * lane, table + (size_t)row * 128 + 4 * lane);
    }
    cp_wait();
    key = next;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = 4 * h + q, s = __shfl_sync(FULL, src, p);
      if (moved >> p & 1) T[q] = r.rows[s * 128 + 4 * lane + q];
    }
  }
};

// K6v is exact f32 (no cast points to keep), so its sums take fused multiply-adds, which
// the build's --fmad=false leaves to the intrinsic.
__device__ __forceinline__ float dot4(const float (&T)[4], const float4& a) {
  return __fmaf_rn(T[3], a.w, __fmaf_rn(T[2], a.z, __fmaf_rn(T[1], a.y, T[0] * a.x)));
}

// Add the lane's pending table cotangents of its slots 4h + q in `fl` into their rows kq[q]:
// slot p's value is lane f*8 + p of its row, float p & 3 of the lane's quad. Four slots of
// one row go as one v4 reduction, two adjacent ones as a v2, the rest one by one; zeros are
// skipped (an all-zero sample adds nothing).
__device__ __forceinline__ void flush_rows(float* __restrict__ d_table, const int (&kq)[4],
                                           unsigned fl, int lane, const float (&pend)[4]) {
  const unsigned m = (fl >> (4 * (lane & 1))) & 15;
  if (!m) return;
  auto at = [&](int q) { return d_table + (size_t)(unsigned)kq[q] * 128 + 4 * lane + q; };
  if (m == 15 && kq[0] == kq[1] && kq[0] == kq[2] && kq[0] == kq[3]) {
    if (pend[0] != 0.f || pend[1] != 0.f || pend[2] != 0.f || pend[3] != 0.f)
      red4(at(0), pend[0], pend[1], pend[2], pend[3]);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; q += 2) {
    const unsigned pm = (m >> q) & 3;
    if (pm == 3 && kq[q] == kq[q + 1]) {
      if (pend[q] != 0.f || pend[q + 1] != 0.f) red2(at(q), pend[q], pend[q + 1]);
    } else {
      if ((pm & 1) && pend[q] != 0.f) red1(at(q), pend[q]);
      if ((pm & 2) && pend[q + 1] != 0.f) red1(at(q + 1), pend[q + 1]);
    }
  }
}

template <bool TANG>
__global__ void __launch_bounds__(VBLOCK)
slot_vertex_fwd_kernel(const float* __restrict__ table, const long long* __restrict__ idx,
                       const float* __restrict__ w, const float* __restrict__ dw, int n, int k,
                       int run, float* __restrict__ enc, float* __restrict__ tenc) {
  extern __shared__ float4 vsmem[];
  const int lane = threadIdx.x & 31, h = lane & 1, f = lane >> 1;
  float* smem = reinterpret_cast<float*>(vsmem) + (threadIdx.x >> 5) * stage_words(false, TANG);
  VertexRun r;
  if (!r.init(n, k, run, smem)) return;
  r.stage_geometry(smem, idx, w, dw, k, lane, TANG);
  cp_wait();
  // the lane's outputs: even lanes enc's feature f and tenc's first tangent, odd lanes the
  // other two tangents (64 bytes a quantity), advanced a sample at a time
  const long long tk = (long long)k * VF, s0t = (r.s0 * 3 * k + r.l) * VF + f;
  float* oa = h ? tenc + s0t : enc + (r.s0 * k + r.l) * VF + f;
  float* ob = tenc + s0t + (1 + h) * tk;
  const long long da = h ? 3 * tk : tk, db = 3 * tk;
  VertexCorners c;
  for (int i = 0; i < r.cnt; ++i, oa += da, ob += db) {
    const unsigned moved = c.peek(r, i, lane);
    if (moved) c.fetch(r, table, moved, lane);
    const float4 wq = reinterpret_cast<const float4*>(r.w + i * 8)[h];
    // the lane's 4 parities, then its pair lane's other 4
    float acc = dot4(c.T, wq);
    acc += __shfl_xor_sync(FULL, acc, 1);
    if (!TANG) {
      if (!h) *oa = acc;
      continue;
    }
    float ta[3];
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      ta[t] = dot4(c.T, reinterpret_cast<const float4*>(r.dw + (t * VRUN + i) * 8)[h]);
      ta[t] += __shfl_xor_sync(FULL, ta[t], 1);
    }
    *oa = h ? ta[0] : acc;
    *ob = h ? ta[2] : ta[1];
  }
}

// One butterfly step over the 16 lanes of a half (lane bit m): of 2C values the lane keeps
// C, the half its bit selects, each summed with the partner lane's.
template <int C>
__device__ __forceinline__ void half_step(float* a, int lane, int m) {
  const bool up = lane & m;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const float send = up ? a[i] : a[i + C];
    const float keep = up ? a[i + C] : a[i];
    a[i] = keep + __shfl_xor_sync(FULL, send, m);
  }
}

// Sum NV values over the 16 lanes of one half (lanes of equal lane & 1, one feature each):
// with NV = 16 the lane keeps the sum of value (lane >> 1); with NV = 4 the sum of value
// (lane >> 3) & 3, in all 4 lanes of equal lane >> 3 and lane & 1.
template <int NV>
__device__ __forceinline__ float half_sum(float (&a)[NV], int lane) {
  if (NV == 16) {
    half_step<8>(a, lane, 16);
    half_step<4>(a, lane, 8);
    half_step<2>(a, lane, 4);
    half_step<1>(a, lane, 2);
    return a[0];
  }
  half_step<2>(a, lane, 16);
  half_step<1>(a, lane, 8);
  float v = a[0];
  v += __shfl_xor_sync(FULL, v, 4);
  v += __shfl_xor_sync(FULL, v, 2);
  return v;
}

template <bool TANG>
__global__ void __launch_bounds__(VBLOCK)
slot_vertex_bwd_kernel(const float* __restrict__ table, const long long* __restrict__ idx,
                       const float* __restrict__ w, const float* __restrict__ dw,
                       const float* __restrict__ genc, const float* __restrict__ gtenc, int n,
                       int k, int run, float* __restrict__ d_table, float* __restrict__ d_w,
                       float* __restrict__ d_dw) {
  extern __shared__ float4 vsmem[];
  constexpr int NQ = TANG ? 4 : 1;  // the cotangent's quantities: enc (and 3 tangents)
  const int lane = threadIdx.x & 31, h = lane & 1, f = lane >> 1;
  float* smem = reinterpret_cast<float*>(vsmem) + (threadIdx.x >> 5) * stage_words(true, TANG);
  VertexRun r;
  if (!r.init(n, k, run, smem)) return;
  // the run's cotangents first: [NQ][VRUN][16] after the geometry's words
  float* cot = smem + stage_words(false, TANG);
  const long long sl0 = r.s0 * k + r.l, tk = (long long)k * VF;
  stage(cot, genc + sl0 * VF, tk, r.cnt, VF, lane);
  if (TANG) {
#pragma unroll
    for (int t = 0; t < 3; ++t)
      stage(cot + (1 + t) * VRUN * VF, gtenc + (r.s0 * 3 * k + r.l) * VF + t * tk, 3 * tk,
            r.cnt, VF, lane);
  }
  cp_wait();
  // a run whose cotangents are all zero (a level the coarse-to-fine mask cuts) reads no
  // row and no geometry and adds nothing: its d_w and d_dw are zero, a sample a lane
  bool nz = false;
  for (int c = lane; c < NQ * VRUN * VF / 4; c += 32) {
    const float4 v = reinterpret_cast<const float4*>(cot)[c];
    const int i = (c % (VRUN * VF / 4)) / (VF / 4);
    nz |= i < r.cnt && (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f);
  }
  if (!__any_sync(FULL, nz)) {
    if (lane < r.cnt) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      const long long s = r.s0 + lane;
      float4* o = reinterpret_cast<float4*>(d_w + (s * k + r.l) * 8);
      o[0] = z;
      o[1] = z;
      if (TANG) {
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          o = reinterpret_cast<float4*>(d_dw + ((s * 3 + t) * k + r.l) * 8);
          o[0] = z;
          o[1] = z;
        }
      }
    }
    return;
  }
  r.stage_geometry(smem, idx, w, dw, k, lane, TANG);
  cp_wait();
  // where the lane stores its d_w (or d_dw) sum of a sample: value lane >> 1 with tangents
  // (quantity lane >> 3: d_w, then d_dw's 3 tangents; parity 4h + (lane >> 1 & 3)), value
  // lane >> 3 & 3 of d_w without, one lane of the 4 that hold it; advanced a sample at a time
  const int qn = TANG ? lane >> 3 : 0, par = 4 * h + (TANG ? (lane >> 1) & 3 : lane >> 3);
  const bool writer = TANG || (lane & 6) == 0;
  float* o = qn == 0 ? d_w + (r.s0 * k + r.l) * 8 + par
                     : d_dw + ((r.s0 * 3 + qn - 1) * k + r.l) * 8 + par;
  const long long dout = (qn == 0 ? 8LL : 24LL) * k;
  VertexCorners cn;
  float pend[4] = {0.f, 0.f, 0.f, 0.f};  // table cotangents not yet added, per slot 4h + q
  int kq[4];                             // the rows of the lane's slots 4h + q
  for (int i = 0; i < r.cnt; ++i, o += dout) {
    float c[NQ];
    bool live = false;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      c[q] = cot[(q * VRUN + i) * VF + f];
      live |= c[q] != 0.f;
    }
    // a sample whose cotangents are all zero reads no row and adds nothing
    float v = 0.f;
    if (__any_sync(FULL, live)) {
      const unsigned moved = cn.peek(r, i, lane);
      if (moved) {
        // a moved slot's sum goes to its old row; a slot that kept its row sums on
#pragma unroll
        for (int q = 0; q < 4; ++q) kq[q] = cn.slot_row(4 * h + q);
        flush_rows(d_table, kq, moved, lane, pend);
        cn.fetch(r, table, moved, lane);
      }
      const float4 wq = reinterpret_cast<const float4*>(r.w + i * 8)[h];
      float4 dq[3];
      if (TANG) {
#pragma unroll
        for (int t = 0; t < 3; ++t)
          dq[t] = reinterpret_cast<const float4*>(r.dw + (t * VRUN + i) * 8)[h];
      }
      float a[4 * NQ];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float u = c[0] * comp(wq, q);
        a[q] = cn.T[q] * c[0];
        if (TANG) {
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            u = __fmaf_rn(c[1 + t], comp(dq[t], q), u);
            a[4 * (1 + t) + q] = cn.T[q] * c[1 + t];
          }
        }
        pend[q] = (moved >> (4 * h + q) & 1) ? u : pend[q] + u;
      }
      v = half_sum<4 * NQ>(a, lane);
    }
    if (writer) *o = v;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) kq[q] = cn.slot_row(4 * h + q);
  flush_rows(d_table, kq, 0xffu, lane, pend);
}

// K6's backward grid: a block per (128 / 2F groups of `seg` samples, level).
template <int F>
unsigned cell_grid(int n, int k, int seg) {
  const long long per = (long long)(CBLOCK / (2 * F)) * seg;
  return (unsigned)((n + per - 1) / per * k);
}

template <int F>
int fwd_f(const float* table, const long long* idx, const float* w, const float* dw, int n, int k,
          bool bf, float* enc, float* tenc, cudaStream_t stream) {
  const unsigned grid = (unsigned)(((long long)n * k + FBLOCK - 1) / FBLOCK);
  if (dw)
    slot_lookup_fwd_kernel<F, true><<<grid, FBLOCK, 0, stream>>>(table, idx, w, dw, n, k, bf, enc,
                                                                  tenc);
  else
    slot_lookup_fwd_kernel<F, false><<<grid, FBLOCK, 0, stream>>>(table, idx, w, dw, n, k, bf, enc,
                                                                   tenc);
  return (int)cudaGetLastError();
}

template <int F>
int bwd_f(const float* table, const long long* idx, const float* w, const float* dw,
          const float* genc, const float* gtenc, int n, int k, bool bf, float* d_table,
          float* d_w, float* d_dw, cudaStream_t stream) {
  const int seg = group_run(n, k, 2 * F);
  const unsigned grid = cell_grid<F>(n, k, seg);
  if (dw)
    slot_lookup_bwd_kernel<F, true><<<grid, CBLOCK, 0, stream>>>(
        table, idx, w, dw, genc, gtenc, n, k, seg, bf, d_table, d_w, d_dw);
  else
    slot_lookup_bwd_kernel<F, false><<<grid, CBLOCK, 0, stream>>>(
        table, idx, w, dw, genc, gtenc, n, k, seg, bf, d_table, d_w, d_dw);
  return (int)cudaGetLastError();
}

bool bad_args(int n, int k, int feats) {
  return n < 1 || k < 1 || (feats != 2 && feats != 4 && feats != 8 && feats != 16);
}

// K6v's run length: VRUN consecutive samples a warp, fewer where the call has too few
// (sample, level)s to give every SM 64 warps.
int vertex_run(int n, int k) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 132;
  }
  const long long per = (long long)n * k / (64LL * sms);
  return (int)(per < 4 ? 4 : per > VRUN ? VRUN : per);
}

// A block a level of 4 runs.
unsigned vertex_grid(int n, int k, int run) {
  const long long runs = ((long long)n + run - 1) / run, per = VBLOCK / 32;
  return (unsigned)((runs + per - 1) / per * k);
}

// Dynamic shared memory of a K6v block, and the kernel allowed to take it (past 48 KB).
template <typename K>
size_t vertex_smem(K kernel, bool bwd, bool tang) {
  static bool allowed[2][2] = {};
  const size_t bytes = (size_t)stage_words(bwd, tang) * 4 * (VBLOCK / 32);
  if (!allowed[bwd][tang]) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    allowed[bwd][tang] = true;
  }
  return bytes;
}

}  // namespace

// enc [n, k*feats] (and tenc [n, 3*k*feats] when dw is not null) from the f32 table
// [rows, 128], idx [n, k] int64 absolute entry indices, w [n, k*8] and dw [n, 3*k*8]; table,
// w and dw 16-byte aligned.
extern "C" int mms_slot_lookup_fwd(const void* table, const void* idx, const void* w,
                                   const void* dw, int n, int k, int feats, int bf16_table,
                                   void* enc, void* tenc, void* stream) {
  if (bad_args(n, k, feats) || (dw != nullptr) != (tenc != nullptr)) return -1;
  for (const void* p : {table, w, dw}) if (!aligned16(p)) return -1;
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
// null, d_dw [n, 3*k*8] from the cotangents genc [n, k*feats] (and gtenc [n, 3*k*feats]);
// every pointer but idx 16-byte aligned.
extern "C" int mms_slot_lookup_bwd(const void* table, const void* idx, const void* w,
                                   const void* dw, const void* genc, const void* gtenc, int n,
                                   int k, int feats, int bf16_table, void* d_table, void* d_w,
                                   void* d_dw, void* stream) {
  if (bad_args(n, k, feats) || (dw != nullptr) != (gtenc != nullptr) ||
      (dw != nullptr) != (d_dw != nullptr))
    return -1;
  for (const void* p : {table, w, dw, genc, gtenc, (const void*)d_table, (const void*)d_w,
                        (const void*)d_dw})
    if (!aligned16(p)) return -1;
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
// p), w [n, k*8] and dw [n, 3*k*8]; every pointer 16-byte aligned.
extern "C" int mms_slot_vertex_fwd(const void* table, const void* idx, const void* w,
                                   const void* dw, int n, int k, void* enc, void* tenc,
                                   void* stream) {
  if (n < 1 || k < 1 || (dw != nullptr) != (tenc != nullptr)) return -1;
  for (const void* p : {table, idx, w, dw, (const void*)enc, (const void*)tenc})
    if (!aligned16(p)) return -1;
  const auto* t = (const float*)table;
  const auto* ix = (const long long*)idx;
  const auto s = (cudaStream_t)stream;
  const int run = vertex_run(n, k);
  const unsigned grid = vertex_grid(n, k, run);
  if (dw)
    slot_vertex_fwd_kernel<true>
        <<<grid, VBLOCK, vertex_smem(slot_vertex_fwd_kernel<true>, false, true), s>>>(
            t, ix, (const float*)w, (const float*)dw, n, k, run, (float*)enc, (float*)tenc);
  else
    slot_vertex_fwd_kernel<false>
        <<<grid, VBLOCK, vertex_smem(slot_vertex_fwd_kernel<false>, false, false), s>>>(
            t, ix, (const float*)w, nullptr, n, k, run, (float*)enc, nullptr);
  return (int)cudaGetLastError();
}

// Vertex layout (K6v): d_table [rows, 128] (zeroed by the caller, accumulated), d_w [n, k*8]
// and, when dw is not null, d_dw [n, 3*k*8] from genc [n, k*16] (and gtenc [n, 3*k*16]);
// every pointer 16-byte aligned.
extern "C" int mms_slot_vertex_bwd(const void* table, const void* idx, const void* w,
                                   const void* dw, const void* genc, const void* gtenc, int n,
                                   int k, void* d_table, void* d_w, void* d_dw, void* stream) {
  if (n < 1 || k < 1 || (dw != nullptr) != (gtenc != nullptr) ||
      (dw != nullptr) != (d_dw != nullptr))
    return -1;
  for (const void* p : {table, idx, w, dw, genc, gtenc, (const void*)d_table, (const void*)d_w,
                        (const void*)d_dw})
    if (!aligned16(p)) return -1;
  const auto* t = (const float*)table;
  const auto* ix = (const long long*)idx;
  const auto s = (cudaStream_t)stream;
  const int run = vertex_run(n, k);
  const unsigned grid = vertex_grid(n, k, run);
  if (dw)
    slot_vertex_bwd_kernel<true>
        <<<grid, VBLOCK, vertex_smem(slot_vertex_bwd_kernel<true>, true, true), s>>>(
            t, ix, (const float*)w, (const float*)dw, (const float*)genc, (const float*)gtenc, n,
            k, run, (float*)d_table, (float*)d_w, (float*)d_dw);
  else
    slot_vertex_bwd_kernel<false>
        <<<grid, VBLOCK, vertex_smem(slot_vertex_bwd_kernel<false>, true, false), s>>>(
            t, ix, (const float*)w, nullptr, (const float*)genc, nullptr, n, k, run,
            (float*)d_table, (float*)d_w, nullptr);
  return (int)cudaGetLastError();
}
