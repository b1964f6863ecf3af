// The Hopper (sm_90a) building blocks that every chain kernel shares: K1
// (fused_chain.cu), K2's forward (slot_value.cu), the adjoint forwards of K3,
// K4 and K5 (adj_fwd.cuh), the tangent forwards of K1t and K4j
// (tangent_fwd.cu), and the backward passes of K2 and K3 (slot_chain_bwd.cu),
// K4 and K5 (sdf_chain.cu) and K1t and K4j (fused_mlp.cu): the layout of a
// chain (Geom), weight-image pieces, the ring of weight stages that a
// producer warpgroup feeds with bulk copies, the wgmma product of a 64-row
// tile (mma_piece), the activation images (of shared memory, or of device
// memory past a hidden width of 512) and their stores to the stacks
// (Stacker), and the launch plan of a persistent kernel of consumer
// warpgroups and one producer warpgroup.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"

// a named namespace: the C entry points take its structs, so their symbols
// must have external linkage
namespace k1 {

using bf16 = __nv_bfloat16;
using namespace hop;

constexpr int MAXL = 32;            // layers (build.py MAX_LAYERS)
constexpr int MAXPIECES = 32;       // pieces of one product's output width
constexpr int MAXWG = 2;            // consumer warpgroups per CTA
constexpr int NTHREADS = (MAXWG + 1) * 128;  // consumer warpgroups and the producer warpgroup
// registers of a consumer and of the producer warpgroup (setmaxnreg): a
// consumer holds up to 128 accumulators
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
constexpr int SUM_BAR = 15;         // named barrier of all consumer threads
constexpr size_t MAX_SMEM = 232448;  // per block
constexpr int ERR_SMEM = -2;
constexpr float SKIP_SCALE = 0.70710678118654752f;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SOFTPLUS_QUAD = 2 };

// Layout of one chain (fused_mlp.py chain_layout builds it): widths padded to 64 for
// the activation images (H, P0 = ceil64(d_in)) and to 16 for the outputs;
// element offsets of each layer in the packed buffers, the gradients and the
// stacks (columns of the stacks per tile).
struct Geom {
  long long fw_off[MAXL + 1];  // forward images (bf16 elements), [L] = total
  long long bw_off[MAXL + 1];  // backward images of layer l, [MAXL] = total
  long long gw_off[MAXL];      // gW_l [din_true, dout_true] f32
  int din_pad[MAXL];           // P0, H + P0 (skip) or H
  int din_true[MAXL];          // d_in, H + d_in (skip) or H
  int dout_pad[MAXL];          // H, or rup16(d_out) for the last layer
  int dout_true[MAXL];
  int b_off[MAXL];             // padded f32 biases
  int gb_off[MAXL];            // gb_l [dout_true] f32
  int hs_w[MAXL + 1];          // hin stack columns before layer l (per row tile)
  int gs_w[MAXL + 1];          // gz stack columns before layer l (per row tile)
  int sm[MAXL];                // stack tiles of layer l per row tile (1; 2 where an
                               // adjoint backward stacks a second product under the first)
  int L, H, P0, d_in, d_out, skip_mask, act;
  float quad_a;
};

struct PackArgs {
  const float* w[MAXL];
  const float* b[MAXL];
  long long ws0[MAXL];  // element strides of w[l] along its rows (inputs) and columns
  long long ws1[MAXL];
};

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

__device__ __forceinline__ float rbf(float x) { return __bfloat162float(__float2bfloat16(x)); }
__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // .x = a (low half)
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&u);
  return make_float2(__low2float(v), __high2float(v));
}

__host__ __device__ __forceinline__ int ceil64(int w) { return (w + 63) & ~63; }

// Output pieces of a width (a multiple of 16): 256-column pieces, then the
// binary decomposition of the rest (128, 64, 32, 16).
__host__ __device__ __forceinline__ int n_pieces(int w) {
  const int r = (w & 255) >> 4;
  return (w >> 8) + (r & 1) + ((r >> 1) & 1) + ((r >> 2) & 1) + ((r >> 3) & 1);
}

__host__ __device__ __forceinline__ void piece(int w, int i, int& off, int& np) {
  const int full = w >> 8;
  np = 0;
  if (i < full) {
    off = i << 8;
    np = 256;
    return;
  }
  off = full << 8;
  i -= full;
  const int r = (w & 255) >> 4;
  for (int b = 3; b >= 0; --b) {
    if ((r >> b) & 1) {
      if (i == 0) {
        np = 16 << b;
        return;
      }
      off += 16 << b;
      --i;
    }
  }
}

// Pieces of the backward product of layer l (gh over the layer's input
// columns): the x0 part first at a skip layer (pieces of P0 at column H), then
// the h part (the pieces of H: one, or 256 and H - 256 columns); layer 0:
// pieces of P0.
__host__ __device__ __forceinline__ int bwd_n_pieces(const Geom& G, int l) {
  if (l == 0) return n_pieces(G.P0);
  return ((G.skip_mask >> l) & 1) ? n_pieces(G.P0) + n_pieces(G.H) : n_pieces(G.H);
}

// x0part: the piece lies in the layer's x0 columns (gx or gx0)
__host__ __device__ __forceinline__ void bwd_piece(const Geom& G, int l, int i, int& off, int& np,
                                                   bool& x0part) {
  const bool skip = (G.skip_mask >> l) & 1;
  if (l == 0 || (skip && i < n_pieces(G.P0))) {
    piece(G.P0, i, off, np);
    if (l > 0) off += G.H;
    x0part = true;
    return;
  }
  piece(G.H, skip ? i - n_pieces(G.P0) : i, off, np);
  x0part = false;
}

__host__ __device__ __forceinline__ int gcols(const Geom& G, int l) {
  return ceil64(G.dout_pad[l]);
}

// bf16(W_{L-1}[i, c]) out of the last layer's backward images
__device__ __forceinline__ float last_column(const Geom& G, const bf16* wbw, int i, int c) {
  const int l = G.L - 1, depth = gcols(G, l);
  long long base = G.bw_off[l];
  for (int p = 0; p < bwd_n_pieces(G, l); ++p) {
    int off, np;
    bool x0part;
    bwd_piece(G, l, p, off, np, x0part);
    if (i >= off && i < off + np)
      return bf(wbw[base + (long long)(c >> 6) * np * 64 + img(i - off, c & 63)]);
    base += (long long)np * depth;
  }
  return 0.f;
}

// The activation images of a tile: [h (H) | x0 (P0)] where a skip layer reads
// x0 again; else x0 in the first columns, which layer 0's output overwrites.
__host__ __device__ __forceinline__ int x0_col(const Geom& G) { return G.skip_mask ? G.H : 0; }
__host__ __device__ __forceinline__ int act_cols(const Geom& G) {
  return G.skip_mask ? G.H + G.P0 : (G.H > G.P0 ? G.H : G.P0);
}

// shared-memory element (bf16) of activation column c, row r
__device__ __forceinline__ int act_el(int c, int r) { return (c >> 6) * 4096 + img(r, c & 63); }

// Width classes of the kernels that run hidden layers, a template argument WC
// of each, so that a narrower chain compiles to its own code and keeps its
// registers (the piece loop's live values cost spills at 168 registers):
//   WC_NARROW (H <= 256): one output piece per hidden layer, written in place;
//   WC_WIDE (H 384, 512): two pieces, 256 and H - 256 columns. The product's
//     output replaces the columns its input occupies, which the second
//     piece's product still reads, so the first piece's epilogue writes 256
//     side columns after the activation images instead (the last side_cols
//     columns of the buffer), and side_back copies them to columns [0, 256)
//     once the last product retired. The last piece writes in place;
//   WC_DEV (H > 512, a multiple of 128): ceil(H / 256) pieces, all but the last
//     to (pieces - 1) x 256 side columns, as WC_WIDE. A 64-row tile's
//     activation images no longer fit in shared memory beside the ring (at H =
//     1024 the images alone take 128 KB and their side columns 96 KB more), so
//     they live in a per-(CTA, warpgroup) slab of device memory in the same
//     swizzled image layout, written and read through generic pointers as the
//     shared images are; a product stages its A images one 64-column chunk at
//     a time into two 8 KB shared buffers of its warpgroup by bulk copies
//     (AStage), which one thread issues a chunk ahead, and a stack store
//     becomes a copy loop of the warpgroup (Stacker).
constexpr int WC_NARROW = 0, WC_WIDE = 1, WC_DEV = 2;

__host__ __device__ __forceinline__ int width_class(const Geom& G) {
  return G.H <= 256 ? WC_NARROW : G.H <= 512 ? WC_WIDE : WC_DEV;
}

__host__ __device__ __forceinline__ int side_cols(const Geom& G) {
  return G.H > 256 ? (n_pieces(G.H) - 1) * 256 : 0;
}

// pieces of a hidden-width product
template <int WC>
__host__ __device__ __forceinline__ int hidden_pieces(int H) {
  return WC == WC_NARROW ? 1 : WC == WC_WIDE ? 2 : (H + 255) >> 8;
}

// piece p (off, np) of a hidden-width product
template <int WC>
__device__ __forceinline__ void hidden_piece(int H, int p, int& off, int& np) {
  off = WC ? p << 8 : 0;
  np = WC ? min(256, H - off) : H;
}

// where a hidden-width piece at column off writes: the side images, unless it
// is the last (p + 1 == npc) of its product's pieces; sidec side columns
template <int WC>
__device__ __forceinline__ bf16* piece_dst(bf16* act, int act_bytes, int sidec, int p, int npc,
                                           int off) {
  if (WC == WC_NARROW) return act;
  const int base = p + 1 < npc ? act_bytes / 128 - sidec : 0;
  return act + ((base + off) >> 6) * 4096;
}

// after the last hidden-width piece: the sidec side columns to columns [0, sidec)
template <int WC>
__device__ __forceinline__ void side_back(bf16* act, int act_bytes, int sidec, int wg) {
  if (WC == WC_NARROW) return;
  wg_sync(1 + wg);
  const uint4* s = reinterpret_cast<const uint4*>(act + (act_bytes / 128 - sidec) / 64 * 4096);
  uint4* d = reinterpret_cast<uint4*>(act);
  for (int i = threadIdx.x & 127; i < sidec * 64 * 2 / 16; i += 128) d[i] = s[i];
}

// generic-proxy writes of the activation images made visible to the async
// proxy (wgmma's reads of shared memory; WC_DEV: the bulk copies that stage a
// chunk of the device-memory images)
template <int WC>
__device__ __forceinline__ void fence_act() {
  if (WC == WC_DEV)
    asm volatile("fence.proxy.async;\n" ::: "memory");
  else
    fence_async_smem();
}

// shared memory of a consumer warpgroup: its activation images, or (WC_DEV)
// its two A staging buffers
constexpr int ASTAGE_BYTES = 2 * 8192;
template <int WC>
__host__ __device__ __forceinline__ int wg_smem(int act_bytes) {
  return WC == WC_DEV ? ASTAGE_BYTES : act_bytes;
}

// WC_DEV: a warpgroup's two A staging buffers and their barriers; chunk i of
// the warpgroup's sequence goes to buffer i % 2 and completes phase (i / 2) % 2
// of its barrier
struct AStage {
  uint8_t* buf;
  uint64_t* bar;
  uint32_t issued = 0, used = 0;
  __device__ __forceinline__ void issue(const bf16* src) {
    if ((threadIdx.x & 127) == 0) {
      mbar_expect_tx(&bar[issued & 1], 8192);
      bulk_g2s(buf + (issued & 1) * 8192, src, 8192, &bar[issued & 1]);
    }
    ++issued;
  }
  __device__ __forceinline__ const uint8_t* wait() {
    mbar_wait(&bar[used & 1], (used >> 1) & 1);
    return buf + (used++ & 1) * 8192;
  }
};

// the activation images of consumer warpgroup wg: in shared memory, or (WC_DEV)
// its slab of device memory, slot = CTA * nwg + wg
template <int WC>
__device__ __forceinline__ bf16* act_images(uint8_t* smem, int wg, int act_bytes, bf16* dev_act,
                                            int slot) {
  if (WC == WC_DEV) return dev_act + (size_t)slot * (act_bytes / 2);
  return reinterpret_cast<bf16*>(smem + wg * act_bytes);
}

// WC_DEV's staging buffers and barriers of warpgroup wg: the buffers in place of
// the shared activation images, the barriers after the ring's (initialised by
// init_astage)
__device__ __forceinline__ AStage astage_of(uint8_t* smem, int wg, uint64_t* bars, int stages) {
  return AStage{smem + wg * ASTAGE_BYTES, bars + 2 * stages + 2 * wg};
}

__device__ __forceinline__ void init_astage(uint64_t* bars, int stages) {
  for (int i = 0; i < 2 * MAXWG; ++i) mbar_init(&bars[2 * stages + i], 1);
}

template <class F>
__device__ __forceinline__ void with_n(int np, F&& f) {
  switch (np) {
    case 16: f(std::integral_constant<int, 16>()); break;
    case 32: f(std::integral_constant<int, 32>()); break;
    case 64: f(std::integral_constant<int, 64>()); break;
    case 128: f(std::integral_constant<int, 128>()); break;
    case 256: f(std::integral_constant<int, 256>()); break;
    default: break;
  }
}

// f(WC) with G's width class as an integral_constant
template <class F>
__host__ __forceinline__ auto with_wc(const Geom& G, F&& f) {
  switch (width_class(G)) {
    case WC_NARROW: return f(std::integral_constant<int, WC_NARROW>());
    case WC_WIDE: return f(std::integral_constant<int, WC_WIDE>());
    default: return f(std::integral_constant<int, WC_DEV>());
  }
}

// with_n for a backward pass's pieces: H and the pieces of P0, multiples of 64
template <class F>
__device__ __forceinline__ void with_n64(int np, F&& f) {
  switch (np) {
    case 64: f(std::integral_constant<int, 64>()); break;
    case 128: f(std::integral_constant<int, 128>()); break;
    case 256: f(std::integral_constant<int, 256>()); break;
    default: break;
  }
}

// v[d] += x for a d in 0..2 known only at run time, v staying in registers
__device__ __forceinline__ void add3(float (&v)[3], int d, float x) {
  v[0] += d == 0 ? x : 0.f;
  v[1] += d == 1 ? x : 0.f;
  v[2] += d == 2 ? x : 0.f;
}

// The ring of weight (or stack) stages: full[s] completes when stage s's bulk
// copies landed, empty[s] when every consumer warpgroup is done with it.
struct Ring {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int sb;      // bytes per stage
  int stages;
  int stage = 0;
  int phase = 0;
  __device__ __forceinline__ uint8_t* buf() const { return base + stage * sb; }
  __device__ __forceinline__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  // producer: wait for the stage to be free and arm it for `bytes`
  __device__ __forceinline__ void acquire(uint32_t bytes) {
    mbar_wait(&empty[stage], phase ^ 1);
    mbar_expect_tx(&full[stage], bytes);
  }
  // consumer warpgroup `wg`: after its reads of the stage retired
  __device__ __forceinline__ void release(int wg) {
    wg_sync(1 + wg);
    if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[stage]);
    advance();
  }
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

__device__ __forceinline__ int acc_col() { return (threadIdx.x & 3) << 1; }

// acc[64, N] = bias + A[64, 64 kcs] B: A the kcs images from `a` in shared
// memory (or, with `as`, in device memory, staged chunk by chunk), B the next
// kcs ring stages; bias (f32, from column 0 of the piece) or zeros, on the
// thread's rows whose bit (row r0: 1, r0 + 8: 2) is set in bias_rows. The bias
// seeds the accumulators, so its loads are in flight while the first stage
// lands. Releases each stage once its wgmmas retired (the release's
// warpgroup barrier also frees the staging buffer for the chunk after next).
template <int N>
__device__ __forceinline__ void mma_piece(float (&acc)[N / 2], const bf16* a, int kcs, Ring& R,
                                          int wg, const float* bias, int bias_rows = 3,
                                          AStage* as = nullptr) {
  const int cq = acc_col();
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 b =
        bias ? *reinterpret_cast<const float2*>(bias + 8 * j + cq) : make_float2(0.f, 0.f);
    acc[4 * j] = bias_rows & 1 ? b.x : 0.f;
    acc[4 * j + 1] = bias_rows & 1 ? b.y : 0.f;
    acc[4 * j + 2] = bias_rows & 2 ? b.x : 0.f;
    acc[4 * j + 3] = bias_rows & 2 ? b.y : 0.f;
  }
  if (as) as->issue(a);
  for (int kc = 0; kc < kcs; ++kc) {
    const bf16* ak = a + kc * 4096;
    if (as) {
      if (kc + 1 < kcs) as->issue(a + (kc + 1) * 4096);
      ak = reinterpret_cast<const bf16*>(as->wait());
    }
    mbar_wait(&R.full[R.stage], R.phase);
    const uint8_t* bk = R.buf();
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Wgmma<N>::run(acc, desc_sw128(ak + j * 16), desc_sw128(bk + j * 32), 1);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
    R.release(wg);
  }
}

// The accumulator element of thread t: rows acc_row(t) (+ 8), columns 8 j + 2 (t % 4) (+ 1)
__device__ __forceinline__ int acc_row() {
  const int t = threadIdx.x & 127;
  return ((t >> 5) << 4) + ((t & 31) >> 2);
}
// Rows [row0, row0 + 64) of a row-major [n, d] matrix of T (f32 or bf16, base
// 16-byte aligned) rounded to bf16 into activation columns [c0, c0 + width),
// zero past d and past n. The tile's rows are one contiguous run of memory,
// read as 16-byte vectors, eight per thread in flight at a time (the loads'
// latency, not their bytes, would bound a load-then-store loop).
template <class T>
__device__ __forceinline__ void load_rows_t(bf16* act, int c0, int width, const T* src, int d,
                                            long long row0, int n) {
  constexpr int PER = 16 / sizeof(T), B = 8;
  const int t = threadIdx.x & 127;
  const int rows = (int)min(64LL, max(0LL, (long long)n - row0));
  for (int i = t; i < 64 * (width - d); i += 128) {  // columns [d, width) of every row
    const int r = i / (width - d), c = d + i % (width - d);
    act[act_el(c0 + c, r)] = __float2bfloat16(0.f);
  }
  for (int i = t; i < (64 - rows) * d; i += 128)  // the rows past n
    act[act_el(c0 + i % d, rows + i / d)] = __float2bfloat16(0.f);
  const T* base = src + row0 * d;
  const int total = rows * d, nvec = total / PER;
  const uint4* vs = reinterpret_cast<const uint4*>(base);
  for (int v0 = t; v0 < nvec; v0 += 128 * B) {
    uint4 buf[B];
#pragma unroll
    for (int b = 0; b < B; ++b)
      if (v0 + 128 * b < nvec) buf[b] = vs[v0 + 128 * b];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int v = v0 + 128 * b;
      if (v >= nvec) break;
      const int e = v * PER;
      int r = e / d, c = e - r * d;
      const T* vals = reinterpret_cast<const T*>(&buf[b]);
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        act[act_el(c0 + c, r)] = __float2bfloat16((float)vals[k]);
        if (++c == d) {
          c = 0;
          ++r;
        }
      }
    }
  }
  for (int e = nvec * PER + t; e < total; e += 128)  // the last partial vector
    act[act_el(c0 + e % d, e / d)] = __float2bfloat16((float)base[e]);
}

__device__ __forceinline__ void load_rows(bf16* act, int c0, int width, const void* src,
                                          int is_bf16, int d, long long row0, int n) {
  if (is_bf16)
    load_rows_t(act, c0, width, static_cast<const bf16*>(src), d, row0, n);
  else
    load_rows_t(act, c0, width, static_cast<const float*>(src), d, row0, n);
}

// x0 -> bf16(x0 / sqrt 2) in place over activation columns [c0, c0 + width)
__device__ __forceinline__ void scale_region(bf16* act, int c0, int width) {
  uint32_t* p = reinterpret_cast<uint32_t*>(act + (c0 >> 6) * 4096);
  const int words = width * 32;  // 64 rows x width bf16 / 2
  for (int i = threadIdx.x & 127; i < words; i += 128) {
    const float2 v = unpack2(p[i]);
    p[i] = pack2(v.x * SKIP_SCALE, v.y * SKIP_SCALE);
  }
}

// A hidden layer's output from its accumulators z into the activation
// images: bf16(act(z)), or (FROM_BF16_Z) bf16(act(bf16(z))), the stack's
// value; times 1/sqrt(2), rounded, before a skip layer. zl (if given)
// receives bf16(z), thread by thread in accumulator order.
template <int N, bool FROM_BF16_Z>
__device__ __forceinline__ void write_hidden(const float (&acc)[N / 2], bf16* act, bool scale,
                                             int act_kind, float qa, uint32_t* zl) {
  const int t = threadIdx.x & 127, r0 = acc_row(), cq = acc_col();
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float z0 = acc[4 * j + 2 * e], z1 = acc[4 * j + 2 * e + 1];
      const uint32_t zb = pack2(z0, z1);
      if (zl) zl[(2 * j + e) * 128 + t] = zb;
      if (FROM_BF16_Z) {
        const float2 zr = unpack2(zb);
        z0 = zr.x;
        z1 = zr.y;
      }
      uint32_t h = pack2(act_f(act_kind, z0, qa), act_f(act_kind, z1, qa));
      if (scale) {
        const float2 v = unpack2(h);
        h = pack2(v.x * SKIP_SCALE, v.y * SKIP_SCALE);
      }
      *reinterpret_cast<uint32_t*>(act + act_el(8 * j + cq, r0 + 8 * e)) = h;
    }
  }
}

// The stacks are the activation images themselves: thread 0 of the warpgroup
// copies a region of them to device memory with one bulk store, and waits for
// the store to have read shared memory before the region is written again.
// WC_DEV: the images are in device memory, and the warpgroup copies them
// (every thread calls store and drain).
struct Stacker {
  bool on;           // the tile is a real one (a group's spare tile stores nothing)
  bool dev = false;  // WC_DEV
  __device__ __forceinline__ void store(bf16* dst, const bf16* src, int cols) const {
    if (!on) return;
    if (dev) {
      const uint4* s = reinterpret_cast<const uint4*>(src);
      uint4* d = reinterpret_cast<uint4*>(dst);
      for (int i = threadIdx.x & 127; i < cols * 8; i += 128) d[i] = s[i];
    } else if ((threadIdx.x & 127) == 0) {
      bulk_s2g(dst, src, (uint32_t)cols * 128);
    }
  }
  __device__ __forceinline__ void drain(int wg) const {
    if ((threadIdx.x & 127) == 0) bulk_wait_read();
    wg_sync(1 + wg);
  }
};

// bytes of the hin stacks and of the gz stacks of `tiles` row tiles, each
// 256-byte aligned; the gz stacks follow the hin stacks, the per-CTA slabs of
// a backward pass follow both
__host__ __device__ inline void stack_sizes(const Geom& G, int tiles, size_t* s) {
  s[0] = ((size_t)tiles * 64 * G.hs_w[G.L] * 2 + 255) & ~size_t(255);
  s[1] = ((size_t)tiles * 64 * G.gs_w[G.L] * 2 + 255) & ~size_t(255);
}

__host__ __device__ inline size_t align256(size_t b) { return (b + 255) & ~size_t(255); }

// ------------------------------------------------------------------- launch

// A backward pass's producer: the weight images of one tile group, in the order
// its consumers read them, one ring stage per image.
__device__ __forceinline__ void stream_images(Ring& R, const uint8_t* src, uint32_t bytes) {
  R.acquire(bytes);
  bulk_g2s(R.buf(), src, bytes, &R.full[R.stage]);
  R.advance();
}

// forward images of layers [0, nl): per layer, per output piece, per 64-deep k-chunk
__device__ __forceinline__ void stream_fwd(Ring& R, const Geom& G, const bf16* wfw, int nl) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(wfw);
  for (int l = 0; l < nl; ++l) {
    for (int p = 0; p < n_pieces(G.dout_pad[l]); ++p) {
      int off, np;
      piece(G.dout_pad[l], p, off, np);
      for (int kc = 0; kc < (G.din_pad[l] >> 6); ++kc, src += np * 128)
        stream_images(R, src, np * 128);
    }
  }
}

__device__ __forceinline__ void stream_hidden_fwd(Ring& R, const Geom& G, const bf16* wfw) {
  stream_fwd(R, G, wfw, G.L - 1);
}

// backward images of layers top .. 0
__device__ __forceinline__ void stream_bwd(Ring& R, const Geom& G, const bf16* wbw, int top) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(wbw + G.bw_off[top]);
  for (int l = top; l >= 0; --l) {
    const int kcs = gcols(G, l) >> 6;
    for (int p = 0; p < bwd_n_pieces(G, l); ++p) {
      int off, np;
      bool x0part;
      bwd_piece(G, l, p, off, np, x0part);
      for (int kc = 0; kc < kcs; ++kc, src += np * 128) stream_images(R, src, np * 128);
    }
  }
}

// The forward of a chain over n rows on one CTA of a persistent grid (K1's
// forward, and K2's with the slot grid in front): the producer warpgroup
// streams every layer's forward images, once per tile group, through the
// ring; each consumer warpgroup owns a 64-row tile, its activations in one
// buffer of 64-column images that each layer's epilogue overwrites from its
// accumulators (the first of two hidden-width pieces through the side images)
// once the layer's wgmmas retired; the bias seeds the accumulators.
//   front(act, c0, row0): the tile's chain input, bf16, into activation
//     columns [c0, c0 + P0), zero past the input's width and past n, by the
//     warpgroup's 128 threads (the caller fences and synchronises);
//   hidden(l, off, NC, acc, row0): a hidden layer's piece (NC its width as an
//     integral_constant) before its epilogue;
//   last(off, NC, acc, row0): a piece of the last layer.
// WC: the chain's width class (width_class); dev_act: WC_DEV's activation
// slabs, act_bytes per (CTA, warpgroup).
template <int WC, class Front, class Hidden, class Last>
__device__ __forceinline__ void chain_forward(uint8_t* smem, const Geom& G, int n,
                                              const bf16* __restrict__ wfw,
                                              const float* __restrict__ bpk, int nwg, int stages,
                                              int sb, int act_bytes, bf16* dev_act,
                                              const Front& front, const Hidden& hidden,
                                              const Last& last) {
  constexpr bool dev = WC == WC_DEV;
  uint8_t* ring = smem + nwg * wg_smem<WC>(act_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + stages * sb);
  Ring R{ring, bars, bars + stages, sb, stages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&R.full[s], 1);
      mbar_init(&R.empty[s], nwg);
    }
    if (dev) init_astage(bars, stages);
    fence_mbar_init();
  }
  __syncthreads();
  const int L = G.L, H = G.H, P0 = G.P0;
  const int x0c = x0_col(G), sidec = side_cols(G);
  const int tiles = (n + 63) / 64, groups = (tiles + nwg - 1) / nwg;
  const int warp = threadIdx.x >> 5;
  if (warp >= nwg * 4) {  // producer: the forward images, in order, once per tile group
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == nwg * 128)
      for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) stream_fwd(R, G, wfw, L);
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp >> 2;
  bf16* act = act_images<WC>(smem, wg, act_bytes, dev_act, blockIdx.x * nwg + wg);
  AStage as = astage_of(smem, wg, bars, stages);
  AStage* asp = dev ? &as : nullptr;
  {
    uint4* p = reinterpret_cast<uint4*>(act);
    for (int i = threadIdx.x & 127; i < act_bytes / 16; i += 128) p[i] = make_uint4(0, 0, 0, 0);
  }
  wg_sync(1 + wg);
  const int r0 = acc_row(), cq = acc_col();
  const int act_kind = G.act;
  const float qa = G.quad_a;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long row0 = (long long)(grp * nwg + wg) * 64;
    front(act, x0c, row0);
    fence_act<WC>();
    wg_sync(1 + wg);
    for (int l = 0; l < L; ++l) {
      const bf16* a = act + (l == 0 ? (x0c >> 6) * 4096 : 0);
      const int kcs = G.din_pad[l] >> 6, npc = n_pieces(G.dout_pad[l]);
      const bool is_last = l == L - 1;
      const bool next_skip = !is_last && ((G.skip_mask >> (l + 1)) & 1);
      const float* B = bpk + G.b_off[l];
      for (int p = 0; p < npc; ++p) {
        int off, np;
        piece(G.dout_pad[l], p, off, np);
        with_n(np, [&](auto NC) {
          constexpr int N = decltype(NC)::value;
          float acc[N / 2];
          mma_piece<N>(acc, a, kcs, R, wg, B + off, 3, asp);
          if (is_last) {
            last(off, NC, acc, row0);
            return;
          }
          hidden(l, off, NC, acc, row0);
          // h = bf16(act(z)) (times 1/sqrt 2, rounded, before a skip layer)
          bf16* dst = piece_dst<WC>(act, act_bytes, sidec, p, npc, off);
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            const int c = 8 * j + cq;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              uint32_t h = pack2(act_f(act_kind, acc[4 * j + 2 * e], qa),
                                 act_f(act_kind, acc[4 * j + 2 * e + 1], qa));
              if (next_skip) {
                const float2 v = unpack2(h);
                h = pack2(v.x * SKIP_SCALE, v.y * SKIP_SCALE);
              }
              *reinterpret_cast<uint32_t*>(dst + act_el(c, r0 + 8 * e)) = h;
            }
          }
        });
      }
      if (!is_last) side_back<WC>(act, act_bytes, sidec, wg);
      if (l == 0 && G.skip_mask) scale_region(act, H, P0);
      fence_act<WC>();
      wg_sync(1 + wg);
    }
  }
}

// f32 rows of a slab (adj or gx0) over the P0 columns, in the accumulator order of
// the pieces of P0: element i of the piece at column off is word (off / 2 + i) * 128 + t
template <int N>
__device__ __forceinline__ void slab_accumulate(float* slab, int off, const float (&acc)[N / 2],
                                                float scale, bool first) {
  float* g = slab + (off >> 1) * 128 + (threadIdx.x & 127);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float v = acc[i] * scale;
    g[i * 128] = first ? v : g[i * 128] + v;
  }
}


// a persistent launch: consumer warpgroups, ring stages and their bytes, the
// activation buffer's bytes, shared memory, threads and CTAs
struct Launch {
  int nwg, stages, sb, act_bytes, smem, threads, grid;
};

static int g_sms = 0;
static bool g_attr[16] = {};

static int sm_count() {
  if (!g_sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      g_sms = 0;
  }
  return g_sms > 0 ? g_sms : 1;
}

static cudaError_t allow_smem(int which, const void* kernel) {
  if (g_attr[which]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
  if (err == cudaSuccess) g_attr[which] = true;
  return err;
}

static int max_piece(int w) {
  int m = 0;
  for (int i = 0; i < n_pieces(w); ++i) {
    int off, np;
    piece(w, i, off, np);
    m = np > m ? np : m;
  }
  return m;
}

// Checks what the kernels take: 2..MAXL layers, H in {64, 128, 256, 384, 512}
// or (WC_DEV) a multiple of 128 over 512, at most MAXPIECES pieces per product.
static bool geom_ok(const Geom& G) {
  if (G.L < 2 || G.L > MAXL) return false;
  if (G.H != 64 && G.H != 128 && G.H != 256 && G.H != 384 && G.H != 512 &&
      (G.H < 512 || G.H % 128))
    return false;
  if (G.skip_mask & 1) return false;
  for (int l = 0; l < G.L; ++l)
    if (n_pieces(G.dout_pad[l]) > MAXPIECES || bwd_n_pieces(G, l) > MAXPIECES) return false;
  return true;
}

// What a launch plan serves: a forward (every layer's forward images), a
// backward pass (also the column sums of gb and the backward images), or an
// adjoint forward (every layer's forward images, then the backward images of
// the adjoint sweep; no sums).
constexpr int PLAN_FWD = 0, PLAN_BWD = 1, PLAN_ADJ_FWD = 2;

// Warpgroups, stages and shared memory of a pass of kind `kind` (PLAN_*) over
// `tiles` 64-row tiles, with `extra` more bytes of shared memory (a pass's own
// sums). nwg = 2 where two tiles per CTA leave every SM a tile group and
// shared memory takes two activation buffers. act_bytes: one warpgroup's
// activation images (WC_DEV: its slab of device memory, its shared memory the
// two A staging buffers and their barriers after the ring's).
static int plan_chain(const Geom& G, int tiles, int kind, size_t extra_bytes, Launch* P) {
  const bool bwd = kind == PLAN_BWD;
  int width = act_cols(G);
  if (bwd) width = width > gcols(G, G.L - 1) ? width : gcols(G, G.L - 1);
  width += side_cols(G);
  // the widest image a stage holds: forward pieces of every layer, and (bwd, adjoint
  // forward) the backward pieces (pieces of H and of P0)
  int npmax = max_piece(G.H);
  if (kind != PLAN_FWD) {
    const int m = max_piece(G.P0);
    npmax = m > npmax ? m : npmax;
  }
  if (kind != PLAN_BWD) {
    for (int l = 0; l < G.L; ++l) {
      const int m = max_piece(G.dout_pad[l]);
      npmax = m > npmax ? m : npmax;
    }
  }
  const int gb_total = G.gb_off[G.L - 1] + G.dout_true[G.L - 1];
  const size_t extra = (bwd ? (size_t)((gb_total + 3) & ~3) * 4 : 0) + extra_bytes;
  const bool dev = width_class(G) == WC_DEV;
  auto smem_of = [&](int nwg, int stages) {
    return 1024 + (size_t)nwg * (dev ? ASTAGE_BYTES : width * 128) + (size_t)stages * npmax * 128 +
           extra + 16 * stages + (dev ? 16 * MAXWG : 0);
  };
  auto fit = [&](int nwg, size_t cap) {
    for (int stages = 4; stages >= 2; --stages) {
      const size_t smem = smem_of(nwg, stages);
      if (smem <= cap) {
        *P = Launch{nwg, stages, npmax * 128, width * 128, (int)smem, (nwg + 1) * 128, 0};
        return true;
      }
    }
    return false;
  };
  // two warpgroups sharing the ring where the tiles fill the card, else one
  if (tiles >= 2 * sm_count() && fit(2, MAX_SMEM)) return 0;
  if (fit(1, MAX_SMEM)) return 0;
  return ERR_SMEM;
}

static cudaError_t persistent(const void* kernel, Launch* P, int groups) {
  int per_sm = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, P->threads, P->smem);
  if (err != cudaSuccess) return err;
  const int g = (per_sm > 0 ? per_sm : 1) * sm_count();
  P->grid = g < groups ? g : groups;
  if (P->grid < 1) P->grid = 1;
  return cudaSuccess;
}

}  // namespace k1
