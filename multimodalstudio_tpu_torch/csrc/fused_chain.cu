// K1, the fused dense chain (MLP), forward and backward, redesigned for Hopper.
//
// Replaces the Pallas TPU kernels multimodalstudio_tpu/ops/pallas/fused_mlp.py
// _fwd_kernel (:265, call :845) and _bwd_kernel (:607, call :880), reached
// through fused_chain (:1080) without tangents. Cast points as chain_reference
// (:1263-1302) and _bwd_kernel (:645-789): bf16 inputs and weights, products
// accumulated in f32 plus an f32 bias, the hidden activation in f32 rounded to
// bf16, a skip layer's input concat(h, x0) / sqrt(2) rounded to bf16, y =
// bf16(z); backward: gz = bf16(gh act'(z)) with z stored in bf16, the hidden
// inputs recomputed as bf16(act(bf16(z))), gb the sum of the unrounded gz, gx
// rounded to bf16. Accumulation runs in the tensor cores over a product's
// whole depth (no per-k-step IEEE adds).
//
// Four kernels, one library:
// - k1_pack: the per-layer f32 weights (any strides) into bf16 images in the
//   order the chain kernels consume them, and the biases padded, in one
//   launch. Forward images: per layer, per output piece (N <= 256 columns),
//   per 64-deep k-chunk, W^T [N][64] K-major with the 128-byte swizzle
//   (hopper.cuh); backward images: per layer from the last, per piece of the
//   layer's input width, per 64-deep chunk of its output width, W [N][64].
//   One image is one contiguous cp.async.bulk, so no tensor map is needed.
// - k1_fwd: persistent CTAs of two consumer warpgroups (one where the tiles
//   do not fill the card or shared memory holds one activation buffer) and a
//   producer warpgroup whose one thread streams the weight images through a
//   ring of 2-4 stages that both consumers read, so a CTA reads each weight
//   once per 128 rows. A consumer owns a 64-row tile: its activations stay
//   in one shared buffer of 64-column images ([h | x0] where a skip layer
//   reads x0 again, else x0 first, overwritten by layer 0's output), and
//   each layer's epilogue writes them back in place from the accumulator
//   registers once the layer's wgmmas retired. The bias seeds the
//   accumulators. x arrives as f32 or bf16, read as 16-byte vectors.
// - k1_bwd: the per-tile pass. Recomputes the hidden layers (bf16 z kept per
//   thread in a device-scratch slab, in the accumulator's own order), then the
//   reverse sweep gh = gz W^T by wgmma on the backward images. Writes gx, gb
//   (per-CTA column sums, one atomic per column per CTA) and two stacks: the
//   activation images of every layer's input (hin_l) and of gz_l (gz_{L-1}
//   = bf16(gy)), each copied from shared memory by one bulk store.
// - k1_wgrad: gW_l = hin_l^T gz_l for every layer in one launch, over a grid of
//   (layer, pair of 64-row blocks of W, output piece, split of the tiles); A
//   and B are the stacks' images, staged by bulk copies and read MN-major;
//   each CTA adds its f32 tile to gW once (atomics: the sum's order changes
//   from run to run).
//
// Bound on an H100: the tensor-core rate for the forward and the per-tile pass
// at the main path's widths (~2 N sum(din dout) flops against 2 N (din +
// dout) bytes); chain_wgrad reads the stacks (2 N sum(din + dout) bytes) for
// 2 N sum(din dout) flops, near the card's ridge. The epilogues (activation,
// rounding, the stores of z, gz and gx) and the loads of x and gy, which the
// two consumers run in step with each other and not under the other's
// products, take most of the time; PERF.md has the times.
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"

// a named namespace: the C entry points take its structs, so their symbols
// must have external linkage
namespace k1 {

using bf16 = __nv_bfloat16;
using namespace hop;

constexpr int MAXL = 32;            // layers (build.py MAX_LAYERS)
constexpr int MAXPIECES = 8;        // pieces of one product's output width
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

// Layout of one chain (fused_mlp.py K1Geom builds it): widths padded to 64 for
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
  int hs_w[MAXL + 1];          // hin stack columns before layer l
  int gs_w[MAXL + 1];          // gz stack columns before layer l
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
// the h part (one piece of H); layer 0: pieces of P0.
__host__ __device__ __forceinline__ int bwd_n_pieces(const Geom& G, int l) {
  if (l == 0) return n_pieces(G.P0);
  return ((G.skip_mask >> l) & 1) ? n_pieces(G.P0) + 1 : 1;
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
  off = 0;
  np = G.H;
  x0part = false;
}

__host__ __device__ __forceinline__ int gcols(const Geom& G, int l) {
  return ceil64(G.dout_pad[l]);
}

// The activation images of a tile: [h (H) | x0 (P0)] where a skip layer reads
// x0 again; else x0 in the first columns, which layer 0's output overwrites.
__host__ __device__ __forceinline__ int x0_col(const Geom& G) { return G.skip_mask ? G.H : 0; }
__host__ __device__ __forceinline__ int act_cols(const Geom& G) {
  return G.skip_mask ? G.H + G.P0 : (G.H > G.P0 ? G.H : G.P0);
}

// shared-memory element (bf16) of activation column c, row r
__device__ __forceinline__ int act_el(int c, int r) { return (c >> 6) * 4096 + img(r, c & 63); }

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
// memory, B the next kcs ring stages; bias (f32, from column 0 of the piece)
// or zeros. The bias seeds the accumulators, so its loads are in flight
// while the first stage lands. Releases each stage once its wgmmas retired.
template <int N>
__device__ __forceinline__ void mma_piece(float (&acc)[N / 2], const bf16* a, int kcs, Ring& R,
                                          int wg, const float* bias) {
  const int cq = acc_col();
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 b =
        bias ? *reinterpret_cast<const float2*>(bias + 8 * j + cq) : make_float2(0.f, 0.f);
    acc[4 * j] = acc[4 * j + 2] = b.x;
    acc[4 * j + 1] = acc[4 * j + 3] = b.y;
  }
  for (int kc = 0; kc < kcs; ++kc) {
    mbar_wait(&R.full[R.stage], R.phase);
    const bf16* ak = a + kc * 4096;
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

// ------------------------------------------------------------------ k1_pack

// blockIdx.y: the job (0: biases, 1..L: a layer's forward images, L+1..2L its
// backward images); blockIdx.x splits a job's 16-byte units
__global__ void __launch_bounds__(256) k1_pack_kernel(const Geom G, const PackArgs P, bf16* wfw,
                                                      bf16* wbw, float* bpk) {
  const int L = G.L;
  int job = blockIdx.y;
  const int u0 = blockIdx.x * blockDim.x + threadIdx.x, ustep = gridDim.x * blockDim.x;
  if (job == 0) {  // biases
    for (int l = 0; l < L; ++l)
      for (int c = u0; c < G.dout_pad[l]; c += ustep)
        bpk[G.b_off[l] + c] = c < G.dout_true[l] ? P.b[l][c] : 0.f;
    return;
  }
  --job;
  const bool fwd = job < L;
  const int l = fwd ? job : job - L;
  const float* W = P.w[l];
  const long long s0 = P.ws0[l], s1 = P.ws1[l];
  const int din = G.din_true[l], dout = G.dout_true[l];
  // each piece spans np rows of images over `depth` k (64-deep chunks)
  const int depth = fwd ? G.din_pad[l] : gcols(G, l);
  const int npc = fwd ? n_pieces(G.dout_pad[l]) : bwd_n_pieces(G, l);
  bf16* out = fwd ? wfw + G.fw_off[l] : wbw + G.bw_off[l];
  long long base = 0;
  for (int p = 0; p < npc; ++p) {
    int off, np;
    bool x0part = false;
    if (fwd)
      piece(G.dout_pad[l], p, off, np);
    else
      bwd_piece(G, l, p, off, np, x0part);
    const int units = np * depth / 8;  // 16-byte units of the piece
    for (int u = u0; u < units; u += ustep) {
      const int kc = u / (np * 8), w = u % (np * 8);
      const int row = w >> 3, slot = w & 7;
      const int g = (slot ^ row) & 7;  // the k group stored in this slot
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        float a[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = kc * 64 + 8 * g + e + h;
          // fwd: image row = output column off + row, k = input row; bwd: the reverse
          const int i = fwd ? k : off + row, o = fwd ? off + row : k;
          a[h] = (i < din && o < dout) ? W[i * s0 + o * s1] : 0.f;
        }
        v[e / 2] = pack2(a[0], a[1]);
      }
      *reinterpret_cast<uint4*>(out + base + (long long)u * 8) = make_uint4(v[0], v[1], v[2], v[3]);
    }
    base += (long long)np * depth;
  }
}

// ------------------------------------------------------------------- k1_fwd

struct Launch {
  int nwg, stages, sb, act_bytes, smem, threads, grid;
};

__global__ void __launch_bounds__(NTHREADS, 1)
k1_fwd_kernel(const Geom G, const void* __restrict__ x, int x_bf16, int n,
              const bf16* __restrict__ wfw, const float* __restrict__ bpk, bf16* __restrict__ y,
              int nwg, int stages, int sb, int act_bytes) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + nwg * act_bytes + stages * sb);
  Ring R{smem + nwg * act_bytes, bars, bars + stages, sb, stages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&R.full[s], 1);
      mbar_init(&R.empty[s], nwg);
    }
    fence_mbar_init();
  }
  __syncthreads();
  const int L = G.L, H = G.H, P0 = G.P0;
  const int x0c = x0_col(G);
  const int tiles = (n + 63) / 64, groups = (tiles + nwg - 1) / nwg;
  const int warp = threadIdx.x >> 5;
  if (warp >= nwg * 4) {  // producer: the forward images, in order, once per tile group
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == nwg * 128) {
      for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
        const uint8_t* src = reinterpret_cast<const uint8_t*>(wfw);
        for (int l = 0; l < L; ++l) {
          const int kcs = G.din_pad[l] >> 6, npc = n_pieces(G.dout_pad[l]);
          for (int p = 0; p < npc; ++p) {
            int off, np;
            piece(G.dout_pad[l], p, off, np);
            for (int kc = 0; kc < kcs; ++kc) {
              R.acquire(np * 128);
              bulk_g2s(R.buf(), src, np * 128, &R.full[R.stage]);
              R.advance();
              src += np * 128;
            }
          }
        }
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp >> 2;
  bf16* act = reinterpret_cast<bf16*>(smem + wg * act_bytes);
  {
    uint4* p = reinterpret_cast<uint4*>(act);
    for (int i = threadIdx.x & 127; i < act_bytes / 16; i += 128) p[i] = make_uint4(0, 0, 0, 0);
  }
  wg_sync(1 + wg);
  const int r0 = acc_row(), cq = acc_col();
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long row0 = (long long)(grp * nwg + wg) * 64;
    load_rows(act, x0c, P0, x, x_bf16, G.d_in, row0, n);
    fence_async_smem();
    wg_sync(1 + wg);
    for (int l = 0; l < L; ++l) {
      const bf16* a = act + (l == 0 ? (x0c >> 6) * 4096 : 0);
      const int kcs = G.din_pad[l] >> 6, npc = n_pieces(G.dout_pad[l]);
      const bool last = l == L - 1;
      const bool next_skip = !last && ((G.skip_mask >> (l + 1)) & 1);
      const float* B = bpk + G.b_off[l];
      for (int p = 0; p < npc; ++p) {
        int off, np;
        piece(G.dout_pad[l], p, off, np);
        with_n(np, [&](auto NC) {
          constexpr int N = decltype(NC)::value;
          float acc[N / 2];
          mma_piece<N>(acc, a, kcs, R, wg, B + off);
          if (last) {  // y = bf16(z)
            const bool pairs = !(G.d_out & 1);
#pragma unroll
            for (int j = 0; j < N / 8; ++j) {
              const int c = off + 8 * j + cq;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const long long gr = row0 + r0 + 8 * e;
                if (gr >= n || c >= G.d_out) continue;
                bf16* yr = y + gr * G.d_out + c;
                const uint32_t v = pack2(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
                if (pairs) {
                  *reinterpret_cast<uint32_t*>(yr) = v;
                } else {
                  *reinterpret_cast<unsigned short*>(yr) = (unsigned short)(v & 0xffff);
                  if (c + 1 < G.d_out)
                    *reinterpret_cast<unsigned short*>(yr + 1) = (unsigned short)(v >> 16);
                }
              }
            }
          } else {  // h = bf16(act(z)) (times 1/sqrt 2, rounded, before a skip layer), in place
            const int act_kind = G.act;
            const float qa = G.quad_a;
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
                *reinterpret_cast<uint32_t*>(act + act_el(c, r0 + 8 * e)) = h;
              }
            }
          }
        });
      }
      if (l == 0 && G.skip_mask) scale_region(act, H, P0);
      fence_async_smem();
      wg_sync(1 + wg);
    }
  }
}

// ------------------------------------------------------------------- k1_bwd

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

struct BwdScratch {
  bf16* hin;        // hin stacks: per layer, per tile, the layer input's din_pad / 64 images
  bf16* gz;         // gz stacks: per layer, per tile, gcols / 64 images of gz_l
  uint32_t* zslab;  // per (CTA, warpgroup, hidden layer): 64 x H bf16 in accumulator order
  float* gx0slab;   // per (CTA, warpgroup): 64 x P0 f32 (skip chains)
};

// bytes of the hin stacks, the gz stacks, the z slabs and the gx0 slabs
__host__ __device__ inline void scratch_sizes(const Geom& G, int tiles, int ctas, int nwg,
                                              size_t* s) {
  s[0] = ((size_t)tiles * 64 * G.hs_w[G.L] * 2 + 255) & ~size_t(255);
  s[1] = ((size_t)tiles * 64 * G.gs_w[G.L] * 2 + 255) & ~size_t(255);
  s[2] = ((size_t)ctas * nwg * (G.L - 1) * 64 * G.H * 2 + 255) & ~size_t(255);
  s[3] = G.skip_mask ? (((size_t)ctas * nwg * 64 * G.P0 * 4 + 255) & ~size_t(255)) : 0;
}

// The stacks are the activation images themselves: thread 0 of the warpgroup
// copies a region of them to device memory with one bulk store, and waits for
// the store to have read shared memory before the region is written again.
struct Stacker {
  bool on;  // the tile is a real one (a group's spare tile stores nothing)
  __device__ __forceinline__ void store(bf16* dst, const bf16* src, int cols) const {
    if (on && (threadIdx.x & 127) == 0) bulk_s2g(dst, src, (uint32_t)cols * 128);
  }
  __device__ __forceinline__ void drain(int wg) const {
    if ((threadIdx.x & 127) == 0) bulk_wait_read();
    wg_sync(1 + wg);
  }
};

__global__ void __launch_bounds__(NTHREADS, 1)
k1_bwd_kernel(const Geom G, const void* __restrict__ x, int x_bf16, const void* __restrict__ gy,
              int gy_bf16, int n, const bf16* __restrict__ wfw, const bf16* __restrict__ wbw,
              const float* __restrict__ bpk, void* __restrict__ gx, float* __restrict__ gb,
              BwdScratch S, int nwg, int stages, int sb, int act_bytes) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* csum = reinterpret_cast<float*>(smem + nwg * act_bytes + stages * sb);
  const int L = G.L, H = G.H, P0 = G.P0;
  const int x0c = x0_col(G);
  const int gb_total = G.gb_off[L - 1] + G.dout_true[L - 1];
  uint64_t* bars = reinterpret_cast<uint64_t*>(csum + ((gb_total + 3) & ~3));
  Ring R{smem + nwg * act_bytes, bars, bars + stages, sb, stages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&R.full[s], 1);
      mbar_init(&R.empty[s], nwg);
    }
    fence_mbar_init();
  }
  for (int i = threadIdx.x; i < gb_total; i += blockDim.x) csum[i] = 0.f;
  __syncthreads();
  const int tiles = (n + 63) / 64, groups = (tiles + nwg - 1) / nwg;
  const int warp = threadIdx.x >> 5;
  if (warp >= nwg * 4) {  // producer: forward images of the hidden layers, then the backward images
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == nwg * 128) {
      for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
        const uint8_t* src = reinterpret_cast<const uint8_t*>(wfw);
        for (int l = 0; l < L - 1; ++l) {
          for (int kc = 0; kc < (G.din_pad[l] >> 6); ++kc) {  // one piece: H
            R.acquire(H * 128);
            bulk_g2s(R.buf(), src, H * 128, &R.full[R.stage]);
            R.advance();
            src += H * 128;
          }
        }
        src = reinterpret_cast<const uint8_t*>(wbw);
        for (int l = L - 1; l >= 0; --l) {
          const int kcs = gcols(G, l) >> 6, npc = bwd_n_pieces(G, l);
          for (int p = 0; p < npc; ++p) {
            int off, np;
            bool x0part;
            bwd_piece(G, l, p, off, np, x0part);
            for (int kc = 0; kc < kcs; ++kc) {
              R.acquire(np * 128);
              bulk_g2s(R.buf(), src, np * 128, &R.full[R.stage]);
              R.advance();
              src += np * 128;
            }
          }
        }
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp >> 2, t = threadIdx.x & 127, lane = threadIdx.x & 31;
  bf16* act = reinterpret_cast<bf16*>(smem + wg * act_bytes);
  {
    uint4* p = reinterpret_cast<uint4*>(act);
    for (int i = t; i < act_bytes / 16; i += 128) p[i] = make_uint4(0, 0, 0, 0);
  }
  wg_sync(1 + wg);
  const int slot = blockIdx.x * nwg + wg;
  uint32_t* zs = S.zslab + (size_t)slot * (L - 1) * (H / 4) * 128;
  float* gx0 = S.gx0slab ? S.gx0slab + (size_t)slot * (P0 / 2) * 128 : nullptr;
  const int top_skip = G.skip_mask ? 31 - __clz(G.skip_mask) : -1;
  const int r0 = acc_row(), cq = acc_col();
  const float qa = G.quad_a;
  const int act_kind = G.act;
  // the stack keeps bf16(act(bf16(z))), the activation h = bf16(act(z)) of the forward:
  // equal for ReLU and None, not for SoftplusQuad, which stores its stack image first
  const bool own_hin = act_kind == ACT_SOFTPLUS_QUAD;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int tile = grp * nwg + wg;
    const long long row0 = (long long)tile * 64;
    const Stacker st{tile < tiles};
    auto hin_at = [&](int l) {
      return S.hin + (size_t)tiles * 64 * G.hs_w[l] + (size_t)tile * 64 * G.din_pad[l];
    };
    auto gz_at = [&](int l) {
      return S.gz + (size_t)tiles * 64 * G.gs_w[l] + (size_t)tile * 64 * gcols(G, l);
    };
    load_rows(act, x0c, P0, x, x_bf16, G.d_in, row0, n);
    fence_async_smem();
    wg_sync(1 + wg);
    st.store(hin_at(0), act + (x0c >> 6) * 4096, P0);
    // forward recompute of the hidden layers; the stack image of layer l's input
    // is stored as its product starts (own_hin: by the layer before)
    for (int l = 0; l < L - 1; ++l) {
      const bf16* a = act + (l == 0 ? (x0c >> 6) * 4096 : 0);
      if (l > 0 && !own_hin) st.store(hin_at(l), act, G.din_pad[l]);
      const bool next_skip = (G.skip_mask >> (l + 1)) & 1;
      // own_hin: the stack image of layer l + 1's input first; then h, which
      // layer l + 1's product reads (own_hin: unless it is the last, not recomputed)
      const bool need_h = !own_hin || l + 1 < L - 1;
      const float* B = bpk + G.b_off[l];
      uint32_t* zl = zs + (size_t)l * (H / 4) * 128;
      with_n(H, [&](auto NC) {
        constexpr int N = decltype(NC)::value;
        float acc[N / 2];
        mma_piece<N>(acc, a, G.din_pad[l] >> 6, R, wg, B);
        st.drain(wg);  // the stack stores of x0 or of this layer's input have read them
        if (l == 0 && G.skip_mask) scale_region(act, H, P0);  // x0 -> xs, once layer 0 read x0
        // no loop around the two passes: acc stays in registers
        if (own_hin) {
          write_hidden<N, true>(acc, act, next_skip, act_kind, qa, zl);
          fence_async_smem();
          wg_sync(1 + wg);
          st.store(hin_at(l + 1), act, G.din_pad[l + 1]);
          if (need_h) st.drain(wg);
        }
        if (need_h) {
          write_hidden<N, false>(acc, act, next_skip, act_kind, qa, own_hin ? nullptr : zl);
          fence_async_smem();
          wg_sync(1 + wg);
        }
      });
    }
    if (!own_hin) st.store(hin_at(L - 1), act, G.din_pad[L - 1]);
    st.drain(wg);
    // the last layer's cotangent: bf16(gy) into columns [0, gcols), its stack and column sums
    const int dl = G.d_out, gl = gcols(G, L - 1);
    load_rows(act, 0, gl, gy, gy_bf16, dl, row0, n);
    fence_async_smem();
    wg_sync(1 + wg);
    st.store(gz_at(L - 1), act, gl);
    for (int c = t; c < dl; c += 128) {
      float s = 0.f;
      for (int r = 0; r < 64; ++r) s += bf(act[act_el(c, r)]);
      atomicAdd(&csum[G.gb_off[L - 1] + c], s);
    }
    // reverse sweep: gh = gz_l W_l^T
    for (int l = L - 1; l >= 0; --l) {
      const int kcs = gcols(G, l) >> 6, npc = bwd_n_pieces(G, l);
      const bool skip = (G.skip_mask >> l) & 1;
      for (int p = 0; p < npc; ++p) {
        int off, np;
        bool x0part;
        bwd_piece(G, l, p, off, np, x0part);
        with_n(np, [&](auto NC) {
          constexpr int N = decltype(NC)::value;
          float acc[N / 2];
          mma_piece<N>(acc, act, kcs, R, wg, nullptr);
          // slab words are loaded JB column blocks at a time, all in flight before use
          constexpr int JB = N / 8 < 8 ? N / 8 : 8;
          if (l == 0) {  // gx = bf16(gh_0 + gx0)
            const long long grow[2] = {row0 + r0, row0 + r0 + 8};
#pragma unroll
            for (int j0 = 0; j0 < N / 8; j0 += JB) {
              float g[4 * JB];
#pragma unroll
              for (int i = 0; i < 4 * JB; ++i)
                g[i] = gx0 ? gx0[((off >> 1) + 4 * j0 + i) * 128 + t] : 0.f;
#pragma unroll
              for (int jj = 0; jj < JB; ++jj) {
                const int j = j0 + jj, c = off + 8 * j + cq;
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  const bf16 v = __float2bfloat16(acc[4 * j + k] + g[4 * jj + k]);
                  const long long gr = grow[k >> 1];
                  const int cc = c + (k & 1);
                  if (gr < n && cc < G.d_in) {
                    if (x_bf16)
                      static_cast<bf16*>(gx)[gr * G.d_in + cc] = v;
                    else
                      static_cast<float*>(gx)[gr * G.d_in + cc] = bf(v);
                  }
                }
              }
            }
          } else if (x0part) {  // a skip layer's x0 columns: gx0 += gh * (1 / sqrt 2)
            float* g = gx0 + ((off - H) >> 1) * 128 + t;
            const bool first = l == top_skip;
#pragma unroll
            for (int j0 = 0; j0 < N / 8; j0 += JB) {
              float old[4 * JB];
#pragma unroll
              for (int i = 0; i < 4 * JB; ++i) old[i] = first ? 0.f : g[(4 * j0 + i) * 128];
#pragma unroll
              for (int i = 0; i < 4 * JB; ++i) {
                const float v = acc[4 * j0 + i] * SKIP_SCALE;
                g[(4 * j0 + i) * 128] = first ? v : old[i] + v;
              }
            }
          } else {  // gz_{l-1} = bf16(gh act'(z_{l-1})), in place, and its column sums
            const uint32_t* zl = zs + (size_t)(l - 1) * (H / 4) * 128;
            float* cs = csum + G.gb_off[l - 1];
            st.drain(wg);  // the stack store of gz_l has read the region
#pragma unroll
            for (int j0 = 0; j0 < N / 8; j0 += JB) {
              uint32_t zz[2 * JB];
#pragma unroll
              for (int i = 0; i < 2 * JB; ++i) zz[i] = zl[(2 * j0 + i) * 128 + t];
#pragma unroll
              for (int jj = 0; jj < JB; ++jj) {
                const int j = j0 + jj, c = 8 * j + cq;
                float s0 = 0.f, s1 = 0.f;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const float2 z = unpack2(zz[2 * jj + e]);
                  float g0 = acc[4 * j + 2 * e], g1 = acc[4 * j + 2 * e + 1];
                  if (skip) {
                    g0 *= SKIP_SCALE;
                    g1 *= SKIP_SCALE;
                  }
                  g0 *= act_df(act_kind, z.x, qa);
                  g1 *= act_df(act_kind, z.y, qa);
                  s0 += g0;
                  s1 += g1;
                  *reinterpret_cast<uint32_t*>(act + act_el(c, r0 + 8 * e)) = pack2(g0, g1);
                }
#pragma unroll
                for (int m = 4; m < 32; m <<= 1) {
                  s0 += __shfl_xor_sync(0xffffffffu, s0, m);
                  s1 += __shfl_xor_sync(0xffffffffu, s1, m);
                }
                if (lane < 4) {
                  atomicAdd(&cs[c], s0);
                  atomicAdd(&cs[c + 1], s1);
                }
              }
            }
          }
        });
      }
      fence_async_smem();
      wg_sync(1 + wg);
      if (l > 0) st.store(gz_at(l - 1), act, H);
    }
    st.drain(wg);  // before the next tile's rows land
  }
  if ((threadIdx.x & 127) == 0) bulk_wait_all();
  bar_sync(SUM_BAR, nwg * 128);
  for (int i = threadIdx.x; i < gb_total; i += nwg * 128)
    if (csum[i] != 0.f) atomicAdd(&gb[i], csum[i]);
}

// ----------------------------------------------------------------- k1_wgrad

// Tasks of one layer: pairs (of nwg) of 64-row blocks of W times output pieces
__host__ __device__ inline int wgrad_tasks(const Geom& G, int l, int nwg) {
  const int mb = G.din_pad[l] >> 6;
  return (mb + nwg - 1) / nwg * n_pieces(G.dout_pad[l]);
}

// gW_l[m, o] += sum over the tiles' samples s of hin_l[s, m] gz_l[s, o]: the
// stacks hold the activation images (rows = samples), so both operands are
// read MN-major: A = one 64-column image of hin, B = the images of gz that
// hold the piece's columns.
__global__ void __launch_bounds__(NTHREADS, 1)
k1_wgrad_kernel(const Geom G, int tiles, const bf16* __restrict__ hin, const bf16* __restrict__ gz,
                float* __restrict__ gw, int nwg, int stages, int sb, int splits) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + stages * sb);
  Ring R{smem, bars, bars + stages, sb, stages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&R.full[s], 1);
      mbar_init(&R.empty[s], nwg);
    }
    fence_mbar_init();
  }
  __syncthreads();
  // this CTA's task: layer l, block pair mp, piece p; and its tiles [t0, t1)
  int task = blockIdx.x / splits, l = 0;
  while (task >= wgrad_tasks(G, l, nwg)) {
    task -= wgrad_tasks(G, l, nwg);
    ++l;
  }
  const int npc = n_pieces(G.dout_pad[l]);
  const int mp = task / npc;
  int off, np;
  piece(G.dout_pad[l], task % npc, off, np);
  const int split = blockIdx.x % splits;
  const int t0 = (int)((long long)tiles * split / splits);
  const int t1 = (int)((long long)tiles * (split + 1) / splits);
  const int mblocks = G.din_pad[l] >> 6;
  const int valid_wg = min(nwg, mblocks - mp * nwg);
  const int b_imgs = ((off & 63) + np + 63) >> 6;  // gz images holding the piece
  const bf16* hs = hin + (size_t)tiles * 64 * G.hs_w[l];
  const bf16* gs = gz + (size_t)tiles * 64 * G.gs_w[l];
  const int warp = threadIdx.x >> 5;
  if (warp >= nwg * 4) {  // producer: per tile the A image of each valid warpgroup, then B
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == nwg * 128) {
      for (int tl = t0; tl < t1; ++tl) {
        R.acquire(valid_wg * 8192 + b_imgs * 8192);
        for (int g = 0; g < valid_wg; ++g)
          bulk_g2s(R.buf() + g * 8192, hs + ((size_t)tl * G.din_pad[l] + (mp * nwg + g) * 64) * 64,
                   8192, &R.full[R.stage]);
        bulk_g2s(R.buf() + nwg * 8192, gs + ((size_t)tl * gcols(G, l) + (off & ~63)) * 64,
                 b_imgs * 8192, &R.full[R.stage]);
        R.advance();
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp >> 2;
  const bool valid = wg < valid_wg;
  const int mb = mp * nwg + wg;
  with_n(np, [&](auto NC) {
    constexpr int N = decltype(NC)::value;
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    for (int tl = t0; tl < t1; ++tl) {
      mbar_wait(&R.full[R.stage], R.phase);
      if (valid) {
        const uint8_t* a = R.buf() + wg * 8192;
        const uint8_t* b = R.buf() + nwg * 8192 + (off & 63) * 2;
        reg_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Wgmma<N, 1, 1>::run(acc, desc_mn_sw128(a + j * 2048, 8192),
                              desc_mn_sw128(b + j * 2048, 8192), 1);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(acc);
      }
      R.release(wg);
    }
    if (!valid) return;
    const int r0 = acc_row(), cq = acc_col();
    const int din = G.din_true[l], dout = G.dout_true[l];
    float* g = gw + G.gw_off[l];
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int row = mb * 64 + r0 + 8 * (k >> 1), col = off + 8 * j + cq + (k & 1);
        if (row < din && col < dout) atomicAdd(g + (size_t)row * dout + col, acc[4 * j + k]);
      }
    }
  });
}

// ------------------------------------------------------------------- launch

int g_sms = 0;
bool g_attr[3] = {false, false, false};

int sm_count() {
  if (!g_sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      g_sms = 0;
  }
  return g_sms > 0 ? g_sms : 1;
}

cudaError_t allow_smem(int which, const void* kernel) {
  if (g_attr[which]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
  if (err == cudaSuccess) g_attr[which] = true;
  return err;
}

int max_piece(int w) {
  int m = 0;
  for (int i = 0; i < n_pieces(w); ++i) {
    int off, np;
    piece(w, i, off, np);
    m = np > m ? np : m;
  }
  return m;
}

// Checks what the kernels take: 2..MAXL layers, H in {64, 128, 256}, at most
// MAXPIECES pieces per product.
bool geom_ok(const Geom& G) {
  if (G.L < 2 || G.L > MAXL) return false;
  if (G.H != 64 && G.H != 128 && G.H != 256) return false;
  if (G.skip_mask & 1) return false;
  for (int l = 0; l < G.L; ++l)
    if (n_pieces(G.dout_pad[l]) > MAXPIECES || bwd_n_pieces(G, l) > MAXPIECES) return false;
  return true;
}

// Warpgroups, stages and shared memory of the forward (bwd: also the column
// sums and the backward images). nwg = 2 where two tiles per CTA leave every
// SM a tile group and shared memory takes two activation buffers.
int plan_chain(const Geom& G, int n, bool bwd, Launch* P) {
  const int tiles = (n + 63) / 64;
  int width = act_cols(G);
  if (bwd) width = width > gcols(G, G.L - 1) ? width : gcols(G, G.L - 1);
  // the widest image a stage holds: forward pieces, or (bwd) the hidden layers' H and
  // the backward pieces (H, pieces of P0)
  int npmax = G.H;
  if (bwd) {
    const int m = max_piece(G.P0);
    npmax = m > npmax ? m : npmax;
  } else {
    for (int l = 0; l < G.L; ++l) {
      const int m = max_piece(G.dout_pad[l]);
      npmax = m > npmax ? m : npmax;
    }
  }
  const int gb_total = G.gb_off[G.L - 1] + G.dout_true[G.L - 1];
  const size_t extra = bwd ? (size_t)((gb_total + 3) & ~3) * 4 : 0;
  auto smem_of = [&](int nwg, int stages) {
    return 1024 + (size_t)nwg * width * 128 + (size_t)stages * npmax * 128 + extra + 16 * stages;
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

cudaError_t persistent(const void* kernel, Launch* P, int groups) {
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

using namespace k1;

// One launch: forward images (and backward images when wbw != null) and the
// padded biases of a chain.
extern "C" int mms_k1_pack(const Geom* G, const PackArgs* P, void* wfw, void* wbw, void* bpk,
                           void* stream) {
  if (!geom_ok(*G)) return -1;
  const dim3 grid(16, 1 + G->L + (wbw ? G->L : 0));
  k1_pack_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(*G, *P, (bf16*)wfw, (bf16*)wbw,
                                                         (float*)bpk);
  return (int)cudaGetLastError();
}

extern "C" int mms_k1_fwd(const Geom* G, const void* x, int x_bf16, int n, const void* wfw,
                          const void* bpk, void* y, void* stream) {
  if (!geom_ok(*G) || n < 1) return -1;
  Launch P;
  if (plan_chain(*G, n, false, &P)) return ERR_SMEM;
  cudaError_t err = allow_smem(0, (const void*)k1_fwd_kernel);
  if (err != cudaSuccess) return (int)err;
  const int groups = ((n + 63) / 64 + P.nwg - 1) / P.nwg;
  err = persistent((const void*)k1_fwd_kernel, &P, groups);
  if (err != cudaSuccess) return (int)err;
  k1_fwd_kernel<<<P.grid, P.threads, P.smem, (cudaStream_t)stream>>>(
      *G, x, x_bf16, n, (const bf16*)wfw, (const float*)bpk, (bf16*)y, P.nwg, P.stages, P.sb,
      P.act_bytes);
  return (int)cudaGetLastError();
}

// Bytes of the backward's device scratch (stacks and per-CTA slabs) for n rows.
extern "C" long long mms_k1_bwd_bytes(const Geom* G, int n) {
  if (!geom_ok(*G) || n < 1) return -1;
  Launch P;
  if (plan_chain(*G, n, true, &P)) return ERR_SMEM;
  if (allow_smem(1, (const void*)k1_bwd_kernel) != cudaSuccess) return -1;
  const int groups = ((n + 63) / 64 + P.nwg - 1) / P.nwg;
  if (persistent((const void*)k1_bwd_kernel, &P, groups) != cudaSuccess) return -1;
  size_t s[4];
  scratch_sizes(*G, (n + 63) / 64, P.grid, P.nwg, s);
  return (long long)(s[0] + s[1] + s[2] + s[3]);
}

static BwdScratch split_scratch(const Geom& G, int n, const Launch& P, void* scratch) {
  size_t s[4];
  scratch_sizes(G, (n + 63) / 64, P.grid, P.nwg, s);
  uint8_t* p = (uint8_t*)scratch;
  return BwdScratch{(bf16*)p, (bf16*)(p + s[0]), (uint32_t*)(p + s[0] + s[1]),
                    s[3] ? (float*)(p + s[0] + s[1] + s[2]) : nullptr};
}

// The per-tile pass: gx (x's dtype), gb (accumulated) and the stacks in scratch.
extern "C" int mms_k1_bwd(const Geom* G, const void* x, int x_bf16, const void* gy, int gy_bf16,
                          int n, const void* wfw, const void* wbw, const void* bpk, void* gx,
                          void* gb, void* scratch, void* stream) {
  if (!geom_ok(*G) || n < 1) return -1;
  Launch P;
  if (plan_chain(*G, n, true, &P)) return ERR_SMEM;
  cudaError_t err = allow_smem(1, (const void*)k1_bwd_kernel);
  if (err != cudaSuccess) return (int)err;
  const int groups = ((n + 63) / 64 + P.nwg - 1) / P.nwg;
  err = persistent((const void*)k1_bwd_kernel, &P, groups);
  if (err != cudaSuccess) return (int)err;
  k1_bwd_kernel<<<P.grid, P.threads, P.smem, (cudaStream_t)stream>>>(
      *G, x, x_bf16, gy, gy_bf16, n, (const bf16*)wfw, (const bf16*)wbw, (const float*)bpk, gx,
      (float*)gb, split_scratch(*G, n, P, scratch), P.nwg, P.stages, P.sb, P.act_bytes);
  return (int)cudaGetLastError();
}

// gW of every layer from the stacks the per-tile pass left in scratch (accumulated).
extern "C" int mms_k1_wgrad(const Geom* G, int n, void* scratch, void* gw, void* stream) {
  if (!geom_ok(*G) || n < 1) return -1;
  Launch B;
  if (plan_chain(*G, n, true, &B)) return ERR_SMEM;
  cudaError_t err = allow_smem(1, (const void*)k1_bwd_kernel);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + 63) / 64;
  err = persistent((const void*)k1_bwd_kernel, &B, (tiles + B.nwg - 1) / B.nwg);
  if (err != cudaSuccess) return (int)err;
  const BwdScratch S = split_scratch(*G, n, B, scratch);
  const int nwg = 2, stages = 4, sb = nwg * 8192 + 4 * 8192;  // B: the <= 4 images of a piece
  const int smem = 1024 + stages * sb + 16 * stages;
  err = allow_smem(2, (const void*)k1_wgrad_kernel);
  if (err != cudaSuccess) return (int)err;
  int tasks = 0;
  for (int l = 0; l < G->L; ++l) tasks += wgrad_tasks(*G, l, nwg);
  int splits = (2 * sm_count() + tasks - 1) / tasks;
  if (splits > tiles) splits = tiles;
  if (splits < 1) splits = 1;
  k1_wgrad_kernel<<<tasks * splits, (nwg + 1) * 128, smem, (cudaStream_t)stream>>>(
      *G, tiles, S.hin, S.gz, (float*)gw, nwg, stages, sb, splits);
  return (int)cudaGetLastError();
}
