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
//   from run to run). The backward passes of K4/K5 (sdf_chain.cu) and K1t/K4j
//   (fused_mlp.cu) leave their stacks in the same layout (two stacked tiles
//   per row tile where the adjoint stacks a second product, Geom::sm).
// The building blocks the kernels share with those passes are in k1.cuh. The
// forward and the per-tile pass compile once per width class (k1.cuh WC);
// past a hidden width of 512 their activation images live in device scratch
// that the wrapper allocates (mms_k1_fwd_bytes, mms_k1_bwd_bytes).
//
// Bound on an H100: the tensor-core rate for the forward and the per-tile pass
// at the main path's widths (~2 N sum(din dout) flops against 2 N (din +
// dout) bytes); chain_wgrad reads the stacks (2 N sum(din + dout) bytes) for
// 2 N sum(din dout) flops, near the card's ridge. The epilogues (activation,
// rounding, the stores of z, gz and gx) and the loads of x and gy, which the
// two consumers run in step with each other and not under the other's
// products, take most of the time; PERF.md has the times.
#include "k1.cuh"

// a named namespace: the C entry points take its structs, so their symbols
// must have external linkage
namespace k1 {

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

template <int WC>
__global__ void __launch_bounds__(NTHREADS, 1)
k1_fwd_kernel(const Geom G, const void* __restrict__ x, int x_bf16, int n,
              const bf16* __restrict__ wfw, const float* __restrict__ bpk, bf16* __restrict__ y,
              bf16* dev_act, int nwg, int stages, int sb, int act_bytes) {
  extern __shared__ uint8_t smem_raw[];
  const int r0 = acc_row(), cq = acc_col();
  chain_forward<WC>(
      align1024(smem_raw), G, n, wfw, bpk, nwg, stages, sb, act_bytes, dev_act,
      [&](bf16* act, int c0, long long row0) {
        load_rows(act, c0, G.P0, x, x_bf16, G.d_in, row0, n);
      },
      [](int, int, auto, const auto&, long long) {},
      [&](int off, auto NC, const auto& acc, long long row0) {  // y = bf16(z)
        constexpr int N = decltype(NC)::value;
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
      });
}

// ------------------------------------------------------------------- k1_bwd

struct BwdScratch {
  bf16* hin;        // hin stacks: per layer, per tile, the layer input's din_pad / 64 images
  bf16* gz;         // gz stacks: per layer, per tile, gcols / 64 images of gz_l
  uint32_t* zslab;  // per (CTA, warpgroup, hidden layer): 64 x H bf16 in accumulator order
  float* gx0slab;   // per (CTA, warpgroup): 64 x P0 f32 (skip chains)
  bf16* act;        // WC_DEV: per (CTA, warpgroup) the activation images
};

// bytes of the hin stacks, the gz stacks, the z slabs, the gx0 slabs and (WC_DEV)
// the activation slabs of act_bytes each
__host__ __device__ inline void scratch_sizes(const Geom& G, int tiles, int ctas, int nwg,
                                              int act_bytes, size_t* s) {
  stack_sizes(G, tiles, s);
  s[2] = align256((size_t)ctas * nwg * (G.L - 1) * 64 * G.H * 2);
  s[3] = G.skip_mask ? align256((size_t)ctas * nwg * 64 * G.P0 * 4) : 0;
  s[4] = width_class(G) == WC_DEV ? align256((size_t)ctas * nwg * act_bytes) : 0;
}

template <int WC>
__global__ void __launch_bounds__(NTHREADS, 1)
k1_bwd_kernel(const Geom G, const void* __restrict__ x, int x_bf16, const void* __restrict__ gy,
              int gy_bf16, int n, const bf16* __restrict__ wfw, const bf16* __restrict__ wbw,
              const float* __restrict__ bpk, void* __restrict__ gx, float* __restrict__ gb,
              BwdScratch S, int nwg, int stages, int sb, int act_bytes) {
  constexpr bool dev = WC == WC_DEV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* csum = reinterpret_cast<float*>(smem + nwg * wg_smem<WC>(act_bytes) + stages * sb);
  const int L = G.L, H = G.H, P0 = G.P0;
  const int x0c = x0_col(G);
  const int gb_total = G.gb_off[L - 1] + G.dout_true[L - 1];
  uint64_t* bars = reinterpret_cast<uint64_t*>(csum + ((gb_total + 3) & ~3));
  Ring R{smem + nwg * wg_smem<WC>(act_bytes), bars, bars + stages, sb, stages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&R.full[s], 1);
      mbar_init(&R.empty[s], nwg);
    }
    if (dev) init_astage(bars, stages);
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
        stream_hidden_fwd(R, G, wfw);
        stream_bwd(R, G, wbw, L - 1);
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp >> 2, t = threadIdx.x & 127, lane = threadIdx.x & 31;
  const int slot = blockIdx.x * nwg + wg, sidec = side_cols(G);
  bf16* act = act_images<WC>(smem, wg, act_bytes, S.act, slot);
  AStage as = astage_of(smem, wg, bars, stages);
  AStage* asp = dev ? &as : nullptr;
  {
    uint4* p = reinterpret_cast<uint4*>(act);
    for (int i = t; i < act_bytes / 16; i += 128) p[i] = make_uint4(0, 0, 0, 0);
  }
  wg_sync(1 + wg);
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
    const Stacker st{tile < tiles, dev};
    const int nph = hidden_pieces<WC>(H);  // pieces of a hidden-width product
    auto hin_at = [&](int l) {
      return S.hin + (size_t)tiles * 64 * G.hs_w[l] + (size_t)tile * 64 * G.din_pad[l];
    };
    auto gz_at = [&](int l) {
      return S.gz + (size_t)tiles * 64 * G.gs_w[l] + (size_t)tile * 64 * gcols(G, l);
    };
    load_rows(act, x0c, P0, x, x_bf16, G.d_in, row0, n);
    fence_act<WC>();
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
      for (int p = 0; p < nph; ++p) {
        int off, np;
        hidden_piece<WC>(H, p, off, np);
        bf16* dst = piece_dst<WC>(act, act_bytes, sidec, p, nph, off);
        uint32_t* zl = zs + (size_t)l * (H / 4) * 128 + (off >> 2) * 128;
        with_n64(np, [&](auto NC) {
          constexpr int N = decltype(NC)::value;
          float acc[N / 2];
          mma_piece<N>(acc, a, G.din_pad[l] >> 6, R, wg, B + off, 3, asp);
          st.drain(wg);  // the stack stores of x0 or of this layer's input have read them
          // x0 -> xs, once layer 0's last product read x0
          if (l == 0 && G.skip_mask && p + 1 == nph) scale_region(act, H, P0);
          // no loop around the two passes: acc stays in registers
          if (own_hin) {
            write_hidden<N, true>(acc, dst, next_skip, act_kind, qa, zl);
            fence_act<WC>();
            wg_sync(1 + wg);
            // the side piece's columns, or the rest of layer l + 1's input
            st.store(hin_at(l + 1) + off * 64, dst, p + 1 < nph ? N : G.din_pad[l + 1] - off);
            if (need_h) st.drain(wg);
          }
          if (need_h) {
            write_hidden<N, false>(acc, dst, next_skip, act_kind, qa, own_hin ? nullptr : zl);
            if (p + 1 == nph) {
              side_back<WC>(act, act_bytes, sidec, wg);
              fence_act<WC>();
              wg_sync(1 + wg);
            }
          }
        });
      }
    }
    if (!own_hin) st.store(hin_at(L - 1), act, G.din_pad[L - 1]);
    st.drain(wg);
    // the last layer's cotangent: bf16(gy) into columns [0, gcols), its stack and column sums
    const int dl = G.d_out, gl = gcols(G, L - 1);
    load_rows(act, 0, gl, gy, gy_bf16, dl, row0, n);
    fence_act<WC>();
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
          mma_piece<N>(acc, act, kcs, R, wg, nullptr, 3, asp);
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
          } else {  // gz_{l-1} = bf16(gh act'(z_{l-1})) (the first of two pieces to the side
                    // images), and its column sums
            const int hoff = WC ? off : 0;  // the h part's one piece starts at 0
            const uint32_t* zl = zs + (size_t)(l - 1) * (H / 4) * 128 + (hoff >> 2) * 128;
            float* cs = csum + G.gb_off[l - 1] + hoff;
            bf16* dst = piece_dst<WC>(act, act_bytes, sidec, p, npc, hoff);
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
                  *reinterpret_cast<uint32_t*>(dst + act_el(c, r0 + 8 * e)) = pack2(g0, g1);
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
      if (l > 0) side_back<WC>(act, act_bytes, sidec, wg);
      fence_act<WC>();
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

// gW_l[m, o] += sum over the stacked rows s of hin_l[s, m] gz_l[s, o]: the
// stacks hold the activation images (rows = samples), so both operands are
// read MN-major: A = one 64-column image of hin, B = the images of gz that
// hold the piece's columns. Layer l's stacks hold sm[l] tiles per row tile
// (an adjoint backward's second product stacked under the first). With
// `count`, every CTA adds the number of gW atomics it issued.
__global__ void __launch_bounds__(NTHREADS, 1)
k1_wgrad_kernel(const Geom G, int tiles, const bf16* __restrict__ hin, const bf16* __restrict__ gz,
                float* __restrict__ gw, int nwg, int stages, int sb, int splits,
                unsigned long long* count) {
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
  const int split = blockIdx.x % splits, lt = tiles * G.sm[l];
  const int t0 = (int)((long long)lt * split / splits);
  const int t1 = (int)((long long)lt * (split + 1) / splits);
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
    unsigned issued = 0;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int row = mb * 64 + r0 + 8 * (k >> 1), col = off + 8 * j + cq + (k & 1);
        if (row < din && col < dout) {
          atomicAdd(g + (size_t)row * dout + col, acc[4 * j + k]);
          ++issued;
        }
      }
    }
    if (count) atomicAdd(count, (unsigned long long)issued);
  });
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

// The forward's launch plan over n rows (0, or a status).
static int fwd_plan(const Geom& G, int n, const void** kernel, Launch* P) {
  *kernel = with_wc(G, [](auto WC) { return (const void*)k1_fwd_kernel<decltype(WC)::value>; });
  if (plan_chain(G, (n + 63) / 64, false, 0, P)) return ERR_SMEM;
  cudaError_t err = allow_smem(3 + width_class(G), *kernel);
  if (err != cudaSuccess) return (int)err;
  const int groups = ((n + 63) / 64 + P->nwg - 1) / P->nwg;
  return (int)persistent(*kernel, P, groups);
}

// Bytes of the forward's device scratch for n rows: WC_DEV's activation slabs, else 0.
extern "C" long long mms_k1_fwd_bytes(const Geom* G, int n) {
  if (!geom_ok(*G) || n < 1) return -1;
  if (width_class(*G) != WC_DEV) return 0;
  Launch P;
  const void* kernel;
  const int status = fwd_plan(*G, n, &kernel, &P);
  if (status) return status == ERR_SMEM ? ERR_SMEM : -1;
  return (long long)align256((size_t)P.grid * P.nwg * P.act_bytes);
}

// The forward: y [n, d_out] bf16; scratch: mms_k1_fwd_bytes of device memory (or null).
extern "C" int mms_k1_fwd(const Geom* G, const void* x, int x_bf16, int n, const void* wfw,
                          const void* bpk, void* y, void* scratch, void* stream) {
  if (!geom_ok(*G) || n < 1 || (width_class(*G) == WC_DEV && !scratch)) return -1;
  Launch P;
  const void* kernel;
  const int status = fwd_plan(*G, n, &kernel, &P);
  if (status) return status;
  with_wc(*G, [&](auto WC) {
    k1_fwd_kernel<decltype(WC)::value><<<P.grid, P.threads, P.smem, (cudaStream_t)stream>>>(
        *G, x, x_bf16, n, (const bf16*)wfw, (const float*)bpk, (bf16*)y, (bf16*)scratch, P.nwg,
        P.stages, P.sb, P.act_bytes);
    return 0;
  });
  return (int)cudaGetLastError();
}

// The backward pass of G's width and its launch plan over n rows (0, or a status).
static int bwd_plan(const Geom& G, int n, const void** kernel, Launch* P) {
  *kernel = with_wc(G, [](auto WC) { return (const void*)k1_bwd_kernel<decltype(WC)::value>; });
  if (plan_chain(G, (n + 63) / 64, true, 0, P)) return ERR_SMEM;
  cudaError_t err = allow_smem(6 + width_class(G), *kernel);
  if (err != cudaSuccess) return (int)err;
  const int groups = ((n + 63) / 64 + P->nwg - 1) / P->nwg;
  return (int)persistent(*kernel, P, groups);
}

// Bytes of the backward's device scratch (stacks and per-CTA slabs) for n rows.
extern "C" long long mms_k1_bwd_bytes(const Geom* G, int n) {
  if (!geom_ok(*G) || n < 1) return -1;
  Launch P;
  const void* kernel;
  const int status = bwd_plan(*G, n, &kernel, &P);
  if (status) return status == ERR_SMEM ? ERR_SMEM : -1;
  size_t s[5];
  scratch_sizes(*G, (n + 63) / 64, P.grid, P.nwg, P.act_bytes, s);
  return (long long)(s[0] + s[1] + s[2] + s[3] + s[4]);
}

static BwdScratch split_scratch(const Geom& G, int n, const Launch& P, void* scratch) {
  size_t s[5];
  scratch_sizes(G, (n + 63) / 64, P.grid, P.nwg, P.act_bytes, s);
  uint8_t* p = (uint8_t*)scratch;
  return BwdScratch{(bf16*)p, (bf16*)(p + s[0]), (uint32_t*)(p + s[0] + s[1]),
                    s[3] ? (float*)(p + s[0] + s[1] + s[2]) : nullptr,
                    s[4] ? (bf16*)(p + s[0] + s[1] + s[2] + s[3]) : nullptr};
}

// The per-tile pass: gx (x's dtype), gb (accumulated) and the stacks in scratch.
extern "C" int mms_k1_bwd(const Geom* G, const void* x, int x_bf16, const void* gy, int gy_bf16,
                          int n, const void* wfw, const void* wbw, const void* bpk, void* gx,
                          void* gb, void* scratch, void* stream) {
  if (!geom_ok(*G) || n < 1) return -1;
  Launch P;
  const void* kernel;
  const int status = bwd_plan(*G, n, &kernel, &P);
  if (status) return status;
  const BwdScratch S = split_scratch(*G, n, P, scratch);
  with_wc(*G, [&](auto WC) {
    k1_bwd_kernel<decltype(WC)::value><<<P.grid, P.threads, P.smem, (cudaStream_t)stream>>>(
        *G, x, x_bf16, gy, gy_bf16, n, (const bf16*)wfw, (const bf16*)wbw, (const float*)bpk, gx,
        (float*)gb, S, P.nwg, P.stages, P.sb, P.act_bytes);
    return 0;
  });
  return (int)cudaGetLastError();
}

// gW of every layer (accumulated) from the stacks of `tiles` row tiles that a
// backward pass left at the start of scratch (K1's, K4/K5's, K1t/K4j's);
// count (or null) receives the number of gW atomics issued.
extern "C" int mms_k1_wgrad(const Geom* G, int tiles, void* scratch, void* gw, void* count,
                            void* stream) {
  if (!geom_ok(*G) || tiles < 1) return -1;
  size_t s[2];
  stack_sizes(*G, tiles, s);
  const bf16* hin = (const bf16*)scratch;
  const bf16* gz = (const bf16*)((uint8_t*)scratch + s[0]);
  const int nwg = 2, stages = 4, sb = nwg * 8192 + 4 * 8192;  // B: the <= 4 images of a piece
  const int smem = 1024 + stages * sb + 16 * stages;
  cudaError_t err = allow_smem(2, (const void*)k1_wgrad_kernel);
  if (err != cudaSuccess) return (int)err;
  int tasks = 0;
  for (int l = 0; l < G->L; ++l) tasks += wgrad_tasks(*G, l, nwg);
  int splits = (2 * sm_count() + tasks - 1) / tasks;
  if (splits > tiles) splits = tiles;
  if (splits < 1) splits = 1;
  k1_wgrad_kernel<<<tasks * splits, (nwg + 1) * 128, smem, (cudaStream_t)stream>>>(
      *G, tiles, hin, gz, (float*)gw, nwg, stages, sb, splits, (unsigned long long*)count);
  return (int)cudaGetLastError();
}
