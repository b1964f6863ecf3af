// The fused dense chain with forward tangents for Hopper: K1t and K4j (K1 without
// tangents is csrc/fused_chain.cu). A tile's chain runs out of shared memory, so
// inter-layer activations never touch device memory. The forwards are the first
// design below (wmma, weights from L2); the backwards are a per-tile pass on K1's
// wgmma building blocks (k1.cuh) and chain_wgrad (fused_chain.cu), "tangent
// backward" below.
#include "enc.cuh"
#include "k1.cuh"

using namespace mms;

// ------------------------------------------------------------ forward tangents
//
// K1t and K4j: the chain with K forward tangents (K <= 3). Replaces the Pallas TPU
// kernels multimodalstudio_tpu/ops/pallas/fused_mlp.py _fwd_kernel (:265) and
// _bwd_kernel (:607) with n_tangents = K, reached through fused_chain (:1080,
// tangents=tx; K1t) and fused_sdf_chain (:1145, mode="jvp", the encoding inside and
// its 3 basis tangents; K4j), which _build_chain (:845) builds.
//
// Tile: the tangent rows u = t W share W with the primal rows z = h W + b, so a CTA
// runs one 64-row product per layer over b samples: rows [0, b) are the primal rows,
// rows [k b, (k + 1) b) tangent k - 1 of the same samples (b = 16 for K = 2 and 3,
// 32 for K = 1; with K = 2 rows 48-63 stay zero). 64 samples with their 3 tangents
// would need 256-row activation tiles, 2 x 256 x 312 x 2 B = 319,488 B at the
// widths of the mlp_raw_tpu SDF chain (hidden 256, skip input 256 + 48): over a
// block's 232,448 B. The forward keeps the primal rows' f32 z of the current layer
// in shared memory for the tangent rows' act'(z): mma_tile64 hands a column tile's
// row tiles to one warp in order, primal rows first.
//
// Cast points (_fwd_kernel :277-321, _bwd_kernel :636-789): t = bf16(u * act'(z))
// with the forward's f32 z and u; a skip layer's tangent input bf16(concat(t, t0) /
// sqrt 2); the last layer's u f32, column c to ty [n, K] (or geo / sdf / grad in the
// split mode of K4j), or all columns rounded to bf16 (ty [K, n, D_out]). The
// backward recomputes with zb = bf16(z), ub = bf16(u) stored and t = bf16(ub *
// act'(zb)).
//
// Bound on an H100: (1 + K) chain-sized products per layer forward, three times that
// backward, against a few hundred bytes per sample: the tensor cores bound both. The
// forward's first design (wmma, weights from L2, 16 samples per tile) is far from it;
// the backward's stacks (about 8 KB per row of a tile at the mlp_raw_tpu widths,
// written once and read by chain_wgrad) put its memory traffic near the tensor-core
// time. PERF.md has the times.

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

__device__ __forceinline__ int tile_kind(int r, int b) { return r / b; }

// The tile's chain input rows into buf [64, lds] and x0 [64, ldx0], zero past
// E.width (to p0), past n and past the K tangents: primal rows from x [n, E.width]
// or the encoding of pos [n, 3] (ENC); tangent rows from tx [K, n, E.width] or the
// encoding's bf16 basis tangents (the unit column of x_k and coordinate k's
// derivative columns, _enc_fwd :199-211). Ends with __syncthreads().
template <bool ENC>
__device__ __forceinline__ void tangent_front(const Enc& E, int p0, int K, int b, const float* pos,
                                              const bf16* x, const bf16* tx, int n, long long s0,
                                              bf16* buf, int lds, bf16* x0, int ldx0) {
  const int F = E.freqs;
  for (int i = threadIdx.x; i < TILE_M * p0; i += NTHREADS) {
    const int r = i / p0, c = i % p0;
    const int kind = tile_kind(r, b);
    const long long row = s0 + r - kind * b;
    float v = 0.f;
    if (kind <= K && row < n && c < E.width) {
      if (!ENC) {
        v = bf(kind == 0 ? x[row * E.width + c] : tx[((kind - 1) * (long long)n + row) * E.width + c]);
      } else if (kind == 0) {
        v = pe_col(pos + row * 3, F, E.scale, c);
      } else if (c < 3) {
        v = c == kind - 1 ? 1.f : 0.f;
      } else if ((c - 3) % (3 * F) / F == kind - 1) {
        v = pe_tangent(pos + row * 3, F, E.scale, c);
      }
    }
    const bf16 h = __float2bfloat16(v);
    buf[r * lds + c] = h;
    x0[r * ldx0 + c] = h;
  }
  __syncthreads();
}

// Hidden layers 0..L-2 of a tangent tile, ping-ponging between buf0 and buf1 (row
// stride lds); x0 [64, ldx0] holds the chain input rows for the skip layers. The
// primal rows' f32 z of the layer go to zf [b, H] for the tangent rows' act'(z).
// Returns the buffer holding the last hidden layer's output.
__device__ __forceinline__ bf16* tangent_hidden_layers(const Chain& C, int K, int b,
                                                       const bf16* __restrict__ wpack,
                                                       const float* __restrict__ bpack,
                                                       bf16* buf0, bf16* buf1, int lds,
                                                       const bf16* x0, int ldx0, float* zf,
                                                       float* stage) {
  const int H = C.hidden;
  const int lane = threadIdx.x & 31;
  bf16* in = buf0;
  bf16* out = buf1;
  for (int l = 0; l < C.n_layers - 1; ++l) {
    const float* B = bpack + C.b_off[l];
    const bool next_skip = (C.skip_mask >> (l + 1)) & 1;
    mma_tile64<false>(in, lds, C.in_dims[l], wpack + C.w_off[l], C.out_dims[l], C.out_dims[l],
                      stage, [&](int r0, int c0, const float* t) {
                        for (int i = lane; i < 256; i += 32) {
                          const int r = r0 + (i >> 4), c = c0 + (i & 15);
                          const int kind = tile_kind(r, b), s = r - kind * b;
                          float v = 0.f;
                          if (kind == 0) {
                            const float z = t[i] + B[c];
                            zf[s * H + c] = z;
                            v = round_bf16(act_f(C.act, z, C.quad_a));
                          } else if (kind <= K) {
                            v = round_bf16(t[i] * act_df(C.act, zf[s * H + c], C.quad_a));
                          }
                          if (next_skip) v = v * SKIP_SCALE;
                          out[r * lds + c] = __float2bfloat16(v);
                        }
                      });
    if (next_skip) {
      for (int i = threadIdx.x; i < TILE_M * C.p0; i += NTHREADS) {
        const int r = i / C.p0, c = i % C.p0;
        out[r * lds + H + c] = __float2bfloat16(bf(x0[r * ldx0 + c]) * SKIP_SCALE);
      }
    }
    __syncthreads();
    bf16* tmp = in;
    in = out;
    out = tmp;
  }
  return in;
}

template <bool ENC>
__global__ void __launch_bounds__(NTHREADS)
chain_tangent_fwd_kernel(const float* __restrict__ pos, const bf16* __restrict__ x,
                         const bf16* __restrict__ tx, int K, int b, Enc E,
                         const bf16* __restrict__ wpack, const float* __restrict__ bpack, int n,
                         Chain C, int lds, int ldx0, TanOut O) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = C.n_layers;
  bf16* buf0 = reinterpret_cast<bf16*>(smem);
  bf16* buf1 = buf0 + TILE_M * lds;
  bf16* x0 = buf1 + TILE_M * lds;                            // [64, ldx0]
  float* zf = reinterpret_cast<float*>(x0 + TILE_M * ldx0);  // [b, H]
  float* stage = zf + b * C.hidden;
  const long long s0 = (long long)blockIdx.x * b;
  tangent_front<ENC>(E, C.p0, K, b, pos, x, tx, n, s0, buf0, lds, x0, ldx0);
  const bf16* h = tangent_hidden_layers(C, K, b, wpack, bpack, buf0, buf1, lds, x0, ldx0, zf,
                                        stage);
  const float* BL = bpack + C.b_off[L - 1];
  const int lane = threadIdx.x & 31;
  mma_tile64<false>(h, lds, C.in_dims[L - 1], wpack + C.w_off[L - 1], C.out_dims[L - 1],
                    C.out_dims[L - 1], stage, [&](int r0, int c0, const float* t) {
                      for (int i = lane; i < 256; i += 32) {
                        const int r = r0 + (i >> 4), c = c0 + (i & 15);
                        const int kind = tile_kind(r, b);
                        const long long row = s0 + r - kind * b;
                        if (row >= n || kind > K) continue;
                        if (kind == 0) {
                          const float z = t[i] + BL[c];
                          if (O.mode == 2) {
                            if (c == 0) O.sdf[row] = z;
                            else if (c <= O.width) O.y[row * O.width + c - 1] = __float2bfloat16(z);
                          } else if (c < O.width) {
                            O.y[row * O.width + c] = __float2bfloat16(z);
                          }
                        } else if (O.mode == 0) {
                          if (c < O.width)
                            O.ty[((kind - 1) * (long long)n + row) * O.width + c] = __float2bfloat16(t[i]);
                        } else if (c == O.channel) {
                          O.tyf[row * K + kind - 1] = t[i];
                        }
                      }
                    });
}

// ------------------------------------------------------------ tangent backward
//
// The backward of the tangent chain (_bwd_kernel :607-792 with n_tangents = K,
// and _enc_bwd :215-239 for K4j) on Hopper: a per-tile pass on wgmma and the
// stacked gW product (chain_wgrad of fused_chain.cu), with K1's layout (k1.cuh):
// the bf16 images of one k1_pack launch streamed through a ring that a producer
// warpgroup feeds, a consumer warpgroup per 64-row tile, one m64 wgmma a layer
// over the primal and tangent rows of b samples (b = 32 for K = 1, else 16).
// The tile's rows are placed so that a sample's rows meet in registers: in the
// accumulator layout the thread of lane l in warp w holds rows 16 w + l / 4 and
// that + 8; with K = 1 those are one sample's primal and tangent rows; with K =
// 2, 3 lanes l < 16 hold a sample's primal row and tangent 2, lane l ^ 16
// tangents 1 and 3 (3 idle with K = 2), so one shuffle exchanges what a row
// needs of its sample's others (tan_kind, tan_sample).
// Per tile: the recompute of the hidden layers (the bias seeds the primal rows
// only; zb = bf16(z) and ub = bf16(u) to a slab; t = bf16(ub act'(zb))); stacks
// hin_l (primal hin = bf16(act(zb)), tangent tin = t); then the reverse sweep
// from the last layer's cotangent rows: gu = gt act'(z) on the tangent rows,
// gz = gh act'(z) + (sum_k gt_k ub_k) act''(z) on the primal rows; stacks gz_l
// (gz and gu); gb as per-CTA column sums of the primal rows' f32 gz; gx and gtx
// bf16 (K1t) or d pos = J_enc^T gx0 + the tangent rows' Hessian terms (K4j),
// summed over a sample's rows through shared memory. gW_l = Hin_l^T G_l over
// all 64 rows of every tile is then chain_wgrad's product. Where the residuals
// live: z and u bf16 and the skip layers' gx0 f32 in per-(CTA, warpgroup)
// device slabs in the accumulator's own order, each thread reading back its own
// words (the next layer's into L2 while the products run); activation images in
// shared memory; the stacks in device scratch.
namespace k1 {

struct TanScratch {
  bf16* hin;         // hin stacks (primal hin and tangent tin rows)
  bf16* gz;          // gz stacks (primal gz and tangent gu rows)
  uint32_t* zslab;   // per slot: (L-1) x 64 x H bf16, z (primal rows) or u (tangent rows)
  float* gx0slab;    // per slot: 64 x P0 f32 (skip chains)
};

// bytes of the stacks, the z/u slabs and the gx0 slabs
static void tan_scratch_sizes(const Geom& G, int tiles, int slots, size_t* s) {
  stack_sizes(G, tiles, s);
  s[2] = align256((size_t)slots * (G.L - 1) * 64 * G.H * 2);
  s[3] = G.skip_mask ? align256((size_t)slots * 64 * G.P0 * 4) : 0;
}

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
        v = bf(kind == 0 ? I.x[row * E.width + c]
                         : I.tx[((kind - 1) * (long long)n + row) * E.width + c]);
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

// A hidden layer's output into the activation images: primal rows bf16(act(z))
// from the f32 accumulators, or (FROM_BF16_Z) bf16(act(zb)), the stack's value;
// tangent rows t = bf16(ub act'(zb)); times 1/sqrt(2), rounded, before a skip
// layer. kind0, kind1: the kinds of the thread's rows r0 and r0 + 8.
template <int N, bool FROM_BF16_Z>
__device__ __forceinline__ void tan_hidden(const float (&acc)[N / 2], bf16* act, bool scale,
                                           int act_kind, float qa, int K, int kind0, int kind1) {
  const int r0 = acc_row(), cq = acc_col();
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 zp = unpack2(primal_word(pack2(acc[4 * j], acc[4 * j + 1]), K));
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a0 = acc[4 * j + 2 * e], a1 = acc[4 * j + 2 * e + 1];
      uint32_t h;
      if ((e ? kind1 : kind0) == 0) {
        h = FROM_BF16_Z ? pack2(act_f(act_kind, zp.x, qa), act_f(act_kind, zp.y, qa))
                        : pack2(act_f(act_kind, a0, qa), act_f(act_kind, a1, qa));
      } else {
        const float2 u = unpack2(pack2(a0, a1));
        h = pack2(u.x * act_df(act_kind, zp.x, qa), u.y * act_df(act_kind, zp.y, qa));
      }
      if (scale) {
        const float2 v = unpack2(h);
        h = pack2(v.x * SKIP_SCALE, v.y * SKIP_SCALE);
      }
      *reinterpret_cast<uint32_t*>(act + act_el(8 * j + cq, r0 + 8 * e)) = h;
    }
  }
}

template <bool WIDE>
__global__ void __launch_bounds__(NTHREADS, 1)
tan_bwd_pass_kernel(const Geom G, const mms::Enc E, const TanIo I, int n,
                    const bf16* __restrict__ wfw, const bf16* __restrict__ wbw,
                    const float* __restrict__ bpk, float* __restrict__ gb, TanScratch S, int nwg,
                    int stages, int sb, int act_bytes) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* csum = reinterpret_cast<float*>(smem + nwg * act_bytes + stages * sb);
  const int L = G.L, H = G.H, P0 = G.P0, K = I.K, b = I.b;
  const bool enc = E.freqs > 0;  // K4j (the encoding in front) or K1t
  const int x0c = x0_col(G);
  const int gb_total = G.gb_off[L - 1] + G.dout_true[L - 1];
  float* rowval = csum + ((gb_total + 3) & ~3);  // per warpgroup [64][4]: K4j's d pos terms
  uint64_t* bars = reinterpret_cast<uint64_t*>(rowval + MAXWG * 256);
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
  const int tiles = (n + b - 1) / b, groups = (tiles + nwg - 1) / nwg;
  const int warp = threadIdx.x >> 5;
  if (warp >= nwg * 4) {  // producer: K1's backward order
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
  bf16* act = reinterpret_cast<bf16*>(smem + wg * act_bytes);
  float* rv = rowval + wg * 256;
  {
    uint4* p = reinterpret_cast<uint4*>(act);
    for (int i = t; i < act_bytes / 16; i += 128) p[i] = make_uint4(0, 0, 0, 0);
  }
  wg_sync(1 + wg);
  const int slot = blockIdx.x * nwg + wg;
  const size_t zwords = (size_t)(H / 4) * 128;
  uint32_t* zs = S.zslab + (size_t)slot * (L - 1) * zwords;
  float* gx0 = S.gx0slab ? S.gx0slab + (size_t)slot * (P0 / 2) * 128 : nullptr;
  const int top_skip = G.skip_mask ? 31 - __clz(G.skip_mask) : -1;
  const int r0 = acc_row(), cq = acc_col();
  // the kinds and tile samples of this thread's two rows
  const int kind0 = tan_kind(r0, K), kind1 = tan_kind(r0 + 8, K);
  const int samp = tan_sample(r0, K);  // both rows' sample
  const float qa = G.quad_a;
  const int act_kind = G.act;
  const bool own_hin = act_kind == ACT_SOFTPLUS_QUAD, has_ddf = act_kind == ACT_SOFTPLUS_QUAD;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int tile = grp * nwg + wg;
    const long long s0 = (long long)tile * b;
    const long long srow = s0 + samp;  // the thread's sample
    const Stacker st{tile < tiles};
    constexpr int nph = WIDE ? 2 : 1;  // pieces of a hidden-width product
    auto hin_at = [&](int l) {
      return S.hin + (size_t)tiles * 64 * G.hs_w[l] + (size_t)tile * 64 * G.din_pad[l];
    };
    auto gz_at = [&](int l) {
      return S.gz + (size_t)tiles * 64 * G.gs_w[l] + (size_t)tile * 64 * gcols(G, l);
    };
    tan_front(G, E, I, act, x0c, s0, n);
    fence_async_smem();
    wg_sync(1 + wg);
    st.store(hin_at(0), act + (x0c >> 6) * 4096, P0);
    // recompute of the hidden layers (primal and tangent rows)
    for (int l = 0; l < L - 1; ++l) {
      const bf16* a = act + (l == 0 ? (x0c >> 6) * 4096 : 0);
      if (l > 0 && !own_hin) st.store(hin_at(l), act, G.din_pad[l]);
      const bool next_skip = (G.skip_mask >> (l + 1)) & 1;
      const bool need_h = !own_hin || l + 1 < L - 1;
      for (int p = 0; p < nph; ++p) {
        int off, np;
        hidden_piece<WIDE>(H, p, off, np);
        bf16* dst = piece_dst<WIDE>(act, act_bytes, p, nph, off);
        uint32_t* zl = zs + l * zwords + (off >> 2) * 128;
        with_n64(np, [&](auto NC) {
          constexpr int N = decltype(NC)::value;
          float acc[N / 2];
          mma_piece<N>(acc, a, G.din_pad[l] >> 6, R, wg, bpk + G.b_off[l] + off,
                       kind0 == 0 ? 1 : 0);
#pragma unroll
          for (int i = 0; i < N / 4; ++i) zl[i * 128 + t] = pack2(acc[2 * i], acc[2 * i + 1]);
          st.drain(wg);  // the stack stores have read act
          if (l == 0 && G.skip_mask && p + 1 == nph) scale_region(act, H, P0);
          if (own_hin) {
            tan_hidden<N, true>(acc, dst, next_skip, act_kind, qa, K, kind0, kind1);
            fence_async_smem();
            wg_sync(1 + wg);
            st.store(hin_at(l + 1) + off * 64, dst, p + 1 < nph ? N : G.din_pad[l + 1] - off);
            if (need_h) st.drain(wg);
          }
          if (need_h) {
            tan_hidden<N, false>(acc, dst, next_skip, act_kind, qa, K, kind0, kind1);
            if (p + 1 == nph) {
              side_back<WIDE>(act, act_bytes, nph, wg);
              fence_async_smem();
              wg_sync(1 + wg);
            }
          }
        });
      }
    }
    if (!own_hin) st.store(hin_at(L - 1), act, G.din_pad[L - 1]);
    st.drain(wg);
    // the last layer's cotangent rows, rounded to bf16; gb_{L-1} sums the primal rows' f32
    const int dl = G.dout_true[L - 1], gl = gcols(G, L - 1);
    for (int i = t; i < 64 * gl; i += 128) {
      const int r = i / gl, c = i % gl;
      const int k = tan_kind(r, K);
      const long long row = s0 + tan_sample(r, K);
      const float g = k <= K && row < n ? tan_cotangent(I, n, k, row, c) : 0.f;
      act[act_el(c, r)] = __float2bfloat16(g);
    }
    fence_async_smem();
    wg_sync(1 + wg);
    st.store(gz_at(L - 1), act, gl);
    for (int c = t; c < dl; c += 128) {
      float sum = 0.f;
      for (int r = 0; r < b && s0 + r < n; ++r) sum += tan_cotangent(I, n, 0, s0 + r, c);
      atomicAdd(&csum[G.gb_off[L - 1] + c], sum);
    }
    float dp[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};  // K4j's d pos terms of the two rows
    // reverse sweep: gh = G W_l^T over the primal and tangent rows
    for (int l = L - 1; l >= 0; --l) {
      const int kcs = gcols(G, l) >> 6, npc = bwd_n_pieces(G, l);
      const bool skip = (G.skip_mask >> l) & 1;
      // the z / u slab that the h piece's epilogue reads, into L2 while the products run
      if (l > 0 && t == 0) bulk_prefetch_l2(zs + (l - 1) * zwords, (uint32_t)zwords * 4);
      for (int p = 0; p < npc; ++p) {
        int off, np;
        bool x0part;
        bwd_piece(G, l, p, off, np, x0part);
        with_n64(np, [&](auto NC) {
          constexpr int N = decltype(NC)::value;
          float acc[N / 2];
          mma_piece<N>(acc, act, kcs, R, wg, nullptr);
          if (l == 0) {  // gx (primal rows) and gtx (tangent rows) = gh_0 + gx0
            bf16* out[2];  // the thread's two output rows (K1t), or null
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int kind = rr ? kind1 : kind0;
              out[rr] = enc || kind > K || srow >= n ? nullptr
                        : kind == 0 ? I.gx + srow * E.width
                                    : I.gtx + ((kind - 1) * (long long)n + srow) * E.width;
            }
#pragma unroll
            for (int j = 0; j < N / 8; ++j) {
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int i = 4 * j + k, c = off + 8 * j + cq + (k & 1), rr = k >> 1;
                const int kind = rr ? kind1 : kind0;
                const float gh = acc[i] + (gx0 ? gx0[((off >> 1) + i) * 128 + t] : 0.f);
                if (c >= E.width) continue;
                if (!enc) {
                  if (out[rr]) out[rr][c] = __float2bfloat16(gh);
                  continue;
                }
                if (kind > K || srow >= n) continue;
                if (c < 3) {  // J_enc^T on the primal rows; the Hessian has no x columns
                  if (kind == 0) add3(dp[rr], c, gh);
                  continue;
                }
                const int F = E.freqs;
                const bool is_sin = c < 3 + 3 * F;
                const int kk = is_sin ? c - 3 : c - 3 - 3 * F, d = kk / F;
                if (kind != 0 && d != kind - 1) continue;
                const float s = E.scale[kk % F], arg = I.pos[srow * 3 + d] * s;
                const float sn = sinf(arg), cs = cosf(arg);
                if (kind == 0)
                  add3(dp[rr], d, is_sin ? gh * (cs * s) : gh * (-sn * s));
                else
                  dp[rr][0] += is_sin ? gh * (-sn * s * s) : gh * (-cs * s * s);
              }
            }
          } else if (x0part) {  // a skip layer's x0 columns: gx0 += gh / sqrt 2
            slab_accumulate<N>(gx0, off - H, acc, SKIP_SCALE, l == top_skip);
          } else {  // gz (primal rows) and gu (tangent rows) of layer l - 1 (the first of
                    // two pieces to the side images)
            const int hoff = WIDE ? off : 0;  // the h part's one piece starts at 0
            const uint32_t* zl = zs + (l - 1) * zwords + (hoff >> 2) * 128;
            const float sc = skip ? SKIP_SCALE : 1.f;
            bf16* dst = piece_dst<WIDE>(act, act_bytes, p, npc, hoff);
            st.drain(wg);  // the stack store of G has read act
            float* cs = csum + G.gb_off[l - 1] + hoff;
#pragma unroll
            for (int j = 0; j < N / 8; ++j) {
              const uint32_t w0 = zl[(2 * j) * 128 + t], w1 = zl[(2 * j + 1) * 128 + t];
              const float2 zp = unpack2(primal_word(w0, K));
              const float g00 = acc[4 * j] * sc, g01 = acc[4 * j + 1] * sc;
              const float g10 = acc[4 * j + 2] * sc, g11 = acc[4 * j + 3] * sc;
              const float d0 = act_df(act_kind, zp.x, qa), d1 = act_df(act_kind, zp.y, qa);
              float o00 = g00 * d0, o01 = g01 * d1;  // row r0
              const float o10 = g10 * d0, o11 = g11 * d1;  // row r0 + 8, a tangent row
              if (has_ddf) {  // the primal rows' gz += (sum_k gt_k ub_k) act''(z)
                const float2 u0 = unpack2(w0), u1 = unpack2(w1);
                float t0 = g10 * u1.x, t1 = g11 * u1.y;  // row r0 + 8's term
                if (kind0 != 0) {  // row r0 is a tangent row too
                  t0 += g00 * u0.x;
                  t1 += g01 * u0.y;
                }
                if (K != 1) {  // the sample's other two tangent rows, on lane ^ 16
                  t0 += __shfl_xor_sync(0xffffffffu, t0, 16);
                  t1 += __shfl_xor_sync(0xffffffffu, t1, 16);
                }
                if (kind0 == 0) {
                  o00 += t0 * act_ddf(act_kind, zp.x, qa);
                  o01 += t1 * act_ddf(act_kind, zp.y, qa);
                }
              }
              *reinterpret_cast<uint32_t*>(dst + act_el(8 * j + cq, r0)) = pack2(o00, o01);
              *reinterpret_cast<uint32_t*>(dst + act_el(8 * j + cq, r0 + 8)) = pack2(o10, o11);
              // gb_{l-1}: the primal rows' f32 gz
              float s0c = kind0 == 0 ? o00 : 0.f, s1c = kind0 == 0 ? o01 : 0.f;
#pragma unroll
              for (int m = 4; m < 32; m <<= 1) {
                s0c += __shfl_xor_sync(0xffffffffu, s0c, m);
                s1c += __shfl_xor_sync(0xffffffffu, s1c, m);
              }
              if (lane < 4) {
                atomicAdd(&cs[8 * j + cq], s0c);
                atomicAdd(&cs[8 * j + cq + 1], s1c);
              }
            }
          }
        });
      }
      if (l > 0) side_back<WIDE>(act, act_bytes, nph, wg);
      fence_async_smem();
      wg_sync(1 + wg);
      if (l > 0) st.store(gz_at(l - 1), act, H);
    }
    if (enc) {  // d pos = J_enc^T gx0 (primal row) + the Hessian terms of the 3 tangent rows
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float v = dp[rr][k];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if ((lane & 3) == 0) rv[(r0 + 8 * rr) * 4 + k] = v;
        }
      }
      wg_sync(1 + wg);
      if (t < b && s0 + t < n) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
          I.d_pos[(s0 + t) * 3 + k] = rv[tan_row(t, 0, K) * 4 + k] + rv[tan_row(t, k + 1, K) * 4];
      }
    }
    st.drain(wg);  // before the next tile's rows land
  }
  if ((threadIdx.x & 127) == 0) bulk_wait_all();
  bar_sync(SUM_BAR, nwg * 128);
  for (int i = threadIdx.x; i < gb_total; i += nwg * 128)
    if (csum[i] != 0.f) atomicAdd(&gb[i], csum[i]);
}

static int tan_plan(const Geom& G, int tiles, Launch* P) {
  const void* kernel = is_wide(G) ? (const void*)tan_bwd_pass_kernel<true>
                                  : (const void*)tan_bwd_pass_kernel<false>;
  if (plan_chain(G, tiles, true, (size_t)MAXWG * 256 * 4, P)) return ERR_SMEM;
  if (allow_smem(is_wide(G), kernel) != cudaSuccess) return -1;
  if (persistent(kernel, P, (tiles + P->nwg - 1) / P->nwg) != cudaSuccess) return -1;
  return 0;
}

}  // namespace k1

// Checks a tangent chain and fills C, E (no encoding: freqs 0, or pe_freqs with its
// scales), the tile's samples b and the row strides; returns nonzero on a chain the
// kernels do not take.
static int tangent_setup(Chain& C, Enc& E, int& b, int& lds, int& ldx0, int K, int n_layers,
                         const int* in_dims, const int* out_dims, int skip_mask, int hidden,
                         int p0, int act, float quad_a, int pe_freqs, const float* pe_scale,
                         int width) {
  if (fill_chain(C, n_layers, in_dims, out_dims, skip_mask, hidden, p0, act, quad_a)) return -1;
  if (K < 1 || K > 3 || n_layers < 2 || (skip_mask & 1) || pe_freqs < 0 || pe_freqs > MAXPE)
    return -1;
  if (width < 1 || width > p0 || in_dims[0] != p0) return -1;
  int w = p0;
  for (int l = 0; l < n_layers; ++l) {
    const bool sk = (skip_mask >> l) & 1;
    if (l > 0 && in_dims[l] != hidden + (sk ? p0 : 0)) return -1;
    if (l < n_layers - 1 && out_dims[l] != hidden) return -1;
    w = w > in_dims[l] ? w : in_dims[l];
    w = w > out_dims[l] ? w : out_dims[l];
  }
  E.freqs = pe_freqs;
  for (int i = 0; i < pe_freqs; ++i) E.scale[i] = pe_scale[i];
  E.width = width;
  b = K == 1 ? 32 : 16;
  lds = w + PAD;
  ldx0 = p0 + PAD;
  return 0;
}

template <bool ENC>
static int launch_tangent_fwd(const float* pos, const bf16* x, const bf16* tx, int K, int n,
                              const void* wpack, const void* bpack, const Chain& C, const Enc& E,
                              int b, int lds, int ldx0, const TanOut& O, void* stream) {
  const size_t smem = 2 * (size_t)TILE_M * lds * sizeof(bf16) + (size_t)TILE_M * ldx0 * sizeof(bf16) +
                      (size_t)b * C.hidden * sizeof(float) + NWARPS * 256 * sizeof(float);
  if (smem > MAX_SMEM) return ERR_SMEM;
  cudaError_t err = cudaFuncSetAttribute(chain_tangent_fwd_kernel<ENC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + b - 1) / b;
  chain_tangent_fwd_kernel<ENC><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      pos, x, tx, K, b, E, (const bf16*)wpack, (const float*)bpack, n, C, lds, ldx0, O);
  return (int)cudaGetLastError();
}

// K1t's forward: x [n, d_in] and tx [K, n, d_in] bf16 in; y [n, d_out] bf16 and ty
// ([n, K] f32 for channel >= 0, else [K, n, d_out] bf16) out.
extern "C" int mms_chain_tangent_fwd(const void* x, const void* tx, int d_in, int K,
                                     const void* wpack, const void* bpack, int n, int n_layers,
                                     const int* in_dims, const int* out_dims, int skip_mask,
                                     int hidden, int p0, int act, float quad_a, int channel,
                                     void* y, int d_out, void* ty, void* stream) {
  Chain C;
  Enc E;
  int b, lds, ldx0;
  if (tangent_setup(C, E, b, lds, ldx0, K, n_layers, in_dims, out_dims, skip_mask, hidden, p0, act,
                    quad_a, 0, nullptr, d_in) ||
      d_out > out_dims[n_layers - 1] || channel >= d_out)
    return -1;
  TanOut O{channel < 0 ? 0 : 1, channel, d_out, (bf16*)y, (bf16*)ty, (float*)ty, nullptr};
  return launch_tangent_fwd<false>(nullptr, (const bf16*)x, (const bf16*)tx, K, n, wpack, bpack, C,
                                   E, b, lds, ldx0, O, stream);
}

// K4j's forward: positions [n, 3] f32 in; sdf [n] f32, geo [n, geo_width] bf16 and
// grad [n, 3] f32 out. The leading arguments are sdf_chain.cu's (K4's).
extern "C" int mms_sdf_chain_jvp_fwd(const void* pos, int n, const void* wpack, const void* bpack,
                                     int n_layers, const int* in_dims, const int* out_dims,
                                     int skip_mask, int hidden, int p0, int act, float quad_a,
                                     int pe_freqs, const float* pe_scale, void* sdf, void* geo,
                                     int geo_width, void* grad, void* stream) {
  Chain C;
  Enc E;
  int b, lds, ldx0;
  if (pe_freqs < 1 ||
      tangent_setup(C, E, b, lds, ldx0, 3, n_layers, in_dims, out_dims, skip_mask, hidden, p0, act,
                    quad_a, pe_freqs, pe_scale, 3 + 6 * pe_freqs) ||
      geo_width >= out_dims[n_layers - 1])
    return -1;
  TanOut O{2, 0, geo_width, (bf16*)geo, nullptr, (float*)grad, (float*)sdf};
  return launch_tangent_fwd<true>((const float*)pos, nullptr, nullptr, 3, n, wpack, bpack, C, E, b,
                                  lds, ldx0, O, stream);
}

// ------------------------------------------------------------- backward entry points
//
// G: the chain's layout (fused_mlp.py chain_layout); wfw, wbw, bpk: what mms_k1_pack
// wrote for it. The pass writes gx / gtx (K1t) or d_pos (K4j), accumulates into gb
// and leaves the stacks of (n + b - 1) / b row tiles (b = 32 for K = 1, else 16) at
// the start of scratch for mms_k1_wgrad.

static int tangent_samples(int K) { return K == 1 ? 32 : 16; }

static int tan_bwd_launch(const k1::Geom& G, const Enc& E, const k1::TanIo& I, int n,
                          const void* wfw, const void* wbw, const void* bpk, void* gb,
                          void* scratch, void* stream) {
  if (!k1::geom_ok(G) || n < 1 || I.K < 1 || I.K > 3 || E.width != G.d_in) return -1;
  const int tiles = (n + I.b - 1) / I.b;
  k1::Launch P;
  const int st = k1::tan_plan(G, tiles, &P);
  if (st) return st;
  size_t s[4];
  k1::tan_scratch_sizes(G, tiles, P.grid * P.nwg, s);
  uint8_t* p = (uint8_t*)scratch;
  const k1::TanScratch S{(bf16*)p, (bf16*)(p + s[0]), (uint32_t*)(p + s[0] + s[1]),
                         s[3] ? (float*)(p + s[0] + s[1] + s[2]) : nullptr};
  if (k1::is_wide(G))
    k1::tan_bwd_pass_kernel<true><<<P.grid, P.threads, P.smem, (cudaStream_t)stream>>>(
        G, E, I, n, (const bf16*)wfw, (const bf16*)wbw, (const float*)bpk, (float*)gb, S, P.nwg,
        P.stages, P.sb, P.act_bytes);
  else
    k1::tan_bwd_pass_kernel<false><<<P.grid, P.threads, P.smem, (cudaStream_t)stream>>>(
        G, E, I, n, (const bf16*)wfw, (const bf16*)wbw, (const float*)bpk, (float*)gb, S, P.nwg,
        P.stages, P.sb, P.act_bytes);
  return (int)cudaGetLastError();
}

// Bytes of the backward's device scratch (stacks and per-CTA slabs) for n samples
// with K tangents.
extern "C" long long mms_tangent_bwd_bytes(const k1::Geom* G, int n, int K) {
  if (!k1::geom_ok(*G) || n < 1 || K < 1 || K > 3) return -1;
  const int tiles = (n + tangent_samples(K) - 1) / tangent_samples(K);
  k1::Launch P;
  const int st = k1::tan_plan(*G, tiles, &P);
  if (st) return st;
  size_t s[4];
  k1::tan_scratch_sizes(*G, tiles, P.grid * P.nwg, s);
  return (long long)(s[0] + s[1] + s[2] + s[3]);
}

// K1t's backward pass: x [n, d_in], tx [K, n, d_in], gy [n, d_out] bf16 and gty
// ([n, K] f32 for channel >= 0, else [K, n, d_out] bf16) in; gx [n, d_in] and gtx
// [K, n, d_in] bf16 out.
extern "C" int mms_chain_tangent_bwd(const k1::Geom* G, const void* x, const void* tx, int K,
                                     int n, const void* gy, const void* gty, int channel,
                                     const void* wfw, const void* wbw, const void* bpk, void* gx,
                                     void* gtx, void* gb, void* scratch, void* stream) {
  const int d_out = G->dout_true[G->L - 1];
  if (channel >= d_out) return -1;
  Enc E;
  E.freqs = 0;
  E.width = G->d_in;
  const k1::TanIo I{nullptr, (const bf16*)x, (const bf16*)tx, (const bf16*)gy, (const bf16*)gty,
                    (const float*)gty, nullptr, (bf16*)gx, (bf16*)gtx, nullptr,
                    channel < 0 ? 0 : 1, channel, d_out, K, tangent_samples(K)};
  return tan_bwd_launch(*G, E, I, n, wfw, wbw, bpk, gb, scratch, stream);
}

// K4j's backward pass: positions [n, 3] f32 and the cotangents gsdf [n] f32, ggeo
// [n, geo_width] bf16 and g3 [n, 3] f32 in; d_pos [n, 3] f32 out.
extern "C" int mms_sdf_chain_jvp_bwd(const k1::Geom* G, const void* pos, int n, int pe_freqs,
                                     const float* pe_scale, const void* gsdf, const void* ggeo,
                                     int geo_width, const void* g3, const void* wfw,
                                     const void* wbw, const void* bpk, void* d_pos, void* gb,
                                     void* scratch, void* stream) {
  if (pe_freqs < 1 || pe_freqs > MAXPE || geo_width >= G->dout_true[G->L - 1]) return -1;
  Enc E;
  E.freqs = pe_freqs;
  for (int i = 0; i < pe_freqs; ++i) E.scale[i] = pe_scale[i];
  E.width = 3 + 6 * pe_freqs;
  const k1::TanIo I{(const float*)pos, nullptr, nullptr, (const bf16*)ggeo, nullptr,
                    (const float*)g3, (const float*)gsdf, nullptr, nullptr, (float*)d_pos,
                    2, 0, geo_width, 3, tangent_samples(3)};
  return tan_bwd_launch(*G, E, I, n, wfw, wbw, bpk, gb, scratch, stream);
}
