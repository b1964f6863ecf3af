// The fused dense chain with forward tangents for Hopper: K1t and K4j (K1 without
// tangents is csrc/fused_chain.cu). A tile's chain runs out of shared memory, so
// inter-layer activations never touch device memory.
#include "enc.cuh"

using namespace mms;

// Scratch bf16 elements per CTA of the tangent backwards (the tile's z and u stack
// and its x0 slab).
extern "C" long long mms_chain_tangent_bwd_slab(int n_layers, int hidden, int p0) {
  return (long long)(n_layers - 1) * TILE_M * hidden + (long long)TILE_M * p0;
}

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
// backward, against a few hundred bytes per sample: the tensor cores bound both. This
// first design (wmma, weights from L2, 16 samples per tile, one f32 atomic per gW
// element per tile) is far from it; PERF.md has its times.

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
// stride lds); x0 [64, ldx0] holds the chain input rows for the skip layers. Forward
// (stack == nullptr): the primal rows' f32 z of the layer go to zf [b, H] for the
// tangent rows' act'(z). Backward recompute: the bf16 z (primal rows) and u (tangent
// rows) of layer l go to stack + l * 64 * H, and the tangent rows take act'(zb) and
// ub. Returns the buffer holding the last hidden layer's output.
__device__ __forceinline__ bf16* tangent_hidden_layers(const Chain& C, int K, int b,
                                                       const bf16* __restrict__ wpack,
                                                       const float* __restrict__ bpack,
                                                       bf16* buf0, bf16* buf1, int lds,
                                                       const bf16* x0, int ldx0, bf16* stack,
                                                       float* zf, float* stage) {
  const int H = C.hidden;
  const int lane = threadIdx.x & 31;
  bf16* in = buf0;
  bf16* out = buf1;
  for (int l = 0; l < C.n_layers - 1; ++l) {
    const float* B = bpack + C.b_off[l];
    const bool next_skip = (C.skip_mask >> (l + 1)) & 1;
    bf16* st = stack ? stack + (long long)l * TILE_M * H : nullptr;
    mma_tile64<false>(in, lds, C.in_dims[l], wpack + C.w_off[l], C.out_dims[l], C.out_dims[l],
                      stage, [&](int r0, int c0, const float* t) {
                        for (int i = lane; i < 256; i += 32) {
                          const int r = r0 + (i >> 4), c = c0 + (i & 15);
                          const int kind = tile_kind(r, b), s = r - kind * b;
                          float v = 0.f;
                          if (kind == 0) {
                            const float z = t[i] + B[c];
                            if (st) st[r * H + c] = __float2bfloat16(z);
                            else zf[s * H + c] = z;
                            v = round_bf16(act_f(C.act, z, C.quad_a));
                          } else if (kind <= K) {
                            float u = t[i], z;
                            if (st) {
                              const bf16 ub = __float2bfloat16(u);
                              st[r * H + c] = ub;
                              u = bf(ub);
                              z = bf(st[s * H + c]);
                            } else {
                              z = zf[s * H + c];
                            }
                            v = round_bf16(u * act_df(C.act, z, C.quad_a));
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
  const bf16* h = tangent_hidden_layers(C, K, b, wpack, bpack, buf0, buf1, lds, x0, ldx0, nullptr,
                                        zf, stage);
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

// Backward of the tangent chain (_bwd_kernel :607-792), reverse over the tangent
// chain, persistent: each CTA walks tiles and owns a slab of device scratch holding
// the tile's stack [L-1, 64, H] (z of the primal rows, u of the tangent rows, bf16)
// and its chain input rows x0 [64, p0]. Per tile: recompute; the last layer's
// cotangent rows (primal: gy, or [gsdf, ggeo] in the split mode; tangent k: column c
// of gty or g3, or gty's row in the full mode), rounded to bf16 into G, gb_{L-1} += the
// f32 primal cotangent; then per layer, top down: gW_l += Hin^T G over all 64 rows
// (hin^T gz + sum_k tin_k^T gu_k in one product), and G W^T, whose epilogue runs the
// row tiles last first (REV), so the tangent rows give gu = gt act'(z) and leave
// sum_k gt_k u_k in S [b, H] before the primal rows take gz = gh act'(z) + S act''(z)
// and their column sums into gb. A skip layer's x0 part and layer 0's product
// accumulate in sGx [64, p0] f32: gx0 (primal rows) and gtx0_k (tangent rows), out
// as gx and gtx bf16, or (ENC) as d pos = J_enc^T gx0 + the Hessian term of gtx0_k
// (_enc_bwd :215-239).
struct TanCot {
  int mode, channel, width;  // as TanOut; width: of gy (mode 0, 1) or ggeo (mode 2)
  const bf16* gy;            // [n, width]: gy (mode 0, 1) or ggeo (mode 2)
  const bf16* gty;           // mode 0: [K, n, width]
  const float* gtyf;         // mode 1: [n, K]; mode 2: g3 [n, K]
  const float* gsdf;         // mode 2: [n]
};

// the last layer's f32 cotangent at (kind, row, c): gh for kind 0, gt_{kind-1} else
__device__ __forceinline__ float last_cotangent(const TanCot& G, int K, int n, int kind,
                                                long long row, int c) {
  if (kind == 0) {
    if (G.mode == 2) {
      if (c == 0) return G.gsdf[row];
      return c - 1 < G.width ? bf(G.gy[row * G.width + c - 1]) : 0.f;
    }
    return c < G.width ? bf(G.gy[row * G.width + c]) : 0.f;
  }
  if (G.mode == 0)
    return c < G.width ? bf(G.gty[((kind - 1) * (long long)n + row) * G.width + c]) : 0.f;
  return c == G.channel ? G.gtyf[row * K + kind - 1] : 0.f;
}

template <bool ENC>
__global__ void __launch_bounds__(NTHREADS)
chain_tangent_bwd_kernel(const float* __restrict__ pos, const bf16* __restrict__ x,
                         const bf16* __restrict__ tx, int K, int b, Enc E,
                         const bf16* __restrict__ wpack, const float* __restrict__ bpack, int n,
                         Chain C, int lds, TanCot Gc, bf16* __restrict__ gx,
                         bf16* __restrict__ gtx, float* __restrict__ d_pos,
                         float* __restrict__ gw, float* __restrict__ gb, bf16* scratch) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = C.n_layers, H = C.hidden, p0 = C.p0;
  bf16* buf0 = reinterpret_cast<bf16*>(smem);
  bf16* buf1 = buf0 + TILE_M * lds;
  float* sGx = reinterpret_cast<float*>(buf1 + TILE_M * lds);  // [64, p0]
  float* S = sGx + TILE_M * p0;                                // [b, H]
  float* stage = S + b * H;
  bf16* stack = scratch + (long long)blockIdx.x * ((L - 1) * TILE_M * H + TILE_M * p0);
  bf16* x0 = stack + (long long)(L - 1) * TILE_M * H;  // [64, p0]
  const int lane = threadIdx.x & 31;
  const int dl = C.out_dims[L - 1];
  const int n_tiles = (n + b - 1) / b;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long s0 = (long long)tile * b;
    tangent_front<ENC>(E, p0, K, b, pos, x, tx, n, s0, buf0, lds, x0, p0);
    for (int i = threadIdx.x; i < TILE_M * p0; i += NTHREADS) sGx[i] = 0.f;
    tangent_hidden_layers(C, K, b, wpack, bpack, buf0, buf1, lds, x0, p0, stack, nullptr, stage);

    bf16* G = buf0;
    bf16* Hb = buf1;
    for (int i = threadIdx.x; i < TILE_M * dl; i += NTHREADS) {
      const int r = i / dl, c = i % dl;
      const int kind = tile_kind(r, b);
      const long long row = s0 + r - kind * b;
      const float g = kind <= K && row < n ? last_cotangent(Gc, K, n, kind, row, c) : 0.f;
      G[r * lds + c] = __float2bfloat16(g);
    }
    for (int c = threadIdx.x; c < dl; c += NTHREADS) {
      float sum = 0.f;
      for (int r = 0; r < b && s0 + r < n; ++r) sum += last_cotangent(Gc, K, n, 0, s0 + r, c);
      if (sum != 0.f) atomicAdd(gb + C.b_off[L - 1] + c, sum);
    }

    for (int l = L - 1; l >= 0; --l) {
      const bool sk = (C.skip_mask >> l) & 1;
      const int din = C.in_dims[l], dout = C.out_dims[l];
      const int hw = sk ? din - p0 : din;  // width of the h part of the layer input
      // Hin: hin = bf16(act(zb)) on the primal rows, tin = bf16(ub * act'(zb)) on the
      // tangent rows, and a skip layer's x0 part; layer 0's is x0
      const bf16* hin = x0;
      int ldh = p0;
      if (l > 0) {
        const bf16* zp = stack + (long long)(l - 1) * TILE_M * H;
        for (int i = threadIdx.x; i < TILE_M * H; i += NTHREADS) {
          const int r = i / H, c = i % H;
          const int kind = tile_kind(r, b), s = r - kind * b;
          float v = 0.f;
          if (kind == 0) v = round_bf16(act_f(C.act, bf(zp[r * H + c]), C.quad_a));
          else if (kind <= K) v = round_bf16(bf(zp[r * H + c]) * act_df(C.act, bf(zp[s * H + c]), C.quad_a));
          if (sk) v = v * SKIP_SCALE;
          Hb[r * lds + c] = __float2bfloat16(v);
        }
        if (sk) {
          for (int i = threadIdx.x; i < TILE_M * p0; i += NTHREADS) {
            const int r = i / p0, c = i % p0;
            Hb[r * lds + H + c] = __float2bfloat16(bf(x0[r * p0 + c]) * SKIP_SCALE);
          }
        }
        hin = Hb;
        ldh = lds;
      }
      __syncthreads();
      mma_atb64_atomic(hin, ldh, din, G, lds, dout, gw + C.w_off[l], dout, stage);
      __syncthreads();
      if (l > 0) {
        const bf16* zp = stack + (long long)(l - 1) * TILE_M * H;
        float* gbl = gb + C.b_off[l - 1];
        float colacc = 0.f;
        mma_tile64<true, true>(G, lds, dout, wpack + C.w_off[l], dout, din, stage,
                               [&](int r0, int c0, const float* t) {
                                 float part = 0.f;
                                 for (int i = lane; i < 256; i += 32) {
                                   const int r = r0 + (i >> 4), c = c0 + (i & 15);
                                   const int kind = tile_kind(r, b), s = r - kind * b;
                                   if (c >= hw) {
                                     sGx[r * p0 + c - hw] += t[i] * SKIP_SCALE;
                                     continue;
                                   }
                                   const float g = sk ? t[i] * SKIP_SCALE : t[i];
                                   const float z = bf(zp[s * H + c]);
                                   float out = 0.f;
                                   if (kind == 0) {
                                     out = g * act_df(C.act, z, C.quad_a) +
                                           S[s * H + c] * act_ddf(C.act, z, C.quad_a);
                                     part += out;
                                   } else if (kind <= K) {
                                     const float term = g * bf(zp[r * H + c]);
                                     S[s * H + c] = kind == K ? term : S[s * H + c] + term;
                                     out = g * act_df(C.act, z, C.quad_a);
                                   }
                                   Hb[r * lds + c] = __float2bfloat16(out);
                                 }
                                 // gb_{l-1}: the primal rows' f32 gz, their row tiles last
                                 part += __shfl_xor_sync(0xffffffffu, part, 16);
                                 colacc += part;
                                 if (r0 == 0) {
                                   if (lane < 16 && c0 < hw && colacc != 0.f)
                                     atomicAdd(gbl + c0 + lane, colacc);
                                   colacc = 0.f;
                                 }
                               });
      } else {
        mma_tile64<true>(G, lds, dout, wpack + C.w_off[0], dout, din, stage,
                         [&](int r0, int c0, const float* t) {
                           for (int i = lane; i < 256; i += 32)
                             sGx[(r0 + (i >> 4)) * p0 + c0 + (i & 15)] += t[i];
                         });
      }
      __syncthreads();
      bf16* tmp = G;
      G = Hb;
      Hb = tmp;
    }

    if (ENC) {
      if (threadIdx.x < b && s0 + threadIdx.x < n) {
        const int s = threadIdx.x;
        const long long row = s0 + s;
        const float* p = pos + row * 3;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          d_pos[row * 3 + k] = pe_jt(sGx + s * p0, p, E.freqs, E.scale, k) +
                               pe_hess(sGx + ((k + 1) * b + s) * p0, p, E.freqs, E.scale, k);
      }
    } else {
      for (int i = threadIdx.x; i < TILE_M * E.width; i += NTHREADS) {
        const int r = i / E.width, c = i % E.width;
        const int kind = tile_kind(r, b);
        const long long row = s0 + r - kind * b;
        if (kind > K || row >= n) continue;
        const bf16 v = __float2bfloat16(sGx[r * p0 + c]);
        if (kind == 0) gx[row * E.width + c] = v;
        else gtx[((kind - 1) * (long long)n + row) * E.width + c] = v;
      }
    }
    __syncthreads();
  }
}

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

template <bool ENC>
static int launch_tangent_bwd(const float* pos, const bf16* x, const bf16* tx, int K, int n,
                              const void* wpack, const void* bpack, const Chain& C, const Enc& E,
                              int b, int lds, const TanCot& G, bf16* gx, bf16* gtx, float* d_pos,
                              void* gw, void* gb, void* scratch, int max_ctas, void* stream) {
  const size_t smem = 2 * (size_t)TILE_M * lds * sizeof(bf16) +
                      (size_t)TILE_M * C.p0 * sizeof(float) + (size_t)b * C.hidden * sizeof(float) +
                      NWARPS * 256 * sizeof(float);
  if (max_ctas < 1) return -1;
  if (smem > MAX_SMEM) return ERR_SMEM;
  cudaError_t err = cudaFuncSetAttribute(chain_tangent_bwd_kernel<ENC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int grid;
  // persistent_grid counts 64-sample tiles; a tangent tile holds b samples
  err = persistent_grid((const void*)chain_tangent_bwd_kernel<ENC>, smem, n * (TILE_M / b),
                        max_ctas, &grid);
  if (err != cudaSuccess) return (int)err;
  chain_tangent_bwd_kernel<ENC><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      pos, x, tx, K, b, E, (const bf16*)wpack, (const float*)bpack, n, C, lds, G, gx, gtx, d_pos,
      (float*)gw, (float*)gb, (bf16*)scratch);
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

// K1t's backward: x, tx, gy [n, d_out] bf16 and gty ([n, K] f32 for channel >= 0, else
// [K, n, d_out] bf16) in; gx [n, d_in] and gtx [K, n, d_in] bf16 and the packed gw, gb
// (accumulated) out.
extern "C" int mms_chain_tangent_bwd(const void* x, const void* tx, int d_in, int K,
                                     const void* gy, const void* gty, int channel,
                                     const void* wpack, const void* bpack, void* gx, void* gtx,
                                     void* gw, void* gb, int d_out, int n, int n_layers,
                                     const int* in_dims, const int* out_dims, int skip_mask,
                                     int hidden, int p0, int act, float quad_a, void* scratch,
                                     int max_ctas, void* stream) {
  Chain C;
  Enc E;
  int b, lds, ldx0;
  if (tangent_setup(C, E, b, lds, ldx0, K, n_layers, in_dims, out_dims, skip_mask, hidden, p0, act,
                    quad_a, 0, nullptr, d_in) ||
      d_out > out_dims[n_layers - 1] || channel >= d_out)
    return -1;
  TanCot G{channel < 0 ? 0 : 1, channel, d_out, (const bf16*)gy, (const bf16*)gty,
           (const float*)gty, nullptr};
  return launch_tangent_bwd<false>(nullptr, (const bf16*)x, (const bf16*)tx, K, n, wpack, bpack, C,
                                   E, b, lds, G, (bf16*)gx, (bf16*)gtx, nullptr, gw, gb, scratch,
                                   max_ctas, stream);
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

// K4j's backward: the cotangents gsdf [n] f32, ggeo [n, geo_width] bf16 and g3 [n, 3]
// f32 in; d_pos [n, 3] f32 and the packed gw, gb (accumulated) out.
extern "C" int mms_sdf_chain_jvp_bwd(const void* pos, int n, const void* wpack, const void* bpack,
                                     int n_layers, const int* in_dims, const int* out_dims,
                                     int skip_mask, int hidden, int p0, int act, float quad_a,
                                     int pe_freqs, const float* pe_scale, const void* gsdf,
                                     const void* ggeo, int geo_width, const void* g3, void* d_pos,
                                     void* gw, void* gb, void* scratch, int max_ctas,
                                     void* stream) {
  Chain C;
  Enc E;
  int b, lds, ldx0;
  if (pe_freqs < 1 ||
      tangent_setup(C, E, b, lds, ldx0, 3, n_layers, in_dims, out_dims, skip_mask, hidden, p0, act,
                    quad_a, pe_freqs, pe_scale, 3 + 6 * pe_freqs) ||
      geo_width >= out_dims[n_layers - 1])
    return -1;
  TanCot G{2, 0, geo_width, (const bf16*)ggeo, nullptr, (const float*)g3, (const float*)gsdf};
  return launch_tangent_bwd<true>((const float*)pos, nullptr, nullptr, 3, n, wpack, bpack, C, E, b,
                                  lds, G, nullptr, nullptr, (float*)d_pos, gw, gb, scratch, max_ctas,
                                  stream);
}
