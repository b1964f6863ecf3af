// Fused NeRF encoding + MLP chain + d sdf / dx (adjoint mode) for Hopper:
// kernel K4, forward and backward.
//
// Replaces two Pallas TPU kernels of multimodalstudio_tpu/ops/pallas/fused_mlp.py,
// reached through fused_sdf_chain (:1145) with mode="adjoint" and built by
// _build_adj_chain (:930):
//   _fwd_adj_kernel (:362): raw positions [N, 3] -> the encoding, the chain, and one
//      reverse (adjoint) sweep of the chain from the sdf channel: sdf [N] f32, geo
//      [N, G] bf16 and grad = J_enc^T adj [N, 3] f32;
//   _bwd_adj_kernel (:410): their backward, reverse over reverse: d pos [N, 3] f32 and
//      the chain's gW / gb f32 (packed).
//
// A CTA owns 64 samples at a time. The encoding [x, sin(x_d s_i), cos(x_d s_i)]
// (enc.cuh) is built in shared memory as bf16, the chain runs on the tensor cores with
// chain.cuh's wmma helper and epilogues, and the adjoint sweep splits a skip layer's
// s into its h part (into the next v) and its x0 part (added to adj), as _adj_sweep
// (:327-359) does. The front end (enc_front) and the d pos tail are the only
// encoding-specific steps, so a variant for an already-encoded bf16 input (K5,
// fused_chain_adjoint :1215) swaps just those two.
//
// Where the stacks live: at the mlp_raw_tpu widths (8 x 256, a skip at layer 4,
// 39 encoded inputs padded to 48) one bf16 stack of the 7 hidden pre-activations of
// a 64-sample tile is 7 x 64 x 256 x 2 = 229,376 B, about a block's whole shared
// memory. The forward needs the z stack for the sweep; the backward needs z, s (the
// sweep's rows) and e (the act'' injections). Both kernels are persistent (at most
// max_ctas CTAs walk the tiles) and keep the stacks in a per-CTA slab of device
// scratch that the wrapper allocates: z (and in the backward s, overwritten by e
// once s is used). Each slab is written and read back by its own CTA within one
// tile; at those widths the resident CTAs' slabs take about 60 MB (two 229 KB
// forward slabs or one 459 KB backward slab per SM), a little over the 50 MB L2.
// Shared memory holds the two activation tiles, x0, and the f32 adjoint /
// cotangent rows [64, p0].
//
// Cast points follow the reference: z stored bf16 and act' / act'' read from it; the
// last layer f32 (sdf) and geo rounded to bf16; v rounded to bf16 before each
// product; s stored bf16 after the skip scale; the adjoint's cotangent ga =
// sum_k g3_k bf16(t0_k) kept f32 and rounded to bf16 at each product (re-injected
// at a skip as bf16(ga / sqrt 2)); e_l = bf16(m * s * act''(z)); gz rounded to bf16
// before both products and gb summing the f32 gz; gW = hin^T gz + qin^T v. The gW /
// gb sums across tiles are f32 atomics, so their order changes from run to run.
//
// Bound on an H100: per sample the forward runs the chain twice (primal and adjoint,
// ~1.9 MFLOP at 8 x 256) and the backward about six times (recompute primal and
// adjoint, the ga-forward chain and its gW, gW and gh of the reverse sweep) against
// 12 + 4 + 512 + 12 bytes of positions and outputs per sample: the tensor cores
// bound both. This first design (wmma, weights from L2, one atomic per gW element
// per tile) is far from that bound; PERF.md has its times.
#include "enc.cuh"

using namespace mms;

struct Enc {
  int freqs;
  float scale[MAXPE];
  int width;  // 3 + 6 * freqs
};

// x0 = bf16 encoding of the tile's positions into buf [64, lds] and x0 [64, ldx0]
// (zero past the encoding's width, to p0, and past n). Ends with __syncthreads().
__device__ __forceinline__ void enc_front(const Enc& E, int p0, const float* pos, int n,
                                          long long row0, bf16* buf, int lds, bf16* x0,
                                          int ldx0) {
  for (int i = threadIdx.x; i < TILE_M * p0; i += NTHREADS) {
    const int r = i / p0, c = i % p0;
    float v = 0.f;
    if (c < E.width && row0 + r < n) v = pe_col(pos + (row0 + r) * 3, E.freqs, E.scale, c);
    const bf16 b = __float2bfloat16(v);
    buf[r * lds + c] = b;
    x0[r * ldx0 + c] = b;
  }
  __syncthreads();
}

// The adjoint sweep (fused_mlp.py:327-359) from v = e_0 in va: for l = L-1 .. 1,
// s = bf16(v) W_l^T; a skip layer adds its x0 part * (1/sqrt 2) to sAdj and scales
// its h part; v = s * act'(z_{l-1}). Layer 0 adds s to sAdj, which must be zero on
// entry. With ss != nullptr the h part of s of layer l goes to ss[l-1] as bf16 (the
// backward's residual). zs / ss: (L-1) x [64, H]. Ends with __syncthreads().
__device__ __forceinline__ void adjoint_sweep(const Chain& C, const bf16* wpack, bf16* va,
                                              bf16* vb, int lds, const bf16* zs, bf16* ss,
                                              float* sAdj, float* stage) {
  const int L = C.n_layers, H = C.hidden, p0 = C.p0;
  const int lane = threadIdx.x & 31;
  const int dl = C.out_dims[L - 1];
  for (int i = threadIdx.x; i < TILE_M * dl; i += NTHREADS) {
    const int r = i / dl, c = i % dl;
    va[r * lds + c] = __float2bfloat16(c == 0 ? 1.f : 0.f);
  }
  __syncthreads();
  for (int l = L - 1; l >= 1; --l) {
    const bool sk = (C.skip_mask >> l) & 1;
    const int hw = sk ? C.in_dims[l] - p0 : C.in_dims[l];
    const bf16* zl = zs + (long long)(l - 1) * TILE_M * H;
    bf16* sl = ss ? ss + (long long)(l - 1) * TILE_M * H : nullptr;
    mma_tile64<true>(va, lds, C.out_dims[l], wpack + C.w_off[l], C.out_dims[l], C.in_dims[l],
                     stage, [&](int r0, int c0, const float* t) {
                       for (int i = lane; i < 256; i += 32) {
                         const int r = r0 + (i >> 4), c = c0 + (i & 15);
                         if (c < hw) {
                           const float s = sk ? t[i] * SKIP_SCALE : t[i];
                           vb[r * lds + c] =
                               __float2bfloat16(s * act_df(C.act, bf(zl[r * H + c]), C.quad_a));
                           if (sl) sl[r * H + c] = __float2bfloat16(s);
                         } else {
                           sAdj[r * p0 + c - hw] += t[i] * SKIP_SCALE;
                         }
                       }
                     });
    __syncthreads();
    bf16* tmp = va;
    va = vb;
    vb = tmp;
  }
  mma_tile64<true>(va, lds, C.out_dims[0], wpack + C.w_off[0], C.out_dims[0], p0, stage,
                   [&](int r0, int c0, const float* t) {
                     for (int i = lane; i < 256; i += 32)
                       sAdj[(r0 + (i >> 4)) * p0 + c0 + (i & 15)] += t[i];
                   });
  __syncthreads();
}

// ------------------------------------------------------------------ forward

__global__ void __launch_bounds__(NTHREADS)
sdf_chain_fwd_kernel(const float* __restrict__ pos, int n, const bf16* __restrict__ wpack,
                     const float* __restrict__ bpack, Chain C, Enc E, int lds, int ldx0,
                     float* __restrict__ sdf, bf16* __restrict__ geo, int geo_width,
                     float* __restrict__ grad, bf16* scratch) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = C.n_layers, H = C.hidden, p0 = C.p0;
  bf16* buf0 = reinterpret_cast<bf16*>(smem);
  bf16* buf1 = buf0 + TILE_M * lds;
  bf16* x0 = buf1 + TILE_M * lds;                                // [64, ldx0]
  float* sAdj = reinterpret_cast<float*>(x0 + TILE_M * ldx0);    // [64, p0]
  float* stage = sAdj + TILE_M * p0;
  bf16* zs = scratch + (long long)blockIdx.x * (L - 1) * TILE_M * H;  // (L-1) x [64, H]
  const int lane = threadIdx.x & 31;
  const int n_tiles = (n + TILE_M - 1) / TILE_M;
  const float* BL = bpack + C.b_off[L - 1];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = (long long)tile * TILE_M;
    enc_front(E, p0, pos, n, row0, buf0, lds, x0, ldx0);
    for (int i = threadIdx.x; i < TILE_M * p0; i += NTHREADS) sAdj[i] = 0.f;
    const bf16* h = run_hidden_layers(C, wpack, bpack, buf0, buf1, lds, x0, ldx0, zs, H, stage);
    // last layer: sdf = column 0 in f32, geo = columns 1 .. geo_width in bf16
    mma_tile64<false>(h, lds, C.in_dims[L - 1], wpack + C.w_off[L - 1], C.out_dims[L - 1],
                      C.out_dims[L - 1], stage, [&](int r0, int c0, const float* t) {
                        for (int i = lane; i < 256; i += 32) {
                          const int r = r0 + (i >> 4), c = c0 + (i & 15);
                          if (row0 + r >= n) continue;
                          const float z = t[i] + BL[c];
                          if (c == 0) sdf[row0 + r] = z;
                          else if (c <= geo_width)
                            geo[(row0 + r) * geo_width + c - 1] = __float2bfloat16(z);
                        }
                      });
    __syncthreads();
    adjoint_sweep(C, wpack, buf0, buf1, lds, zs, nullptr, sAdj, stage);
    // d sdf / dx = J_enc^T adj
    if (threadIdx.x < TILE_M && row0 + threadIdx.x < n) {
      const int r = threadIdx.x;
      const float* p = pos + (row0 + r) * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        grad[(row0 + r) * 3 + k] = pe_jt(sAdj + r * p0, p, E.freqs, E.scale, k);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------ backward

__global__ void __launch_bounds__(NTHREADS)
sdf_chain_bwd_kernel(const float* __restrict__ pos, int n, const bf16* __restrict__ wpack,
                     const float* __restrict__ bpack, Chain C, Enc E, int lds, int ldx0,
                     const float* __restrict__ gsdf, const bf16* __restrict__ ggeo, int geo_width,
                     const float* __restrict__ g3_in, float* __restrict__ d_pos,
                     float* __restrict__ gw, float* __restrict__ gb, bf16* scratch) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = C.n_layers, H = C.hidden, p0 = C.p0, F = E.freqs;
  bf16* buf0 = reinterpret_cast<bf16*>(smem);
  bf16* buf1 = buf0 + TILE_M * lds;
  bf16* x0 = buf1 + TILE_M * lds;                                // [64, ldx0]
  float* sAdj = reinterpret_cast<float*>(x0 + TILE_M * ldx0);    // adj [64, p0]
  float* sGa = sAdj + TILE_M * p0;                               // ga [64, p0]
  float* sGx = sGa + TILE_M * p0;                                // gx0, then ghin [64, p0]
  float* stage = sGx + TILE_M * p0;
  // this CTA's slab: z stack, then s stack (overwritten by e), (L-1) x [64, H] each
  bf16* zs = scratch + (long long)blockIdx.x * 2 * (L - 1) * TILE_M * H;
  bf16* ss = zs + (long long)(L - 1) * TILE_M * H;
  const int lane = threadIdx.x & 31;
  const int n_tiles = (n + TILE_M - 1) / TILE_M;
  const int dl = C.out_dims[L - 1];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = (long long)tile * TILE_M;
    // ---- recompute the primal z stack and the adjoint (s stack, adj)
    enc_front(E, p0, pos, n, row0, buf0, lds, x0, ldx0);
    for (int i = threadIdx.x; i < TILE_M * p0; i += NTHREADS) {
      sAdj[i] = 0.f;
      sGx[i] = 0.f;
    }
    run_hidden_layers(C, wpack, bpack, buf0, buf1, lds, x0, ldx0, zs, H, stage);
    adjoint_sweep(C, wpack, buf0, buf1, lds, zs, ss, sAdj, stage);

    // ---- ga = sum_k g3_k bf16(t0_k) (:479), f32 in sGa; Qc = bf16(ga)
    bf16* Qc = buf0;
    bf16* Qn = buf1;
    for (int i = threadIdx.x; i < TILE_M * p0; i += NTHREADS) {
      const int r = i / p0, c = i % p0;
      float v = 0.f;
      if (c < E.width && row0 + r < n) {
        const float* g3 = g3_in + (row0 + r) * 3;
        if (c < 3) {
          v = g3[c];
        } else {
          const int d = (c - 3) % (3 * F) / F;
          v = g3[d] * pe_tangent(pos + (row0 + r) * 3, F, E.scale, c);
        }
      }
      sGa[i] = v;
      Qc[r * lds + c] = __float2bfloat16(v);
    }
    __syncthreads();

    // ---- ga-forward chain (:489-524): v_l = s_l * act'(z_l); gW_l += bf16(qin_l)^T
    // bf16(v_l); m = bf16(qin_l) W_l; e_l = bf16(m * s_l * act''(z_l)) over s_l;
    // q = m * act'(z_l), with ga re-injected at a skip. The last layer's v is e_0, so
    // its term is the column sums of bf16(qin_{L-1}) into gW_{L-1}[:, 0].
    for (int l = 0; l < L; ++l) {
      const int din = C.in_dims[l];
      if (l == L - 1) {
        for (int c = threadIdx.x; c < din; c += NTHREADS) {
          float s = 0.f;
          for (int r = 0; r < TILE_M; ++r) s += bf(Qc[r * lds + c]);
          if (s != 0.f) atomicAdd(gw + C.w_off[l] + (long long)c * dl, s);
        }
        break;
      }
      const bf16* zl = zs + (long long)l * TILE_M * H;
      bf16* sl = ss + (long long)l * TILE_M * H;
      for (int i = threadIdx.x; i < TILE_M * H; i += NTHREADS) {
        const int r = i / H, c = i % H;
        Qn[r * lds + c] = __float2bfloat16(bf(sl[r * H + c]) *
                                           act_df(C.act, bf(zl[r * H + c]), C.quad_a));
      }
      __syncthreads();
      mma_atb64_atomic(Qc, lds, din, Qn, lds, H, gw + C.w_off[l], C.out_dims[l], stage);
      __syncthreads();
      const bool next_skip = (C.skip_mask >> (l + 1)) & 1;
      mma_tile64<false>(Qc, lds, din, wpack + C.w_off[l], C.out_dims[l], C.out_dims[l], stage,
                        [&](int r0, int c0, const float* t) {
                          for (int i = lane; i < 256; i += 32) {
                            const int r = r0 + (i >> 4), c = c0 + (i & 15);
                            const float z = bf(zl[r * H + c]);
                            const float s = bf(sl[r * H + c]);
                            sl[r * H + c] = __float2bfloat16(t[i] * s * act_ddf(C.act, z, C.quad_a));
                            const float q = t[i] * act_df(C.act, z, C.quad_a);
                            Qn[r * lds + c] = __float2bfloat16(next_skip ? q * SKIP_SCALE : q);
                          }
                        });
      if (next_skip) {
        for (int i = threadIdx.x; i < TILE_M * p0; i += NTHREADS) {
          const int r = i / p0, c = i % p0;
          Qn[r * lds + H + c] = __float2bfloat16(sGa[i] * SKIP_SCALE);
        }
      }
      __syncthreads();
      bf16* tmp = Qc;
      Qc = Qn;
      Qn = tmp;
    }
    __syncthreads();

    // ---- the standard reverse sweep with the e_l injections (:536-575) from
    // gy = [gsdf, ggeo, 0]; gb_{L-1} sums the f32 gy
    bf16* G = buf0;
    bf16* Hb = buf1;
    for (int i = threadIdx.x; i < TILE_M * dl; i += NTHREADS) {
      const int r = i / dl, c = i % dl;
      float v = 0.f;
      if (row0 + r < n) {
        if (c == 0) v = gsdf[row0 + r];
        else if (c <= geo_width) v = bf(ggeo[(row0 + r) * geo_width + c - 1]);
      }
      G[r * lds + c] = __float2bfloat16(v);
    }
    for (int c = threadIdx.x; c <= geo_width && c < dl; c += NTHREADS) {
      float s = 0.f;
      for (int r = 0; r < TILE_M && row0 + r < n; ++r)
        s += c == 0 ? gsdf[row0 + r] : bf(ggeo[(row0 + r) * geo_width + c - 1]);
      if (s != 0.f) atomicAdd(gb + C.b_off[L - 1] + c, s);
    }
    for (int l = L - 1; l >= 0; --l) {
      const bool sk = (C.skip_mask >> l) & 1;
      const int din = C.in_dims[l], dout = C.out_dims[l];
      const int hw = sk ? din - p0 : din;
      // hin_l: x0, or bf16(act(z_{l-1})) (and for a skip layer concat(., x0) / sqrt 2)
      const bf16* hin = x0;
      int ldh = ldx0;
      if (l > 0) {
        const bf16* zp = zs + (long long)(l - 1) * TILE_M * H;
        for (int i = threadIdx.x; i < TILE_M * H; i += NTHREADS) {
          const int r = i / H, c = i % H;
          float h = round_bf16(act_f(C.act, bf(zp[r * H + c]), C.quad_a));
          if (sk) h = h * SKIP_SCALE;
          Hb[r * lds + c] = __float2bfloat16(h);
        }
        if (sk) {
          for (int i = threadIdx.x; i < TILE_M * p0; i += NTHREADS) {
            const int r = i / p0, c = i % p0;
            Hb[r * lds + H + c] = __float2bfloat16(bf(x0[r * ldx0 + c]) * SKIP_SCALE);
          }
        }
        hin = Hb;
        ldh = lds;
      }
      __syncthreads();
      mma_atb64_atomic(hin, ldh, din, G, lds, dout, gw + C.w_off[l], dout, stage);
      __syncthreads();
      if (l > 0) {
        const bf16* zp = zs + (long long)(l - 1) * TILE_M * H;
        const bf16* ep = ss + (long long)(l - 1) * TILE_M * H;
        float* gbl = gb + C.b_off[l - 1];
        ColSum cols;
        mma_tile64<true>(G, lds, dout, wpack + C.w_off[l], dout, din, stage,
                         [&](int r0, int c0, const float* t) {
                           float part = 0.f;
                           for (int i = lane; i < 256; i += 32) {
                             const int r = r0 + (i >> 4), c = c0 + (i & 15);
                             if (c < hw) {
                               const float g = sk ? t[i] * SKIP_SCALE : t[i];
                               const float gz = g * act_df(C.act, bf(zp[r * H + c]), C.quad_a) +
                                                bf(ep[r * H + c]);
                               Hb[r * lds + c] = __float2bfloat16(gz);
                               part += gz;
                             } else {
                               sGx[r * p0 + c - hw] += t[i] * SKIP_SCALE;
                             }
                           }
                           if (c0 < hw) cols.add(part, r0, c0, gbl);
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

    // ---- d pos = J_enc^T ghin + g3_k <adj, enc''_k> (:577-599)
    if (threadIdx.x < TILE_M && row0 + threadIdx.x < n) {
      const int r = threadIdx.x;
      const float* p = pos + (row0 + r) * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float g3 = g3_in[(row0 + r) * 3 + k];
        d_pos[(row0 + r) * 3 + k] = pe_jt(sGx + r * p0, p, F, E.scale, k) +
                                    g3 * pe_hess(sAdj + r * p0, p, F, E.scale, k);
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------ entry points

static int setup(Chain& C, Enc& E, int& lds, int& ldx0, int n_layers, const int* in_dims,
                 const int* out_dims, int skip_mask, int hidden, int p0, int act, float quad_a,
                 int pe_freqs, const float* pe_scale, int geo_width) {
  if (fill_chain(C, n_layers, in_dims, out_dims, skip_mask, hidden, p0, act, quad_a)) return -1;
  if (n_layers < 2 || (skip_mask & 1) || pe_freqs < 1 || pe_freqs > MAXPE) return -1;
  if (3 + 6 * pe_freqs > p0 || in_dims[0] != p0 || geo_width >= out_dims[n_layers - 1]) return -1;
  int width = p0;
  for (int l = 0; l < n_layers; ++l) {
    const bool sk = (skip_mask >> l) & 1;
    if (l > 0 && in_dims[l] != hidden + (sk ? p0 : 0)) return -1;
    if (l < n_layers - 1 && out_dims[l] != hidden) return -1;
    width = width > in_dims[l] ? width : in_dims[l];
    width = width > out_dims[l] ? width : out_dims[l];
  }
  E.freqs = pe_freqs;
  for (int i = 0; i < pe_freqs; ++i) E.scale[i] = pe_scale[i];
  E.width = 3 + 6 * pe_freqs;
  lds = width + PAD;
  ldx0 = p0 + PAD;
  return 0;
}

// Scratch bf16 elements per CTA: the z stack (forward), z and s stacks (backward).
extern "C" long long mms_sdf_chain_slab(int n_layers, int hidden, int backward) {
  return (long long)(backward ? 2 : 1) * (n_layers - 1) * TILE_M * hidden;
}

extern "C" int mms_sdf_chain_fwd(const void* pos, int n, const void* wpack, const void* bpack,
                                 int n_layers, const int* in_dims, const int* out_dims,
                                 int skip_mask, int hidden, int p0, int act, float quad_a,
                                 int pe_freqs, const float* pe_scale, void* sdf, void* geo,
                                 int geo_width, void* grad, void* scratch, int max_ctas,
                                 void* stream) {
  Chain C;
  Enc E;
  int lds, ldx0;
  if (setup(C, E, lds, ldx0, n_layers, in_dims, out_dims, skip_mask, hidden, p0, act, quad_a,
            pe_freqs, pe_scale, geo_width) || max_ctas < 1)
    return -1;
  const size_t smem = 2 * (size_t)TILE_M * lds * sizeof(bf16) +
                      (size_t)TILE_M * ldx0 * sizeof(bf16) + (size_t)TILE_M * p0 * sizeof(float) +
                      NWARPS * 256 * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(sdf_chain_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int grid;
  err = persistent_grid((const void*)sdf_chain_fwd_kernel, smem, n, max_ctas, &grid);
  if (err != cudaSuccess) return (int)err;
  sdf_chain_fwd_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const float*)pos, n, (const bf16*)wpack, (const float*)bpack, C, E, lds, ldx0,
      (float*)sdf, (bf16*)geo, geo_width, (float*)grad, (bf16*)scratch);
  return (int)cudaGetLastError();
}

extern "C" int mms_sdf_chain_bwd(const void* pos, int n, const void* wpack, const void* bpack,
                                 int n_layers, const int* in_dims, const int* out_dims,
                                 int skip_mask, int hidden, int p0, int act, float quad_a,
                                 int pe_freqs, const float* pe_scale, const void* gsdf,
                                 const void* ggeo, int geo_width, const void* g3, void* d_pos,
                                 void* gw, void* gb, void* scratch, int max_ctas, void* stream) {
  Chain C;
  Enc E;
  int lds, ldx0;
  if (setup(C, E, lds, ldx0, n_layers, in_dims, out_dims, skip_mask, hidden, p0, act, quad_a,
            pe_freqs, pe_scale, geo_width) || max_ctas < 1)
    return -1;
  const size_t smem = 2 * (size_t)TILE_M * lds * sizeof(bf16) +
                      (size_t)TILE_M * ldx0 * sizeof(bf16) +
                      3 * (size_t)TILE_M * p0 * sizeof(float) + NWARPS * 256 * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(sdf_chain_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int grid;
  err = persistent_grid((const void*)sdf_chain_bwd_kernel, smem, n, max_ctas, &grid);
  if (err != cudaSuccess) return (int)err;
  sdf_chain_bwd_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const float*)pos, n, (const bf16*)wpack, (const float*)bpack, C, E, lds, ldx0,
      (const float*)gsdf, (const bf16*)ggeo, geo_width, (const float*)g3, (float*)d_pos,
      (float*)gw, (float*)gb, (bf16*)scratch);
  return (int)cudaGetLastError();
}
