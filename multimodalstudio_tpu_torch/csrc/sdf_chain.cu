// Fused MLP chain + reverse-mode input gradient (adjoint mode) for Hopper: kernels
// K4 (NeRF encoding in front) and K5 (an already-encoded input), forward and backward.
//
// Replaces two Pallas TPU kernels of multimodalstudio_tpu/ops/pallas/fused_mlp.py, built
// by _build_adj_chain (:930) and reached through fused_sdf_chain (:1145, mode="adjoint",
// the encoding inside) and fused_chain_adjoint (:1215, enc=None):
//   _fwd_adj_kernel (:362): the chain and one reverse (adjoint) sweep of it from one
//      output channel. K4: raw positions [N, 3] in, the encoding built in the kernel;
//      sdf [N] f32, geo [N, G] bf16 and grad = J_enc^T adj [N, 3] f32 out. K5: a bf16
//      input [N, D] in; y [N, D_out] bf16 and adj = d y_c / d x [N, D] f32 out;
//   _bwd_adj_kernel (:410): their backward, reverse over reverse: the chain's gW / gb
//      f32 (packed) and d pos [N, 3] f32 (K4) or gx [N, D] bf16 (K5).
//
// A CTA owns 64 samples at a time. The chain input x0 is built in shared memory as bf16
// (front: the encoding [x, sin(x_d s_i), cos(x_d s_i)] of enc.cuh, or the input's rows),
// the chain runs on the tensor cores with chain.cuh's wmma helper and epilogues, and the
// adjoint sweep splits a skip layer's s into its h part (into the next v) and its x0
// part (added to adj), as _adj_sweep (:327-359) does. Only the front end, the outputs
// and the backward's ga and d pos / gx steps differ between K4 and K5: the kernels take
// a template flag ENC.
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
// last layer f32 (K4's sdf) and rounded to bf16 (geo, K5's y); v rounded to bf16 before
// each product; s stored bf16 after the skip scale; the adjoint's cotangent ga (K4:
// sum_k g3_k bf16(t0_k); K5: the f32 input) kept f32 and rounded to bf16 at each product
// (re-injected at a skip as bf16(ga / sqrt 2)); e_l = bf16(m * s * act''(z)); the last
// layer's cotangent bf16 (K4: its sdf column f32 for gb); gz rounded to bf16 before both
// products and gb summing the f32 gz; gW = hin^T gz + qin^T v; K5's gx rounded to bf16.
// The gW / gb sums across tiles are f32 atomics, so their order changes from run to run.
//
// Bound on an H100: per sample the forward runs the chain twice (primal and adjoint,
// ~1.9 MFLOP at 8 x 256) and the backward about six times (recompute primal and
// adjoint, the ga-forward chain and its gW, gW and gh of the reverse sweep) against
// 12 + 4 + 512 + 12 bytes of positions and outputs per sample: the tensor cores
// bound both. This first design (wmma, weights from L2, one atomic per gW element
// per tile) is far from that bound; PERF.md has its times.
#include "enc.cuh"

using namespace mms;

// The tile's chain input x0 into buf [64, lds] and x0 [64, ldx0] (zero past E.width,
// to p0, and past n): the bf16 encoding of the positions pos [n, 3] (ENC) or the rows
// of the bf16 input x [n, E.width]. Ends with __syncthreads().
template <bool ENC>
__device__ __forceinline__ void front(const Enc& E, int p0, const float* pos, const bf16* x,
                                      int n, long long row0, bf16* buf, int lds, bf16* x0,
                                      int ldx0) {
  for (int i = threadIdx.x; i < TILE_M * p0; i += NTHREADS) {
    const int r = i / p0, c = i % p0;
    bf16 b = __float2bfloat16(0.f);
    if (c < E.width && row0 + r < n)
      b = ENC ? __float2bfloat16(pe_col(pos + (row0 + r) * 3, E.freqs, E.scale, c))
              : x[(row0 + r) * E.width + c];
    buf[r * lds + c] = b;
    x0[r * ldx0 + c] = b;
  }
  __syncthreads();
}

// The adjoint sweep (fused_mlp.py:327-359) from v = e_channel in va: for l = L-1 .. 1,
// s = bf16(v) W_l^T; a skip layer adds its x0 part * (1/sqrt 2) to sAdj and scales
// its h part; v = s * act'(z_{l-1}). Layer 0 adds s to sAdj, which must be zero on
// entry. With ss != nullptr the h part of s of layer l goes to ss[l-1] as bf16 (the
// backward's residual). zs / ss: (L-1) x [64, H]. Ends with __syncthreads().
__device__ __forceinline__ void adjoint_sweep(const Chain& C, int channel, const bf16* wpack,
                                              bf16* va, bf16* vb, int lds, const bf16* zs,
                                              bf16* ss, float* sAdj, float* stage) {
  const int L = C.n_layers, H = C.hidden, p0 = C.p0;
  const int lane = threadIdx.x & 31;
  const int dl = C.out_dims[L - 1];
  for (int i = threadIdx.x; i < TILE_M * dl; i += NTHREADS) {
    const int r = i / dl, c = i % dl;
    va[r * lds + c] = __float2bfloat16(c == channel ? 1.f : 0.f);
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

// ENC: out_f = sdf [n], out_b = geo [n, out_width], out_g = grad [n, 3].
// !ENC: out_b = y [n, out_width], out_g = adj [n, E.width] (out_f unused).
template <bool ENC>
__global__ void __launch_bounds__(NTHREADS)
adj_chain_fwd_kernel(const float* __restrict__ pos, const bf16* __restrict__ x, int n,
                     const bf16* __restrict__ wpack, const float* __restrict__ bpack, Chain C,
                     Enc E, int lds, int ldx0, int channel, float* __restrict__ out_f,
                     bf16* __restrict__ out_b, int out_width, float* __restrict__ out_g,
                     bf16* scratch) {
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
    front<ENC>(E, p0, pos, x, n, row0, buf0, lds, x0, ldx0);
    for (int i = threadIdx.x; i < TILE_M * p0; i += NTHREADS) sAdj[i] = 0.f;
    const bf16* h = run_hidden_layers(C, wpack, bpack, buf0, buf1, lds, x0, ldx0, zs, H, stage);
    // last layer: K4's sdf = column 0 in f32 and geo = columns 1 .. out_width in bf16;
    // K5's y = columns 0 .. out_width - 1 in bf16
    mma_tile64<false>(h, lds, C.in_dims[L - 1], wpack + C.w_off[L - 1], C.out_dims[L - 1],
                      C.out_dims[L - 1], stage, [&](int r0, int c0, const float* t) {
                        for (int i = lane; i < 256; i += 32) {
                          const int r = r0 + (i >> 4), c = c0 + (i & 15);
                          if (row0 + r >= n) continue;
                          const float z = t[i] + BL[c];
                          if (!ENC) {
                            if (c < out_width) out_b[(row0 + r) * out_width + c] = __float2bfloat16(z);
                          } else if (c == 0) {
                            out_f[row0 + r] = z;
                          } else if (c <= out_width) {
                            out_b[(row0 + r) * out_width + c - 1] = __float2bfloat16(z);
                          }
                        }
                      });
    __syncthreads();
    adjoint_sweep(C, channel, wpack, buf0, buf1, lds, zs, nullptr, sAdj, stage);
    if (ENC) {
      // d sdf / dx = J_enc^T adj
      if (threadIdx.x < TILE_M && row0 + threadIdx.x < n) {
        const int r = threadIdx.x;
        const float* p = pos + (row0 + r) * 3;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          out_g[(row0 + r) * 3 + k] = pe_jt(sAdj + r * p0, p, E.freqs, E.scale, k);
      }
    } else {
      for (int i = threadIdx.x; i < TILE_M * E.width; i += NTHREADS) {
        const int r = i / E.width, c = i % E.width;
        if (row0 + r < n) out_g[(row0 + r) * E.width + c] = sAdj[r * p0 + c];
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------ backward

// ENC: the cotangents gsdf [n] f32, gy = ggeo [n, gy_width] bf16 and g_in = g3 [n, 3]
// f32 in; d_pos [n, 3] f32 out. !ENC: gy [n, gy_width] bf16 and g_in = ga [n, E.width]
// f32 in; gx [n, E.width] bf16 out. Both: gw, gb f32 (packed, accumulated).
template <bool ENC>
__global__ void __launch_bounds__(NTHREADS)
adj_chain_bwd_kernel(const float* __restrict__ pos, const bf16* __restrict__ x, int n,
                     const bf16* __restrict__ wpack, const float* __restrict__ bpack, Chain C,
                     Enc E, int lds, int ldx0, int channel, const float* __restrict__ gsdf,
                     const bf16* __restrict__ gy, int gy_width, const float* __restrict__ g_in,
                     float* __restrict__ d_pos, bf16* __restrict__ gx, float* __restrict__ gw,
                     float* __restrict__ gb, bf16* scratch) {
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
    front<ENC>(E, p0, pos, x, n, row0, buf0, lds, x0, ldx0);
    for (int i = threadIdx.x; i < TILE_M * p0; i += NTHREADS) {
      sAdj[i] = 0.f;
      sGx[i] = 0.f;
    }
    run_hidden_layers(C, wpack, bpack, buf0, buf1, lds, x0, ldx0, zs, H, stage);
    adjoint_sweep(C, channel, wpack, buf0, buf1, lds, zs, ss, sAdj, stage);

    // ---- ga: K4's sum_k g3_k bf16(t0_k) (:479), K5's input (:483); f32 in sGa; Qc = bf16(ga)
    bf16* Qc = buf0;
    bf16* Qn = buf1;
    for (int i = threadIdx.x; i < TILE_M * p0; i += NTHREADS) {
      const int r = i / p0, c = i % p0;
      float v = 0.f;
      if (c < E.width && row0 + r < n) {
        if (!ENC) {
          v = g_in[(row0 + r) * E.width + c];
        } else if (c < 3) {
          v = g_in[(row0 + r) * 3 + c];
        } else {
          const int d = (c - 3) % (3 * F) / F;
          v = g_in[(row0 + r) * 3 + d] * pe_tangent(pos + (row0 + r) * 3, F, E.scale, c);
        }
      }
      sGa[i] = v;
      Qc[r * lds + c] = __float2bfloat16(v);
    }
    __syncthreads();

    // ---- ga-forward chain (:489-524): v_l = s_l * act'(z_l); gW_l += bf16(qin_l)^T
    // bf16(v_l); m = bf16(qin_l) W_l; e_l = bf16(m * s_l * act''(z_l)) over s_l;
    // q = m * act'(z_l), with ga re-injected at a skip. The last layer's v is e_channel,
    // so its term is the column sums of bf16(qin_{L-1}) into gW_{L-1}[:, channel].
    for (int l = 0; l < L; ++l) {
      const int din = C.in_dims[l];
      if (l == L - 1) {
        for (int c = threadIdx.x; c < din; c += NTHREADS) {
          float s = 0.f;
          for (int r = 0; r < TILE_M; ++r) s += bf(Qc[r * lds + c]);
          if (s != 0.f) atomicAdd(gw + C.w_off[l] + (long long)c * dl + channel, s);
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

    // ---- the standard reverse sweep with the e_l injections (:536-575) from the last
    // layer's cotangent (K4: [gsdf, ggeo, 0], K5: [gy, 0]); gb_{L-1} sums it in f32
    bf16* G = buf0;
    bf16* Hb = buf1;
    const int lead = ENC ? 1 : 0;  // K4's column 0 is gsdf
    auto gy_at = [&](long long row, int c) -> float {
      if (ENC && c == 0) return gsdf[row];
      return c - lead < gy_width ? bf(gy[row * gy_width + c - lead]) : 0.f;
    };
    for (int i = threadIdx.x; i < TILE_M * dl; i += NTHREADS) {
      const int r = i / dl, c = i % dl;
      G[r * lds + c] = __float2bfloat16(row0 + r < n ? gy_at(row0 + r, c) : 0.f);
    }
    for (int c = threadIdx.x; c < gy_width + lead && c < dl; c += NTHREADS) {
      float s = 0.f;
      for (int r = 0; r < TILE_M && row0 + r < n; ++r) s += gy_at(row0 + r, c);
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

    if (ENC) {
      // ---- d pos = J_enc^T ghin + g3_k <adj, enc''_k> (:577-599)
      if (threadIdx.x < TILE_M && row0 + threadIdx.x < n) {
        const int r = threadIdx.x;
        const float* p = pos + (row0 + r) * 3;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float g3 = g_in[(row0 + r) * 3 + k];
          d_pos[(row0 + r) * 3 + k] = pe_jt(sGx + r * p0, p, F, E.scale, k) +
                                      g3 * pe_hess(sAdj + r * p0, p, F, E.scale, k);
        }
      }
    } else {
      // ---- gx = bf16(ghin) (:602)
      for (int i = threadIdx.x; i < TILE_M * E.width; i += NTHREADS) {
        const int r = i / E.width, c = i % E.width;
        if (row0 + r < n) gx[(row0 + r) * E.width + c] = __float2bfloat16(sGx[r * p0 + c]);
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------ entry points

// Checks the chain and fills C, E (width: the chain input's width) and the row strides.
static int setup(Chain& C, Enc& E, int& lds, int& ldx0, int n_layers, const int* in_dims,
                 const int* out_dims, int skip_mask, int hidden, int p0, int act, float quad_a,
                 int pe_freqs, const float* pe_scale, int width) {
  if (fill_chain(C, n_layers, in_dims, out_dims, skip_mask, hidden, p0, act, quad_a)) return -1;
  if (n_layers < 2 || (skip_mask & 1) || pe_freqs < 0 || pe_freqs > MAXPE) return -1;
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
  lds = w + PAD;
  ldx0 = p0 + PAD;
  return 0;
}

// Dynamic shared memory: two activation tiles, x0, and n_rows f32 [64, p0] rows
// (adj; in the backward also ga and gx) and the warps' staging tiles.
static size_t smem_bytes(int lds, int ldx0, int p0, int n_rows) {
  return 2 * (size_t)TILE_M * lds * sizeof(bf16) + (size_t)TILE_M * ldx0 * sizeof(bf16) +
         n_rows * (size_t)TILE_M * p0 * sizeof(float) + NWARPS * 256 * sizeof(float);
}

template <class Kernel, class... Args>
static int launch(Kernel kernel, size_t smem, int n, int max_ctas, void* stream, Args... args) {
  if (smem > MAX_SMEM || max_ctas < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int grid;
  err = persistent_grid((const void*)kernel, smem, n, max_ctas, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// Scratch bf16 elements per CTA: the z stack (forward), z and s stacks (backward).
extern "C" long long mms_sdf_chain_slab(int n_layers, int hidden, int backward) {
  return (long long)(backward ? 2 : 1) * (n_layers - 1) * TILE_M * hidden;
}

// K4's forward: sdf [n] f32, geo [n, geo_width] bf16, grad [n, 3] f32.
extern "C" int mms_sdf_chain_fwd(const void* pos, int n, const void* wpack, const void* bpack,
                                 int n_layers, const int* in_dims, const int* out_dims,
                                 int skip_mask, int hidden, int p0, int act, float quad_a,
                                 int pe_freqs, const float* pe_scale, void* sdf, void* geo,
                                 int geo_width, void* grad, void* scratch, int max_ctas,
                                 void* stream) {
  Chain C;
  Enc E;
  int lds, ldx0;
  if (pe_freqs < 1 || setup(C, E, lds, ldx0, n_layers, in_dims, out_dims, skip_mask, hidden, p0,
                            act, quad_a, pe_freqs, pe_scale, 3 + 6 * pe_freqs) ||
      geo_width >= out_dims[n_layers - 1])
    return -1;
  return launch(adj_chain_fwd_kernel<true>, smem_bytes(lds, ldx0, p0, 1), n, max_ctas, stream,
                (const float*)pos, (const bf16*)nullptr, n, (const bf16*)wpack,
                (const float*)bpack, C, E, lds, ldx0, 0, (float*)sdf, (bf16*)geo, geo_width,
                (float*)grad, (bf16*)scratch);
}

// K4's backward: d_pos [n, 3] f32 and the packed gw, gb (accumulated).
extern "C" int mms_sdf_chain_bwd(const void* pos, int n, const void* wpack, const void* bpack,
                                 int n_layers, const int* in_dims, const int* out_dims,
                                 int skip_mask, int hidden, int p0, int act, float quad_a,
                                 int pe_freqs, const float* pe_scale, const void* gsdf,
                                 const void* ggeo, int geo_width, const void* g3, void* d_pos,
                                 void* gw, void* gb, void* scratch, int max_ctas, void* stream) {
  Chain C;
  Enc E;
  int lds, ldx0;
  if (pe_freqs < 1 || setup(C, E, lds, ldx0, n_layers, in_dims, out_dims, skip_mask, hidden, p0,
                            act, quad_a, pe_freqs, pe_scale, 3 + 6 * pe_freqs) ||
      geo_width >= out_dims[n_layers - 1])
    return -1;
  return launch(adj_chain_bwd_kernel<true>, smem_bytes(lds, ldx0, p0, 3), n, max_ctas, stream,
                (const float*)pos, (const bf16*)nullptr, n, (const bf16*)wpack,
                (const float*)bpack, C, E, lds, ldx0, 0, (const float*)gsdf, (const bf16*)ggeo,
                geo_width, (const float*)g3, (float*)d_pos, (bf16*)nullptr, (float*)gw,
                (float*)gb, (bf16*)scratch);
}

// K5's forward: x [n, d_in] bf16 in; y [n, d_out] bf16 and adj [n, d_in] f32 out.
extern "C" int mms_chain_adj_fwd(const void* x, int n, const void* wpack, const void* bpack,
                                 int n_layers, const int* in_dims, const int* out_dims,
                                 int skip_mask, int hidden, int p0, int act, float quad_a,
                                 int d_in, int channel, void* y, int d_out, void* adj,
                                 void* scratch, int max_ctas, void* stream) {
  Chain C;
  Enc E;
  int lds, ldx0;
  if (setup(C, E, lds, ldx0, n_layers, in_dims, out_dims, skip_mask, hidden, p0, act, quad_a, 0,
            nullptr, d_in) ||
      d_out > out_dims[n_layers - 1] || channel < 0 || channel >= d_out)
    return -1;
  return launch(adj_chain_fwd_kernel<false>, smem_bytes(lds, ldx0, p0, 1), n, max_ctas, stream,
                (const float*)nullptr, (const bf16*)x, n, (const bf16*)wpack, (const float*)bpack,
                C, E, lds, ldx0, channel, (float*)nullptr, (bf16*)y, d_out, (float*)adj,
                (bf16*)scratch);
}

// K5's backward: gy [n, d_out] bf16 and ga [n, d_in] f32 in; gx [n, d_in] bf16 and the
// packed gw, gb (accumulated) out.
extern "C" int mms_chain_adj_bwd(const void* x, int n, const void* wpack, const void* bpack,
                                 int n_layers, const int* in_dims, const int* out_dims,
                                 int skip_mask, int hidden, int p0, int act, float quad_a,
                                 int d_in, int channel, const void* gy, int d_out, const void* ga,
                                 void* gx, void* gw, void* gb, void* scratch, int max_ctas,
                                 void* stream) {
  Chain C;
  Enc E;
  int lds, ldx0;
  if (setup(C, E, lds, ldx0, n_layers, in_dims, out_dims, skip_mask, hidden, p0, act, quad_a, 0,
            nullptr, d_in) ||
      d_out > out_dims[n_layers - 1] || channel < 0 || channel >= d_out)
    return -1;
  return launch(adj_chain_bwd_kernel<false>, smem_bytes(lds, ldx0, p0, 3), n, max_ctas, stream,
                (const float*)nullptr, (const bf16*)x, n, (const bf16*)wpack, (const float*)bpack,
                C, E, lds, ldx0, channel, (const float*)nullptr, (const bf16*)gy, d_out,
                (const float*)ga, (float*)nullptr, (bf16*)gx, (float*)gw, (float*)gb,
                (bf16*)scratch);
}
