// The forward of the dense chain with forward tangents for Hopper, K1t (1 to 3
// tangents, ty on a channel or in full) and K4j (the NeRF encoding and its 3 basis
// tangents in front, split outputs), on K1's building blocks (k1.cuh) in tangent.cuh's
// tile layout. Compiled beside the backward pass (fused_mlp.cu) into the same library
// (build.py PARTS).
//
// Replaces the Pallas TPU kernel multimodalstudio_tpu/ops/pallas/fused_mlp.py
// _fwd_kernel (:265) with n_tangents = K, reached through fused_chain (:1080,
// tangents=tx; K1t) and fused_sdf_chain (:1145, mode="jvp"; K4j), which _build_chain
// (:845) builds.
//
// Persistent CTAs; a producer warpgroup streams every layer's forward images (one
// k1_pack launch wrote them, and with grad also the backward images that the call's
// backward reuses) through the bulk-copy ring; a consumer warpgroup owns a 64-row tile
// of b samples' primal and tangent rows: the tangent rows u = t W share W with the
// primal rows z = h W + b, so each layer is one m64 wgmma whose bias seeds the primal
// rows only. A hidden layer's epilogue writes the next A images in place (the first of
// several pieces through the side images, as K1's): the primal rows bf16(act(z)), a
// tangent row bf16(u act'(z)) with its sample's f32 z, which one shuffle brings from
// lane ^ 16 (K = 2, 3) or the thread's own row (K = 1). The last layer's pieces go to
// TanOut's outputs.
//
// Cast points (_fwd_kernel :277-321): t = bf16(u * act'(z)) with the forward's f32 z
// and u; a skip layer's input bf16(concat(h, x0) / sqrt 2) and tangent input
// bf16(concat(t, t0) / sqrt 2); the last layer's u f32, column c to ty [n, K] (or
// sdf / geo / grad in K4j's split mode), or all columns rounded to bf16 (ty [K, n,
// D_out]).
//
// Bound on an H100: (1 + K) chain-sized products per layer against a few hundred bytes
// per sample in and out: the tensor cores bound it. PERF.md has the times.
#include "tangent.cuh"

namespace k1 {

// A hidden layer's output into the activation images with the forward's cast points:
// primal rows bf16(act(z)), tangent rows bf16(u act'(z)) on the f32 z and u; times
// 1/sqrt(2), rounded, before a skip layer. kind0, kind1: the kinds of the thread's rows
// r0 and r0 + 8. Every lane of the warp calls it.
template <int N>
__device__ __forceinline__ void tan_hidden_fwd(const float (&acc)[N / 2], bf16* act, bool scale,
                                               int act_kind, float qa, int K, int kind0,
                                               int kind1) {
  const int r0 = acc_row(), cq = acc_col();
  const bool other = K != 1 && (threadIdx.x & 16);  // the sample's primal row is lane ^ 16's
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float o0 = __shfl_xor_sync(0xffffffffu, acc[4 * j], 16);
    const float o1 = __shfl_xor_sync(0xffffffffu, acc[4 * j + 1], 16);
    const float z0 = other ? o0 : acc[4 * j], z1 = other ? o1 : acc[4 * j + 1];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a0 = acc[4 * j + 2 * e], a1 = acc[4 * j + 2 * e + 1];
      uint32_t h = (e ? kind1 : kind0) == 0
                       ? pack2(act_f(act_kind, a0, qa), act_f(act_kind, a1, qa))
                       : pack2(a0 * act_df(act_kind, z0, qa), a1 * act_df(act_kind, z1, qa));
      if (scale) {
        const float2 v = unpack2(h);
        h = pack2(v.x * SKIP_SCALE, v.y * SKIP_SCALE);
      }
      *reinterpret_cast<uint32_t*>(act + act_el(8 * j + cq, r0 + 8 * e)) = h;
    }
  }
}

template <int WC>
__global__ void __launch_bounds__(NTHREADS, 1)
tan_fwd_kernel(const Geom G, const mms::Enc E, const TanIo I, const TanOut O, int n,
               const bf16* __restrict__ wfw, const float* __restrict__ bpk, bf16* dev_act,
               int nwg, int stages, int sb, int act_bytes) {
  constexpr bool dev = WC == WC_DEV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
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
  const int L = G.L, H = G.H, P0 = G.P0, K = I.K, b = I.b;
  const int tiles = (n + b - 1) / b, groups = (tiles + nwg - 1) / nwg;
  const int warp = threadIdx.x >> 5;
  if (warp >= nwg * 4) {  // producer: every layer's forward images, once per tile group
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == nwg * 128)
      for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) stream_fwd(R, G, wfw, L);
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp >> 2;
  const int x0c = x0_col(G), sidec = side_cols(G);
  bf16* act = act_images<WC>(smem, wg, act_bytes, dev_act, blockIdx.x * nwg + wg);
  AStage as = astage_of(smem, wg, bars, stages);
  AStage* asp = dev ? &as : nullptr;
  {
    uint4* p = reinterpret_cast<uint4*>(act);
    for (int i = threadIdx.x & 127; i < act_bytes / 16; i += 128) p[i] = make_uint4(0, 0, 0, 0);
  }
  wg_sync(1 + wg);
  const int r0 = acc_row(), cq = acc_col();
  const int kind0 = tan_kind(r0, K), kind1 = tan_kind(r0 + 8, K);
  const int bias_rows = kind0 == 0 ? 1 : 0;  // the bias seeds the primal rows only
  const int act_kind = G.act;
  const float qa = G.quad_a;
  const int nph = hidden_pieces<WC>(H);
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long s0 = (long long)(grp * nwg + wg) * b;
    const long long srow = s0 + tan_sample(r0, K);  // both rows' sample
    tan_front(G, E, I, act, x0c, s0, n);
    fence_act<WC>();
    wg_sync(1 + wg);
    for (int l = 0; l < L; ++l) {
      const bf16* a = act + (l == 0 ? (x0c >> 6) * 4096 : 0);
      const int kcs = G.din_pad[l] >> 6;
      const float* B = bpk + G.b_off[l];
      if (l == L - 1) {  // the outputs
        for (int p = 0; p < n_pieces(G.dout_pad[l]); ++p) {
          int off, np;
          piece(G.dout_pad[l], p, off, np);
          with_n(np, [&](auto NC) {
            constexpr int N = decltype(NC)::value;
            float acc[N / 2];
            mma_piece<N>(acc, a, kcs, R, wg, B + off, bias_rows, asp);
            if (srow >= n) return;
#pragma unroll
            for (int j = 0; j < N / 8; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int kind = e ? kind1 : kind0;
                if (kind > K) continue;
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                  const int c = off + 8 * j + cq + q;
                  const float v = acc[4 * j + 2 * e + q];
                  if (kind == 0) {
                    if (O.mode == 2) {
                      if (c == 0)
                        O.sdf[srow] = v;
                      else if (c <= O.width)
                        O.y[srow * O.width + c - 1] = __float2bfloat16(v);
                    } else if (c < O.width) {
                      O.y[srow * O.width + c] = __float2bfloat16(v);
                    }
                  } else if (O.mode == 0) {
                    if (c < O.width)
                      O.ty[((kind - 1) * (long long)n + srow) * O.width + c] = __float2bfloat16(v);
                  } else if (c == O.channel) {
                    O.tyf[srow * K + kind - 1] = v;
                  }
                }
              }
            }
          });
        }
        break;
      }
      const bool next_skip = (G.skip_mask >> (l + 1)) & 1;
      for (int p = 0; p < nph; ++p) {
        int off, np;
        hidden_piece<WC>(H, p, off, np);
        bf16* dst = piece_dst<WC>(act, act_bytes, sidec, p, nph, off);
        with_n64(np, [&](auto NC) {
          constexpr int N = decltype(NC)::value;
          float acc[N / 2];
          mma_piece<N>(acc, a, kcs, R, wg, B + off, bias_rows, asp);
          tan_hidden_fwd<N>(acc, dst, next_skip, act_kind, qa, K, kind0, kind1);
        });
      }
      side_back<WC>(act, act_bytes, sidec, wg);
      if (l == 0 && G.skip_mask) scale_region(act, H, P0);
      fence_act<WC>();
      wg_sync(1 + wg);
    }
  }
}

// The kernel of G's width class and its launch plan over `tiles` row tiles.
static int tan_fwd_plan(const Geom& G, int tiles, const void** kernel, Launch* P) {
  *kernel = with_wc(G, [](auto WC) { return (const void*)tan_fwd_kernel<decltype(WC)::value>; });
  if (plan_chain(G, tiles, PLAN_FWD, 0, P)) return ERR_SMEM;
  if (allow_smem(width_class(G), *kernel) != cudaSuccess) return -1;
  if (persistent(*kernel, P, (tiles + P->nwg - 1) / P->nwg) != cudaSuccess) return -1;
  return 0;
}

}  // namespace k1

static int tangent_samples(int K) { return K == 1 ? 32 : 16; }

static int tan_fwd_launch(const k1::Geom& G, const mms::Enc& E, const k1::TanIo& I,
                          const k1::TanOut& O, int n, const void* wfw, const void* bpk,
                          void* scratch, void* stream) {
  if (!k1::geom_ok(G) || n < 1 || I.K < 1 || I.K > 3 || E.width != G.d_in ||
      O.channel >= G.dout_true[G.L - 1] ||
      (O.mode == 2 ? O.width + 1 : O.width) > G.dout_true[G.L - 1] ||
      (k1::width_class(G) == k1::WC_DEV && !scratch))
    return -1;
  const int tiles = (n + I.b - 1) / I.b;
  k1::Launch P;
  const void* kernel;
  const int st = k1::tan_fwd_plan(G, tiles, &kernel, &P);
  if (st) return st;
  k1::with_wc(G, [&](auto WC) {
    k1::tan_fwd_kernel<decltype(WC)::value><<<P.grid, P.threads, P.smem, (cudaStream_t)stream>>>(
        G, E, I, O, n, (const k1::bf16*)wfw, (const float*)bpk, (k1::bf16*)scratch, P.nwg,
        P.stages, P.sb, P.act_bytes);
    return 0;
  });
  return (int)cudaGetLastError();
}

// Bytes of device scratch a launch over n samples with K tangents needs: the
// activation slabs of a hidden width over 512 (k1.cuh WC_DEV), else 0.
extern "C" long long mms_tangent_fwd_bytes(const k1::Geom* G, int n, int K) {
  if (!k1::geom_ok(*G) || n < 1 || K < 1 || K > 3) return -1;
  if (k1::width_class(*G) != k1::WC_DEV) return 0;
  const int tiles = (n + tangent_samples(K) - 1) / tangent_samples(K);
  k1::Launch P;
  const void* kernel;
  const int st = k1::tan_fwd_plan(*G, tiles, &kernel, &P);
  if (st) return st;
  return (long long)k1::align256((size_t)P.grid * P.nwg * P.act_bytes);
}

// G: the chain's layout (fused_mlp.py chain_layout); wfw, bpk: what mms_k1_pack wrote
// for it; scratch: mms_tangent_fwd_bytes of device memory (or null).

// K1t: x [n, d_in] and tx [K, n, d_in] (f32 for x_f32, else bf16) in; y [n, d_out]
// bf16 and ty ([n, K] f32 for channel >= 0, else [K, n, d_out] bf16) out.
extern "C" int mms_chain_tangent_fwd(const k1::Geom* G, const void* x, const void* tx, int x_f32,
                                     int K, int n, int channel, const void* wfw, const void* bpk,
                                     void* y, int d_out, void* ty, void* scratch, void* stream) {
  mms::Enc E{};
  E.width = G->d_in;
  k1::TanIo I{};
  I.x = (const k1::bf16*)x;
  I.tx = (const k1::bf16*)tx;
  I.x_f32 = x_f32;
  I.K = K;
  I.b = tangent_samples(K);
  const k1::TanOut O{channel < 0 ? 0 : 1, channel, d_out, (k1::bf16*)y, (k1::bf16*)ty,
                     (float*)ty, nullptr};
  return tan_fwd_launch(*G, E, I, O, n, wfw, bpk, scratch, stream);
}

// K4j: positions [n, 3] f32 in; sdf [n] f32, geo [n, geo_width] bf16 and grad [n, 3] f32
// out.
extern "C" int mms_sdf_chain_jvp_fwd(const k1::Geom* G, const void* pos, int n, int pe_freqs,
                                     const float* pe_scale, const void* wfw, const void* bpk,
                                     void* sdf, void* geo, int geo_width, void* grad,
                                     void* scratch, void* stream) {
  if (pe_freqs < 1 || pe_freqs > mms::MAXPE) return -1;
  mms::Enc E{};
  E.freqs = pe_freqs;
  for (int i = 0; i < pe_freqs; ++i) E.scale[i] = pe_scale[i];
  E.width = 3 + 6 * pe_freqs;
  k1::TanIo I{};
  I.pos = (const float*)pos;
  I.K = 3;
  I.b = tangent_samples(3);
  const k1::TanOut O{2, 0, geo_width, (k1::bf16*)geo, nullptr, (float*)grad, (float*)sdf};
  return tan_fwd_launch(*G, E, I, O, n, wfw, bpk, scratch, stream);
}
