"""Fused dense chain (MLP): kernel K1, forward and backward, without and
with forward tangents (K1t), and their plain versions.

`fused_chain` runs a whole MLP layer chain on the card without writing the
activations between layers to device memory. It replaces the Pallas TPU
kernels multimodalstudio_tpu/ops/pallas/fused_mlp.py::_fwd_kernel (:265)
and _bwd_kernel (:607), reached through `fused_chain` (:1080), without
tangents, by the four kernels of csrc/fused_chain.cu: a pack of the weights
into the bf16 images that wgmma reads (one launch), the forward (wgmma on
weight images staged by bulk copies, activations in place in shared
memory), and for the backward a per-tile pass (forward recompute, reverse
sweep gh = gz W^T; writes gx, gb and the per-layer stacks of the layer
inputs hin_l and cotangents gz_l) and `chain_wgrad`, gW_l = hin_l^T gz_l of
every layer in one launch. A forward call is two device launches (pack,
chain); with grad the pack also writes the backward images, which the
backward reuses: one fill of gW/gb and two launches.

With `tangents` [K, N, D_in] (K1t, the same two Pallas bodies with
n_tangents = K) the chain also carries K forward tangents: y and ty
[K, N, D_out] bf16, or with `tangent_out_channel=c` only column c of the
last layer's f32 tangents, [N, K] f32. On the card a tile is 64 rows of
the same products: the primal rows of b samples and the K tangent rows of
each (b = 16 for K = 2, 3; 32 for K = 1), since u = t W shares W with z =
h W + b (csrc/fused_mlp.cu). The backward (reverse over the tangent chain,
act'' term included) runs on K1's building blocks: the pack, a per-tile
pass on the same 64-row tiles (csrc/fused_mlp.cu) that writes gx, gtx, gb
and the stacks of every layer's gW operands (the primal and tangent rows'
inputs and cotangents), and chain_wgrad over them.

Arithmetic (the JAX kernel's cast points, chain_reference :1263-1302):
inputs and weights bf16, products accumulated in f32 plus an f32 bias,
the hidden activation evaluated in f32 and rounded to bf16, a skip layer's
input concat(h, x0) * 1/sqrt(2) rounded to bf16, and the last layer's z
rounded to bf16 for y. Tangents: u = t W in f32, t = bf16(u * act'(z))
with the forward's f32 z, the last layer's u kept f32 (rounded to bf16 for
the full ty).

Backward cast points (_bwd_kernel :645-789): the cotangent gy arrives in
bf16; the hidden inputs of layer l are recomputed as bf16(act(z)) from the
bf16-stored z; gz = gh * act'(z) is rounded to bf16 before both products
(gW = hin^T gz, gh = gz W^T); gb sums the unrounded f32 gz; gx is bf16.
With tangents the recompute stores zb = bf16(z) and ub = bf16(u) and
propagates t = bf16(ub * act'(zb)); tin = bf16(u_stack * act'(zb)); the
tangent cotangent gty arrives f32 [N, K] (scattered into column c) or bf16;
per layer gz = gh act'(z) + (sum_k gt_k u_k) act''(z), gu = gt act'(z), gW
= hin^T bf16(gz) + sum_k tin_k^T bf16(gu_k), gb = sum gz, gh = bf16(gz)
W^T, gt = bf16(gu) W^T; gx and gtx are bf16.

Bound on an H100 at the slice's widths: about 2 * N * sum(din * dout)
flops (6 * N * sum(din * dout) for the backward, forward recompute
included) against 2 * N * (din + dout) bytes of input and output, far above
the card's ridge of ~295 flop/byte, so the tensor-core rate bounds it;
chain_wgrad alone reads its stacks (2 * N * sum(din + dout) bytes) for
2 * N * sum(din * dout) flops, near the ridge. The tangent chains multiply
the hidden layers' work by 1 + K.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from multimodalstudio_tpu_torch.ops.kernels import build

SKIP_SCALE = 1.0 / math.sqrt(2.0)
ACTIVATIONS = {"None": 0, "ReLU": 1, "SoftplusQuad": 2}

PACK_KERNEL = build.register(
    "fused_chain_pack",
    source="multimodalstudio_tpu_torch/csrc/fused_chain.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:1070",
)
KERNEL = build.register(
    "fused_chain",
    source="multimodalstudio_tpu_torch/csrc/fused_chain.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:265",
)
BWD_KERNEL = build.register(
    "fused_chain_bwd",
    source="multimodalstudio_tpu_torch/csrc/fused_chain.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:607",
)
WGRAD_KERNEL = build.register(
    "chain_wgrad",
    source="multimodalstudio_tpu_torch/csrc/fused_chain.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:748",
)
TANGENT_KERNEL = build.register(
    "fused_chain_tangents",
    source="multimodalstudio_tpu_torch/csrc/fused_mlp.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:265",
)
TANGENT_BWD_KERNEL = build.register(
    "fused_chain_tangents_bwd",
    source="multimodalstudio_tpu_torch/csrc/fused_mlp.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:607",
)
TANGENT_WGRAD_KERNEL = build.register(  # chain_wgrad on K1t's stacks
    "fused_chain_tangents_wgrad",
    source="multimodalstudio_tpu_torch/csrc/fused_chain.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:732",
)
MAX_TANGENTS = 3  # a 64-row tile holds the primal rows and at most 3 tangent rows per sample


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and back to float32."""
    return x.to(torch.bfloat16).float()


def act_pair(activation: str, beta: float):
    """(act, act') of a chain's hidden activation, evaluated in f32
    (fused_mlp.py:122-147)."""
    if activation == "None":
        return (lambda z: z), (lambda z: torch.ones_like(z))
    if activation == "ReLU":
        return torch.relu, (lambda z: (z > 0).float())
    if activation == "SoftplusQuad":
        a = 2.0 / beta

        def f(z):
            return torch.where(z.abs() < a, (z + a) * (z + a) * (0.25 / a), torch.relu(z))

        def df(z):
            return torch.where(z.abs() < a, (z + a) * (0.5 / a), (z > 0).float())

        return f, df
    raise ValueError(f"unsupported fused activation {activation}")


def ddf_of(activation: str, beta: float):
    """act'' of the hidden activation, or None where it is 0 everywhere
    (fused_mlp.py::_act_triple): SoftplusQuad's is 1/(2a) on |z| < a."""
    if activation != "SoftplusQuad":
        return None
    a = 2.0 / beta
    return lambda z: torch.where(z.abs() < a, torch.full_like(z, 0.5 / a), torch.zeros_like(z))


# The plain chain pieces the kernels' plain versions share, at the kernels'
# cast points (chain_reference :1263-1302, _adj_sweep :327-359, _bwd_kernel
# :645-789). x0 is the chain input as bf16 values in f32; a skip layer's
# weight rows are [h (hidden) | x0].


def layer_input(l: int, x0: torch.Tensor, h: torch.Tensor, skip) -> torch.Tensor:
    """Layer l's input from the previous layer's bf16 output h (x0 for
    layer 0): concat(h, x0) / sqrt(2) rounded to bf16 at a skip layer."""
    if l in skip:
        return bf16_round(torch.cat([h, x0], dim=-1) * SKIP_SCALE)
    return h


def chain_forward(x0, weights, biases, skip, activation, beta):
    """(the last layer's z [N, D_out] in f32, the bf16-rounded hidden
    pre-activations z_0..z_{L-2})."""
    f, _ = act_pair(activation, beta)
    h, zs = x0, []
    for l in range(len(weights) - 1):
        z = layer_input(l, x0, h, skip) @ bf16_round(weights[l].float()) + biases[l].float()
        zs.append(bf16_round(z))
        h = bf16_round(f(z))
    hin = layer_input(len(weights) - 1, x0, h, skip)
    return hin @ bf16_round(weights[-1].float()) + biases[-1].float(), zs


def adjoint_sweep(x0, zs, weights, skip, activation, beta, channel=0):
    """One reverse sweep from output column `channel`: v = e_c; s = bf16(v) W_l^T,
    a skip layer's s split into its x0 part (scaled, added to adj) and its h
    part (scaled); v = s * act'(z_{l-1}). Returns (adj = d y_c / d x0
    [N, D_in] f32, the h part of s of each layer l >= 1 as ss[l-1],
    bf16-rounded)."""
    _, df = act_pair(activation, beta)
    d_in = x0.shape[1]
    v = x0.new_zeros(x0.shape[0], weights[-1].shape[1])
    v[:, channel] = 1.0
    adj = 0.0
    ss: List[torch.Tensor] = [None] * (len(weights) - 1)
    for l in reversed(range(len(weights))):
        s = bf16_round(v) @ bf16_round(weights[l].float()).T
        if l in skip:
            hw = weights[l].shape[0] - d_in
            adj = adj + s[:, hw:] * SKIP_SCALE
            s = s[:, :hw] * SKIP_SCALE
        if l == 0:
            adj = adj + s
        else:
            ss[l - 1] = bf16_round(s)
            v = s * df(zs[l - 1].float())
    return adj, ss


def ga_forward(ga, zs, ss, weights, skip, activation, beta, channel=0, qs=None, stacks=None):
    """The forward chain of the adjoint's cotangent ga [N, D_in] f32 in a
    reverse-over-reverse backward (_bwd_adj_kernel :489-524): qin_0 = ga, ga
    re-injected at a skip like x0; v_l = s_l * act'(z_l) (e_c at the last
    layer); gW_l = bf16(qin_l)^T bf16(v_l); m = bf16(qin_l) W_l;
    e_l = bf16(m * s_l * act''(z_l)); q = m * act'(z_l). zs, ss: the bf16
    pre-activations and adjoint rows. Returns (gW list, the injections e_l
    or None where act'' is 0); a list `qs` receives bf16(q) of each hidden
    layer (the split backward's q stack, slot_fused.py:895-896), a list
    `stacks` the operands (qin_l, bf16(v_l)) of each layer's gW."""
    _, df = act_pair(activation, beta)
    ddf = ddf_of(activation, beta)
    zs, ss = [z.float() for z in zs], [s.float() for s in ss]
    n_layers, n = len(weights), ga.shape[0]
    q, gws, inject = ga, [], []
    for l in range(n_layers):
        qb = bf16_round(torch.cat([q, ga], dim=-1) * SKIP_SCALE if l in skip else q)
        if l == n_layers - 1:
            v = qb.new_zeros(n, weights[l].shape[1])
            v[:, channel] = 1.0
        else:
            v = ss[l] * df(zs[l])
        gws.append(qb.T @ bf16_round(v))
        if stacks is not None:
            stacks.append((qb, bf16_round(v)))
        if l < n_layers - 1:
            m = qb @ bf16_round(weights[l].float())
            if ddf is not None:
                inject.append(bf16_round(m * ss[l] * ddf(zs[l])))
            q = m * df(zs[l])
            if qs is not None:
                qs.append(bf16_round(q))
    return gws, (inject if ddf is not None else None)


def reverse_sweep(x0, zs, gy, weights, skip, activation, beta, inject=None, gw_extra=None,
                  gzs=None, stacks=None):
    """The chain's reverse sweep from the last layer's cotangent gy (f32):
    gz_{L-1} = gy; gz_l = gh * act'(z_l) (+ inject[l]); gW_l = hin_l^T
    bf16(gz_l) (+ gw_extra[l]); gb_l = sum of the f32 gz_l; gh = bf16(gz_l)
    W_l^T, a skip layer's x0 part added to gx0. zs: the bf16 hidden
    pre-activations. Returns (cotangent of x0 [N, D_in] f32, gW list, gb
    list); a list `gzs` receives bf16(gz_l) of each hidden layer, first
    layer first (the split backward's gz stack, slot_fused.py:910), a list
    `stacks` the operands (hin_l, bf16(gz_l)) of every layer's gW, first
    layer first."""
    f, df = act_pair(activation, beta)
    zs = [z.float() for z in zs]
    n_layers, d_in = len(weights), x0.shape[1]
    gws: List[torch.Tensor] = [None] * n_layers
    gbs: List[torch.Tensor] = [None] * n_layers
    gh, gx0 = gy, torch.zeros_like(x0)
    for l in reversed(range(n_layers)):
        gz = gh if l == n_layers - 1 else gh * df(zs[l])
        if inject is not None and l < n_layers - 1:
            gz = gz + inject[l]
        gzb = bf16_round(gz)
        if gzs is not None and l < n_layers - 1:
            gzs.insert(0, gzb)
        hin = layer_input(l, x0, x0 if l == 0 else bf16_round(f(zs[l - 1])), skip)
        if stacks is not None:
            stacks.insert(0, (hin, gzb))
        gws[l] = hin.T @ gzb if gw_extra is None else gw_extra[l] + hin.T @ gzb
        gbs[l] = gz.sum(0)
        ghp = gzb @ bf16_round(weights[l].float()).T
        if l in skip:
            hw = weights[l].shape[0] - d_in
            gh = ghp[:, :hw] * SKIP_SCALE
            gx0 = gx0 + ghp[:, hw:] * SKIP_SCALE
        else:
            gh = ghp
    return gh + gx0, gws, gbs


def tangent_forward(x0, t0, weights, biases, skip, activation, beta):
    """The chain and its K forward tangents at the forward kernel's cast
    points (_fwd_kernel :277-301): x0 [N, D_in] and t0 [K, N, D_in] as bf16
    values in f32. Returns (the last layer's z [N, D_out] f32, its tangents
    u [K, N, D_out] f32)."""
    f, df = act_pair(activation, beta)
    h, t = x0, t0
    for l in range(len(weights)):
        h, t = layer_input(l, x0, h, skip), layer_input(l, t0, t, skip)
        w = bf16_round(weights[l].float())
        z, u = h @ w + biases[l].float(), t @ w
        if l < len(weights) - 1:
            h, t = bf16_round(f(z)), bf16_round(u * df(z))
    return z, u


def tangent_output(u: torch.Tensor, channel: Optional[int]) -> torch.Tensor:
    """ty from the last layer's f32 tangents u [K, N, D_out]: column
    `channel` as [N, K] f32, or with no channel all of u as bf16."""
    return u.to(torch.bfloat16) if channel is None else u[:, :, channel].T.contiguous()


def fused_chain_plain(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    *,
    skip: Tuple[int, ...] = (),
    activation: str = "ReLU",
    beta: float = 100.0,
    tangents: Optional[torch.Tensor] = None,
    tangent_out_channel: Optional[int] = None,
):
    """Plain PyTorch version of K1: bf16 emulated by rounding, f32 math.

    x [N, D_in]; weights[l] [din_l, dout_l]; biases[l] [dout_l]. Returns
    y [N, D_out] bf16, and for tangents [K, N, D_in] (K1t) also ty:
    [K, N, D_out] bf16, or [N, K] f32 with tangent_out_channel."""
    x0 = bf16_round(x.float())
    if tangents is None:
        return chain_forward(x0, weights, biases, skip, activation, beta)[0].to(torch.bfloat16)
    z, u = tangent_forward(x0, bf16_round(tangents.float()), weights, biases, skip, activation,
                           beta)
    return z.to(torch.bfloat16), tangent_output(u, tangent_out_channel)


def fused_chain_bwd_plain(
    x: torch.Tensor,
    gy: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    *,
    skip: Tuple[int, ...] = (),
    activation: str = "ReLU",
    beta: float = 100.0,
):
    """Plain PyTorch version of K1's backward (_bwd_kernel :607-791).

    x [N, D_in], gy [N, D_out] (rounded to bf16). Returns gx [N, D_in] bf16,
    gW[l] [din_l, dout_l] f32 and gb[l] [dout_l] f32."""
    skip = tuple(sorted(skip))
    x0 = bf16_round(x.float())
    _, zs = chain_forward(x0, weights, biases, skip, activation, beta)
    gx, gws, gbs = reverse_sweep(x0, zs, bf16_round(gy.float()), weights, skip, activation, beta)
    return gx.to(torch.bfloat16), gws, gbs


def chain_bwd_tile_plain(x, gy, weights, biases, *, skip=(), activation="ReLU", beta=100.0):
    """Plain version of K1's per-tile backward pass (csrc/fused_chain.cu
    k1_bwd): the forward recompute and the reverse sweep gh = bf16(gz) W^T,
    without the weight gradients. x [N, D_in], gy [N, D_out] (rounded to
    bf16). Returns (gx [N, D_in] bf16, the layer inputs hin_l [N, din_l] and
    cotangents gz_l [N, dout_l] as bf16 values in f32, gz_{L-1} = bf16(gy);
    gb list f32)."""
    skip = tuple(sorted(skip))
    f, df = act_pair(activation, beta)
    x0 = bf16_round(x.float())
    _, zs = chain_forward(x0, weights, biases, skip, activation, beta)
    n_layers, d_in = len(weights), x0.shape[1]
    hins = [layer_input(l, x0, x0 if l == 0 else bf16_round(f(zs[l - 1])), skip)
            for l in range(n_layers)]
    gzs: List[torch.Tensor] = [None] * n_layers
    gbs: List[torch.Tensor] = [None] * n_layers
    gh, gx0 = bf16_round(gy.float()), torch.zeros_like(x0)
    for l in reversed(range(n_layers)):
        gz = gh if l == n_layers - 1 else gh * df(zs[l])
        gzs[l], gbs[l] = bf16_round(gz), gz.sum(0)
        ghp = gzs[l] @ bf16_round(weights[l].float()).T
        if l in skip:
            hw = weights[l].shape[0] - d_in
            gh = ghp[:, :hw] * SKIP_SCALE
            gx0 = gx0 + ghp[:, hw:] * SKIP_SCALE
        else:
            gh = ghp
    return (gh + gx0).to(torch.bfloat16), hins, gzs, gbs


def chain_wgrad_plain(hins: Sequence[torch.Tensor], gzs: Sequence[torch.Tensor]):
    """Plain version of chain_wgrad: gW_l = hin_l^T gz_l of every layer, f32."""
    return [h.float().T @ g.float() for h, g in zip(hins, gzs)]


def tangent_bwd_tile_plain(x0, t0, gh, gt, weights, biases, skip, activation, beta):
    """Plain version of the tangent backward's per-tile pass (csrc/fused_mlp.cu
    tan_bwd_pass_kernel), tangent_backward's arguments: the recompute and the
    reverse sweep without the weight gradients. Returns (gx0 [N, D_in] f32,
    gtx0 [K, N, D_in] f32, the stacks of each layer's gW operands as rows:
    Hin_l = [hin_l; tin_l of every tangent] [(1 + K) N, din_l] and G_l =
    [bf16(gz_l); bf16(gu_l) of every tangent], gb list f32); chain_wgrad_plain
    of the stacks gives gW."""
    stacks = []
    gx0, gtx0, _, gbs = tangent_backward(x0, t0, gh, gt, weights, biases, skip, activation, beta,
                                         stacks)
    return gx0, gtx0, [h for h, _ in stacks], [g for _, g in stacks], gbs


def tangent_backward(x0, t0, gh, gt, weights, biases, skip, activation, beta, stacks=None):
    """The backward of the chain with K forward tangents (_bwd_kernel
    :636-789) at its cast points: x0 [N, D_in] and t0 [K, N, D_in] as bf16
    values, the last layer's cotangents gh [N, D_out] and gt [K, N, D_out]
    (f32, as they enter the products rounded to bf16). Recomputes z and u
    stored in bf16, then per layer gz = gh act'(z) + (sum_k gt_k u_k)
    act''(z), gu = gt act'(z), gW = hin^T bf16(gz) + sum_k tin_k^T
    bf16(gu_k), gb = sum gz, gh = bf16(gz) W^T, gt = bf16(gu) W^T. Returns
    (gx0 [N, D_in] f32, gtx0 [K, N, D_in] f32, gW list, gb list); a list
    `stacks` receives each layer's gW operands as rows, ([hin; tin_k...],
    [bf16(gz); bf16(gu_k)...]), first layer first."""
    f, df = act_pair(activation, beta)
    ddf = ddf_of(activation, beta)
    n_layers, d_in = len(weights), x0.shape[-1]
    wb = [bf16_round(w.float()) for w in weights]
    zs, us = [], []
    h, t = x0, t0
    for l in range(n_layers - 1):
        h, t = layer_input(l, x0, h, skip), layer_input(l, t0, t, skip)
        z = h @ wb[l] + biases[l].float()
        zb, ub = bf16_round(z), bf16_round(t @ wb[l])
        zs.append(zb)
        us.append(ub)
        h, t = bf16_round(f(z)), bf16_round(ub * df(zb))
    gws: List[torch.Tensor] = [None] * n_layers
    gbs: List[torch.Tensor] = [None] * n_layers
    gx0, gtx0 = torch.zeros_like(x0), torch.zeros_like(t0)
    for l in reversed(range(n_layers)):
        gz, gu = gh, gt
        if l < n_layers - 1:
            d1 = df(zs[l])
            gz, gu = gh * d1, gt * d1
            if ddf is not None:
                gz = gz + (gt * us[l]).sum(0) * ddf(zs[l])
        if l == 0:
            hin, tin = x0, t0
        else:
            hin = bf16_round(f(zs[l - 1]))
            tin = bf16_round(us[l - 1] * df(zs[l - 1]))
        hin, tin = layer_input(l, x0, hin, skip), layer_input(l, t0, tin, skip)
        gzb, gub = bf16_round(gz), bf16_round(gu)
        gws[l] = hin.T @ gzb + tin.reshape(-1, tin.shape[-1]).T @ gub.reshape(-1, gub.shape[-1])
        if stacks is not None:
            stacks.insert(0, (torch.cat([hin, tin.reshape(-1, tin.shape[-1])]),
                              torch.cat([gzb, gub.reshape(-1, gub.shape[-1])])))
        gbs[l] = gz.sum(0)
        ghp, gtp = gzb @ wb[l].T, gub @ wb[l].T
        if l in skip:
            hw = weights[l].shape[0] - d_in
            gh, gt = ghp[:, :hw] * SKIP_SCALE, gtp[..., :hw] * SKIP_SCALE
            gx0 = gx0 + ghp[:, hw:] * SKIP_SCALE
            gtx0 = gtx0 + gtp[..., hw:] * SKIP_SCALE
        else:
            gh, gt = ghp, gtp
    return gh + gx0, gt + gtx0, gws, gbs


def last_tangent_cotangent(gty: torch.Tensor, channel: Optional[int], k: int, n: int,
                      d_out: int) -> torch.Tensor:
    """The last layer's tangent cotangent [K, N, D_out] f32 from ty's: with a
    channel, gty [N, K] f32 scattered into column c (:697-712); without,
    gty [K, N, D_out] rounded to bf16."""
    if channel is None:
        return bf16_round(gty.float())
    gt = gty.new_zeros((k, n, d_out), dtype=torch.float32)
    gt[:, :, channel] = gty.float().T
    return gt


def fused_chain_tangent_bwd_plain(x, tangents, gy, gty, weights, biases, *, skip=(),
                                  activation="ReLU", beta=100.0, tangent_out_channel=None):
    """Plain PyTorch version of K1t's backward (_bwd_kernel :607-792 with
    n_tangents = K): x [N, D_in], tangents [K, N, D_in], gy [N, D_out]
    (rounded to bf16), gty [N, K] f32 with tangent_out_channel or [K, N,
    D_out] (rounded to bf16) without. Returns (gx [N, D_in] bf16, gtx [K, N,
    D_in] bf16, gW list f32, gb list f32)."""
    skip = tuple(sorted(skip))
    k, n = tangents.shape[0], x.shape[0]
    gt = last_tangent_cotangent(gty, tangent_out_channel, k, n, weights[-1].shape[1])
    gx, gtx, gws, gbs = tangent_backward(bf16_round(x.float()), bf16_round(tangents.float()),
                                         bf16_round(gy.float()), gt, weights, biases, skip,
                                         activation, beta)
    return gx.to(torch.bfloat16), gtx.to(torch.bfloat16), gws, gbs


def fused_chain_tangent_bwd_tile_plain(x, tangents, gy, gty, weights, biases, *, skip=(),
                                       activation="ReLU", beta=100.0, tangent_out_channel=None):
    """Plain version of K1t's per-tile backward pass, fused_chain_tangent_bwd_plain's
    arguments. Returns (gx bf16, gtx bf16, the Hin and G stacks of every layer as
    rows, gb list f32); chain_wgrad_plain of the stacks gives gW."""
    skip = tuple(sorted(skip))
    k, n = tangents.shape[0], x.shape[0]
    gt = last_tangent_cotangent(gty, tangent_out_channel, k, n, weights[-1].shape[1])
    gx, gtx, hins, gzs, gbs = tangent_bwd_tile_plain(
        bf16_round(x.float()), bf16_round(tangents.float()), bf16_round(gy.float()), gt, weights,
        biases, skip, activation, beta)
    return gx.to(torch.bfloat16), gtx.to(torch.bfloat16), hins, gzs, gbs


def rup16(n: int) -> int:
    return (n + 15) // 16 * 16


def chain_geometry(d_in: int, weights: Sequence[torch.Tensor], skip: Tuple[int, ...]):
    """Padded (multiple of 16) per-layer (in, out) widths; checks that the
    hidden layers share one width. Returns (in_dims, out_dims, p0, hidden)."""
    hidden = weights[0].shape[1]
    if hidden % 16:
        raise ValueError(f"hidden width {hidden} must be a multiple of 16")
    p0 = rup16(d_in)
    in_dims, out_dims = [], []
    for l, w in enumerate(weights):
        if l == 0:
            want, din = d_in, p0
        elif l in skip:
            want, din = hidden + d_in, hidden + p0
        else:
            want, din = hidden, hidden
        if w.shape[0] != want:
            raise ValueError(f"layer {l} input width {w.shape[0]} != {want}")
        if l < len(weights) - 1 and w.shape[1] != hidden:
            raise ValueError(f"layer {l} output width {w.shape[1]} != hidden {hidden}")
        in_dims.append(din)
        out_dims.append(rup16(w.shape[1]))
    return in_dims, out_dims, p0, hidden


def pack_chain(
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    in_dims: List[int],
    out_dims: List[int],
    hidden: int,
    skip: Tuple[int, ...],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-padded weights as one bf16 buffer (row-major [din, dout] per
    layer, back to back) and biases as one f32 buffer, the layout of the
    tangent and slot kernels. A skip layer's rows are [h (hidden) | x0
    (padded input width)], so its weight lands in its first rows as a plain
    layer's does."""
    ws, bs = [], []
    for l, (w, b) in enumerate(zip(weights, biases)):
        wp = w.new_zeros((in_dims[l], out_dims[l]), dtype=torch.float32)
        wp[: w.shape[0], : w.shape[1]] = w
        ws.append(wp.reshape(-1))
        bp = b.new_zeros(out_dims[l], dtype=torch.float32)
        bp[: b.shape[0]] = b
        bs.append(bp)
    return torch.cat(ws).to(torch.bfloat16).contiguous(), torch.cat(bs).contiguous()


def unpack_grads(gw: torch.Tensor, gb: torch.Tensor, weights, in_dims, out_dims, hidden, skip):
    """Per-layer gW [din_l, dout_l] and gb [dout_l] as views of the packed,
    padded f32 gradient buffers (the layout of pack_chain)."""
    gws, gbs = [], []
    wo = bo = 0
    for l, w in enumerate(weights):
        g = gw[wo : wo + in_dims[l] * out_dims[l]].view(in_dims[l], out_dims[l])
        gws.append(g[: w.shape[0], : w.shape[1]])
        gbs.append(gb[bo : bo + w.shape[1]])
        wo += in_dims[l] * out_dims[l]
        bo += out_dims[l]
    return gws, gbs


# ------------------------------------------------------------- K1 on the card
#
# The layout of csrc/fused_chain.cu. Activation columns come in 64-wide
# images: [h (H) | x0 (P0 = ceil64(d_in))]; hidden widths are 64, 128, 256,
# 384 or 512 (a hidden layer's product runs as at most two wgmma pieces of at
# most 256 columns, the first written to a 256-column side image until the
# second's product retired). A product's output width (padded to 16) is cut
# into pieces of 256 columns, then 128, 64, 32, 16. An image is R rows of 64 bf16 (one 64-deep k-chunk), its 16-byte units
# permuted by unit ^ (row % 8) (the 128-byte swizzle of wgmma).

MAX_PIECES = 8  # csrc/fused_chain.cu MAXPIECES
HIDDEN_WIDTHS = (64, 128, 256, 384, 512)


def ceil64(n: int) -> int:
    return (n + 63) // 64 * 64


def pieces(width: int) -> List[Tuple[int, int]]:
    """(offset, columns) of each piece of a width (a multiple of 16)."""
    out, off = [], 0
    for _ in range(width // 256):
        out.append((off, 256))
        off += 256
    for np_ in (128, 64, 32, 16):
        if width % 256 & np_:
            out.append((off, np_))
            off += np_
    return out


@dataclasses.dataclass(frozen=True)
class ChainLayout:
    """Where csrc/fused_chain.cu keeps each layer of one chain: padded and
    true widths, element offsets of its forward and backward images, of its
    gW and gb, and its columns in the hin and gz stacks (per tile)."""

    d_in: int
    d_out: int
    hidden: int
    p0: int  # ceil64(d_in)
    skip: Tuple[int, ...]
    din_pad: Tuple[int, ...]
    din_true: Tuple[int, ...]
    dout_pad: Tuple[int, ...]
    dout_true: Tuple[int, ...]
    fw_off: Tuple[int, ...]  # [L + 1]
    bw_off: Tuple[int, ...]  # [L + 1], layer L - 1 first; [L] = total
    gw_off: Tuple[int, ...]  # [L + 1]
    b_off: Tuple[int, ...]  # [L + 1]
    gb_off: Tuple[int, ...]  # [L + 1]
    hs_w: Tuple[int, ...]  # [L + 1]
    gs_w: Tuple[int, ...]  # [L + 1]
    sm: Tuple[int, ...]  # stack tiles per row tile of each layer

    @property
    def n_layers(self) -> int:
        return len(self.din_pad)

    def gcols(self, l: int) -> int:
        return ceil64(self.dout_pad[l])

    @property
    def gw_sizes(self) -> Tuple[int, ...]:
        return tuple(a * b for a, b in zip(self.din_true, self.dout_true))

    def bwd_pieces(self, l: int) -> List[Tuple[int, int]]:
        """Pieces of layer l's backward product gh = gz W^T over its input
        columns: a skip layer's x0 part first (at column H), then its h part."""
        if l == 0:
            return pieces(self.p0)
        h = pieces(self.hidden)
        return [(self.hidden + o, n) for o, n in pieces(self.p0)] + h if l in self.skip else h


def chain_layout(d_in: int, shapes: Sequence[Tuple[int, int]], skip: Tuple[int, ...],
                 adjoint: bool = False) -> ChainLayout:
    """The layout of one chain ([din, dout] per layer), or ValueError naming
    the bound the card's kernels set. `adjoint`: the stacks of the adjoint
    backward (csrc/sdf_chain.cu), where every layer below the last stacks its
    ga-forward operands (qin_l, v_l) under its reverse-sweep ones (hin_l,
    gz_l), two stack tiles per row tile."""
    n_layers = len(shapes)
    if not 2 <= n_layers <= build.MAX_LAYERS:
        raise ValueError(f"fused_chain: the card's kernel takes chains of 2 to {build.MAX_LAYERS} "
                         f"layers, not {n_layers}")
    if 0 in skip:
        raise ValueError("fused_chain: layer 0 cannot be a skip layer")
    hidden, d_out = shapes[0][1], shapes[-1][1]
    if hidden not in HIDDEN_WIDTHS:
        raise ValueError(f"fused_chain: hidden width {hidden}; the card's kernels take "
                         f"{HIDDEN_WIDTHS}: a hidden layer runs as at most two pieces of 256 "
                         "columns, the first held in one 256-column side image beside the 64-row "
                         "tile's activation images, all within the 232,448 bytes of shared "
                         "memory a CTA has")
    p0 = ceil64(d_in)
    din_pad, din_true = [], []
    for l, (din, dout) in enumerate(shapes):
        want = d_in if l == 0 else hidden + (d_in if l in skip else 0)
        if din != want:
            raise ValueError(f"layer {l} input width {din} != {want}")
        if l < n_layers - 1 and dout != hidden:
            raise ValueError(f"layer {l} output width {dout} != hidden {hidden}")
        din_pad.append(p0 if l == 0 else hidden + (p0 if l in skip else 0))
        din_true.append(din)
    dout_true = [hidden] * (n_layers - 1) + [d_out]
    dout_pad = [hidden] * (n_layers - 1) + [rup16(d_out)]
    if len(pieces(dout_pad[-1])) > MAX_PIECES or len(pieces(p0)) + 1 > MAX_PIECES:
        raise ValueError(f"fused_chain: widths {d_in} in, {d_out} out need more than {MAX_PIECES} "
                         "pieces of at most 256 columns")
    cum = lambda xs: tuple(sum(xs[:i]) for i in range(len(xs) + 1))  # noqa: E731
    sm = [2 if adjoint and l < n_layers - 1 else 1 for l in range(n_layers)]
    layout = ChainLayout(
        d_in=d_in, d_out=d_out, hidden=hidden, p0=p0, skip=tuple(skip),
        din_pad=tuple(din_pad), din_true=tuple(din_true), dout_pad=tuple(dout_pad),
        dout_true=tuple(dout_true),
        fw_off=cum([a * b for a, b in zip(din_pad, dout_pad)]), bw_off=(),
        gw_off=cum([a * b for a, b in zip(din_true, dout_true)]), b_off=cum(dout_pad),
        gb_off=cum(dout_true), hs_w=cum([m * d for m, d in zip(sm, din_pad)]),
        gs_w=cum([m * ceil64(d) for m, d in zip(sm, dout_pad)]), sm=tuple(sm))
    sizes = [sum(n for _, n in layout.bwd_pieces(l)) * layout.gcols(l) for l in range(n_layers)]
    bw_off, off = [0] * (n_layers + 1), 0
    for l in reversed(range(n_layers)):
        bw_off[l] = off
        off += sizes[l]
    bw_off[n_layers] = off
    return dataclasses.replace(layout, bw_off=tuple(bw_off))


def swizzle_units(m: torch.Tensor) -> torch.Tensor:
    """Rows of 64 values with their 8 units of 8 permuted by unit ^ (row % 8):
    a [R, 64] matrix to its image, or an image back (the permutation is its
    own inverse)."""
    r = m.shape[0]
    slots = torch.arange(8, device=m.device) ^ (torch.arange(r, device=m.device) % 8)[:, None]
    return m.reshape(r, 8, 8).gather(1, slots[:, :, None].expand(r, 8, 8)).reshape(r, 64)


def _padded(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    out = w.new_zeros((rows, cols), dtype=torch.float32)
    out[: w.shape[0], : w.shape[1]] = w.float()
    return out


def pack_plain(layout: ChainLayout, weights, biases, backward: bool = True):
    """Plain version of the pack kernel: (forward images, backward images or
    None, both bf16, and the padded f32 biases), element for element as
    csrc/fused_chain.cu k1_pack writes them."""
    fw, bw = [], []
    for l, w in enumerate(weights):
        wp = _padded(w, layout.din_pad[l], layout.dout_pad[l])
        for off, np_ in pieces(layout.dout_pad[l]):
            for kc in range(layout.din_pad[l] // 64):
                fw.append(swizzle_units(wp[kc * 64:(kc + 1) * 64, off:off + np_].T))
    for l in reversed(range(len(weights))):
        wp = _padded(weights[l], layout.din_pad[l], layout.gcols(l))
        for off, np_ in layout.bwd_pieces(l):
            for kc in range(layout.gcols(l) // 64):
                bw.append(swizzle_units(wp[off:off + np_, kc * 64:(kc + 1) * 64]))
    flat = lambda ms: torch.cat([m.reshape(-1) for m in ms]).to(torch.bfloat16)  # noqa: E731
    bpk = torch.cat([_padded(b[None], 1, n)[0] for b, n in zip(biases, layout.dout_pad)])
    return flat(fw), flat(bw) if backward else None, bpk


def stack_rows(images: torch.Tensor, tiles: int, cols: int) -> torch.Tensor:
    """A stack of the per-tile pass (per tile, cols / 64 images of 64 rows,
    the activation images of shared memory) as rows [tiles * 64, cols]."""
    m = swizzle_units(images[: tiles * 64 * cols].reshape(tiles * cols, 64))
    return m.reshape(tiles, cols // 64, 64, 64).transpose(1, 2).reshape(tiles * 64, cols)


_MAXL = build.MAX_LAYERS


class _Geom(ctypes.Structure):
    """csrc/fused_chain.cu struct Geom."""

    _fields_ = [
        ("fw_off", ctypes.c_longlong * (_MAXL + 1)), ("bw_off", ctypes.c_longlong * (_MAXL + 1)),
        ("gw_off", ctypes.c_longlong * _MAXL), ("din_pad", ctypes.c_int * _MAXL),
        ("din_true", ctypes.c_int * _MAXL), ("dout_pad", ctypes.c_int * _MAXL),
        ("dout_true", ctypes.c_int * _MAXL), ("b_off", ctypes.c_int * _MAXL),
        ("gb_off", ctypes.c_int * _MAXL), ("hs_w", ctypes.c_int * (_MAXL + 1)),
        ("gs_w", ctypes.c_int * (_MAXL + 1)), ("sm", ctypes.c_int * _MAXL),
        ("L", ctypes.c_int), ("H", ctypes.c_int),
        ("P0", ctypes.c_int), ("d_in", ctypes.c_int), ("d_out", ctypes.c_int),
        ("skip_mask", ctypes.c_int), ("act", ctypes.c_int), ("quad_a", ctypes.c_float),
    ]


class _PackArgs(ctypes.Structure):
    """csrc/fused_chain.cu struct PackArgs."""

    _fields_ = [("w", ctypes.c_void_p * _MAXL), ("b", ctypes.c_void_p * _MAXL),
                ("ws0", ctypes.c_longlong * _MAXL), ("ws1", ctypes.c_longlong * _MAXL)]


_CHAINS: Dict[tuple, Tuple[ChainLayout, _Geom]] = {}
_ENTRY = {  # entry points on K1's layout: library, argument types, result type
    "mms_k1_pack": ("fused_chain", ("ptr",) * 6, ctypes.c_int),
    "mms_k1_fwd": ("fused_chain", ("ptr", "ptr", "int", "int", "ptr", "ptr", "ptr", "ptr"),
                   ctypes.c_int),
    "mms_k1_bwd_bytes": ("fused_chain", ("ptr", "int"), ctypes.c_longlong),
    "mms_k1_bwd": ("fused_chain", ("ptr", "ptr", "int", "ptr", "int", "int") + ("ptr",) * 7,
                   ctypes.c_int),
    "mms_k1_wgrad": ("fused_chain", ("ptr", "int", "ptr", "ptr", "ptr", "ptr"), ctypes.c_int),
    # the tangent backward's pass (csrc/fused_mlp.cu)
    "mms_tangent_bwd_bytes": ("fused_mlp", ("ptr", "int", "int"), ctypes.c_longlong),
    "mms_chain_tangent_bwd": ("fused_mlp", ("ptr", "ptr", "ptr", "int", "int", "ptr", "ptr", "int")
                              + ("ptr",) * 8, ctypes.c_int),
    "mms_sdf_chain_jvp_bwd": ("fused_mlp", ("ptr", "ptr", "int", "int", "ptr", "ptr", "ptr", "int")
                              + ("ptr",) * 8, ctypes.c_int),
    # K2's forward on K1's forward (csrc/slot_value.cu)
    "mms_slot_value_fwd": ("slot_value", ("ptr", "ptr", "ptr", "int", "ptr", "int") + ("ptr",) * 6
                           + ("int", "ptr"), ctypes.c_int),
    # the adjoint backward's pass (csrc/sdf_chain.cu)
    "mms_adj_bwd_bytes": ("sdf_chain", ("ptr", "int"), ctypes.c_longlong),
    "mms_sdf_chain_bwd": ("sdf_chain", ("ptr", "ptr", "int", "int", "ptr", "ptr", "ptr", "int")
                          + ("ptr",) * 10, ctypes.c_int),
    "mms_chain_adj_bwd": ("sdf_chain", ("ptr", "ptr", "int", "int") + ("ptr",) * 11,
                          ctypes.c_int),
}
_ENTRIES: Dict[str, object] = {}


def _stream(dev) -> int:
    """The current CUDA stream of a device, as the kernels' launch argument."""
    return torch.cuda.current_stream(dev).cuda_stream


def entry(name: str):
    """A C entry point that takes K1's Geom (fused_chain, and the backward
    passes of fused_mlp and sdf_chain), looked up once."""
    fn = _ENTRIES.get(name)
    if fn is None:
        library, types, restype = _ENTRY[name]
        fn = _ENTRIES[name] = build.function(library, name, *types, restype=restype)
    return fn



def chain_of(d_in: int, weights, skip, activation: str, beta: float,
             adjoint: bool = False) -> Tuple[ChainLayout, _Geom]:
    """The layout and the kernels' Geom of a chain, built once per shape."""
    key = (d_in, tuple(w.shape for w in weights), skip, activation, beta, adjoint)
    hit = _CHAINS.get(key)
    if hit is None:
        layout = chain_layout(d_in, [tuple(w.shape) for w in weights], skip, adjoint)
        g = _Geom()
        bw_total = layout.bw_off[-1]
        for name in ("din_pad", "din_true", "dout_pad", "dout_true", "b_off", "gb_off", "gw_off",
                     "sm"):
            getattr(g, name)[: layout.n_layers] = getattr(layout, name)[: layout.n_layers]
        for name in ("fw_off", "hs_w", "gs_w"):
            getattr(g, name)[: layout.n_layers + 1] = getattr(layout, name)
        g.bw_off[: layout.n_layers] = layout.bw_off[: layout.n_layers]
        g.bw_off[_MAXL] = bw_total
        g.L, g.H, g.P0, g.d_in, g.d_out = (layout.n_layers, layout.hidden, layout.p0, d_in,
                                            layout.d_out)
        g.skip_mask = sum(1 << l for l in skip)
        g.act, g.quad_a = ACTIVATIONS[activation], 2.0 / beta
        hit = _CHAINS[key] = (layout, g)
    return hit



@dataclasses.dataclass
class Packed:
    """What the pack kernel wrote for one call: the forward images, the
    backward images (or None) and the padded biases, views of one buffer."""

    wfw: torch.Tensor
    wbw: Optional[torch.Tensor]
    bpk: torch.Tensor


def check_card(x: torch.Tensor, activation: str, n_layers: int, what: str = "fused_chain") -> None:
    """Raise unless x lies on the card and the chain is one the kernels take."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unsupported fused activation {activation}")
    build.check_layers(n_layers, what)


def _card_operand(t: torch.Tensor) -> torch.Tensor:
    """A contiguous, 16-byte aligned f32 or bf16 operand (the kernels read
    either, as 16-byte vectors)."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        t = t.float()
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_pack(layout: ChainLayout, geom: _Geom, weights, biases, backward: bool) -> Packed:
    """The pack kernel: forward (and backward) images and biases, one launch."""
    dev = weights[0].device
    fw_b, bw_b = 2 * layout.fw_off[-1], 2 * layout.bw_off[-1] if backward else 0
    buf = torch.empty(fw_b + bw_b + 4 * layout.b_off[-1], dtype=torch.uint8, device=dev)
    packed = Packed(buf[:fw_b].view(torch.bfloat16),
                    buf[fw_b:fw_b + bw_b].view(torch.bfloat16) if backward else None,
                    buf[fw_b + bw_b:].view(torch.float32))
    args = _PackArgs()
    ws = [w if w.dtype == torch.float32 else w.float() for w in weights]
    bs = [b if b.dtype == torch.float32 and b.is_contiguous() else b.float().contiguous()
          for b in biases]
    n_layers = len(ws)
    args.w[:n_layers] = [w.data_ptr() for w in ws]
    args.b[:n_layers] = [b.data_ptr() for b in bs]
    args.ws0[:n_layers] = [w.stride(0) for w in ws]
    args.ws1[:n_layers] = [w.stride(1) for w in ws]
    wbw = None if packed.wbw is None else packed.wbw.data_ptr()
    status = entry("mms_k1_pack")(ctypes.byref(geom), ctypes.byref(args), packed.wfw.data_ptr(),
                                   wbw, packed.bpk.data_ptr(), _stream(dev))
    build.check(status, "fused_chain pack")
    PACK_KERNEL.launches += 1
    return packed


def _fwd_launcher(geom: _Geom, x, n: int, packed: Packed, y):
    """The chain kernel's launch on prepared operands, as a closure
    (uncounted: its callers count)."""
    args = (ctypes.byref(geom), x.data_ptr(), int(x.dtype == torch.bfloat16), n,
            packed.wfw.data_ptr(), packed.bpk.data_ptr(), y.data_ptr(), _stream(x.device))
    return lambda: build.check(entry("mms_k1_fwd")(*args), "fused_chain")


def _launch_fwd(x, weights, biases, skip, activation, beta, backward_images=False):
    """K1's forward on the card: (y [N, D_out] bf16, the Packed images, or
    None for N = 0)."""
    check_card(x, activation, len(weights))
    layout, geom = chain_of(x.shape[1], weights, skip, activation, beta)
    n = x.shape[0]
    y = torch.empty((n, layout.d_out), dtype=torch.bfloat16, device=x.device)
    if n == 0:
        return y, None
    x = _card_operand(x)
    packed = _launch_pack(layout, geom, weights, biases, backward_images)
    _fwd_launcher(geom, x, n, packed, y)()
    KERNEL.launches += 1
    return y, packed


_SCRATCH_BYTES: Dict[tuple, int] = {}


def _scratch(bytes_entry: str, geom: _Geom, dev, *args) -> torch.Tensor:
    """A backward's device scratch (stacks and per-CTA slabs), its size from
    the library's entry point bytes_entry(geom, *args)."""
    key = (bytes_entry, id(geom), args)  # a Geom lives as long as the process (_CHAINS)
    size = _SCRATCH_BYTES.get(key)
    if size is None:
        size = int(entry(bytes_entry)(ctypes.byref(geom), *args))
        if size < 0:
            build.check(size, f"{bytes_entry}")
        if len(_SCRATCH_BYTES) > 1024:  # many batch sizes: start over
            _SCRATCH_BYTES.clear()
        _SCRATCH_BYTES[key] = size
    return torch.empty(size, dtype=torch.uint8, device=dev)


def _bwd_scratch(geom: _Geom, n: int, dev) -> torch.Tensor:
    """K1's backward scratch for n rows."""
    return _scratch("mms_k1_bwd_bytes", geom, dev, n)


def _bwd_launchers(geom: _Geom, x, gy, n: int, packed: Packed, gx, gw, gb, scratch):
    """The per-tile pass (gx in x's dtype, gb accumulated into gb, the hin
    and gz stacks into scratch) and chain_wgrad (gW of every layer from the
    stacks, accumulated into gw), as two closures (uncounted)."""
    g, st = ctypes.byref(geom), _stream(x.device)
    tile = (g, x.data_ptr(), int(x.dtype == torch.bfloat16), gy.data_ptr(),
            int(gy.dtype == torch.bfloat16), n, packed.wfw.data_ptr(), packed.wbw.data_ptr(),
            packed.bpk.data_ptr(), gx.data_ptr(), gb.data_ptr(), scratch.data_ptr(), st)
    wgrad = (g, -(-n // 64), scratch.data_ptr(), gw.data_ptr(), None, st)
    return (lambda: build.check(entry("mms_k1_bwd")(*tile), "fused_chain backward"),
            lambda: build.check(entry("mms_k1_wgrad")(*wgrad), "chain_wgrad"))


def _grad_buffers(layout: ChainLayout, dev):
    """gW and gb of every layer, zeroed in one fill, with their per-layer views."""
    nw, nb = layout.gw_off[-1], layout.gb_off[-1]
    buf = torch.zeros(nw + nb, device=dev)
    gw, gb = buf[:nw], buf[nw:]
    gws = [g.view(a, b) for g, a, b in zip(gw.split(layout.gw_sizes), layout.din_true,
                                           layout.dout_true)]
    return gw, gb, gws, list(gb.split(layout.dout_true))


def zero_grads(layout: ChainLayout, dev):
    """(gW list, gb list) of zeros: the gradients of a call with no rows."""
    return _grad_buffers(layout, dev)[2:]


def _launch_bwd(x, gy, weights, biases, skip, activation, beta, packed=None):
    """K1's backward on the card: (gx in x's dtype, rounded to bf16; gW list
    f32; gb list f32). Reuses the forward's images when given them."""
    check_card(x, activation, len(weights))
    layout, geom = chain_of(x.shape[1], weights, skip, activation, beta)
    gw, gb, gws, gbs = _grad_buffers(layout, x.device)
    x = _card_operand(x)
    n = x.shape[0]
    if n == 0:
        return torch.empty_like(x), gws, gbs
    if packed is None or packed.wbw is None:
        packed = _launch_pack(layout, geom, weights, biases, True)
    gx = torch.empty_like(x)
    tile, wgrad = _bwd_launchers(geom, x, _card_operand(gy), n, packed, gx, gw, gb,
                                 _bwd_scratch(geom, n, x.device))
    tile()
    BWD_KERNEL.launches += 1
    wgrad()
    WGRAD_KERNEL.launches += 1
    return gx, gws, gbs


def bare_forward(x, weights, biases, skip, activation, beta):
    """The forward chain kernel on one card input, packed once and its
    output preallocated, for timing the kernel alone: a closure that
    launches it as the wrapper does, uncounted."""
    layout, geom = chain_of(x.shape[1], weights, tuple(sorted(skip)), activation, beta)
    x = _card_operand(x)
    packed = _launch_pack(layout, geom, weights, biases, False)
    y = torch.empty((x.shape[0], layout.d_out), dtype=torch.bfloat16, device=x.device)
    return _fwd_launcher(geom, x, x.shape[0], packed, y)


def bare_backward(x, gy, weights, biases, skip, activation, beta):
    """The backward's kernels on one card input, packed once and every output
    preallocated, for checking and timing them alone: (layout, packed, gx,
    gw, gb, scratch, tile, wgrad), the last two the closures that launch the
    per-tile pass and chain_wgrad as the wrapper does, uncounted."""
    layout, geom = chain_of(x.shape[1], weights, tuple(sorted(skip)), activation, beta)
    x, gy = _card_operand(x), _card_operand(gy)
    n = x.shape[0]
    packed = _launch_pack(layout, geom, weights, biases, True)
    gx = torch.empty_like(x)
    gw, gb, _, _ = _grad_buffers(layout, x.device)
    scratch = _bwd_scratch(geom, n, x.device)
    tile, wgrad = _bwd_launchers(geom, x, gy, n, packed, gx, gw, gb, scratch)
    return layout, packed, gx, gw, gb, scratch, tile, wgrad


def stacks_of(layout: ChainLayout, scratch: torch.Tensor, n: int, tiles: Optional[int] = None):
    """The hin and gz stacks that a per-tile pass left in scratch, as rows
    [n, din_l] and [n, dout_l] per layer (bf16): K1's. With `tiles`, every
    row of layer l's sm[l] * tiles stacked tiles, padding rows included."""
    rows = None if tiles is None else n
    tiles = -(-n // 64) if tiles is None else tiles
    flat = scratch.view(torch.bfloat16)
    hins, gzs, pos = [], [], 0
    for l in range(layout.n_layers):
        cols, t = layout.din_pad[l], tiles * layout.sm[l]
        m = stack_rows(flat[pos:], t, cols)[:, :layout.din_true[l]]
        hins.append(m if rows is not None else m[:n])
        pos += t * 64 * cols
    pos = (2 * pos + 255) // 256 * 256 // 2  # the gz stacks start 256-byte aligned
    for l in range(layout.n_layers):
        cols, t = layout.gcols(l), tiles * layout.sm[l]
        m = stack_rows(flat[pos:], t, cols)[:, :layout.dout_true[l]]
        gzs.append(m if rows is not None else m[:n])
        pos += t * 64 * cols
    return hins, gzs


@dataclasses.dataclass
class Backward:
    """A backward on K1's layout prepared for one call (K1t's, K4j's, K4's,
    K5's): the images of its pack, its gradient buffers (packed, and views
    per layer), its scratch, its row tiles, and closures that launch
    (uncounted) its per-tile pass and chain_wgrad over the pass's stacks."""

    layout: ChainLayout
    packed: Packed
    gw: torch.Tensor
    gb: torch.Tensor
    gws: List[torch.Tensor]
    gbs: List[torch.Tensor]
    scratch: torch.Tensor
    tiles: int
    tile: object
    wgrad: object
    keep: tuple = ()  # the operands the closures point to


def prepare_backward(layout: ChainLayout, geom: _Geom, weights, biases, dev, scratch_bytes,
                     pass_args, tiles: int, what: str, count=None) -> Backward:
    """Pack the chain (one launch), allocate the gradients and the scratch
    (scratch_bytes: the bytes entry point and its arguments after the Geom)
    and bind the pass (pass_args(packed, gw, gb, scratch): its entry point
    and arguments between the Geom and the stream) and chain_wgrad over
    `tiles` row tiles; count (an int64 tensor or None) receives the number
    of gW atomics chain_wgrad issues."""
    packed = _launch_pack(layout, geom, weights, biases, True)
    gw, gb, gws, gbs = _grad_buffers(layout, dev)
    scratch = _scratch(scratch_bytes[0], geom, dev, *scratch_bytes[1:])
    g, st = ctypes.byref(geom), _stream(dev)
    name, *args = pass_args(packed, gw, gb, scratch)
    tile = (g, *args, st)
    wgrad = (g, tiles, scratch.data_ptr(), gw.data_ptr(),
             None if count is None else count.data_ptr(), st)
    return Backward(layout, packed, gw, gb, gws, gbs, scratch, tiles,
                    lambda: build.check(entry(name)(*tile), what),
                    lambda: build.check(entry("mms_k1_wgrad")(*wgrad), what + " chain_wgrad"))


def tangent_samples(k: int) -> int:
    """Samples per 64-row tile of the tangent kernels (csrc/fused_mlp.cu)."""
    return 32 if k == 1 else 16


def _check_tangents(tangents: torch.Tensor, x: torch.Tensor) -> int:
    k = tangents.shape[0]
    if not 1 <= k <= MAX_TANGENTS or tuple(tangents.shape[1:]) != tuple(x.shape):
        raise ValueError(f"fused_chain: tangents {tuple(tangents.shape)} do not fit x "
                         f"{tuple(x.shape)} (1 to {MAX_TANGENTS} tangents)")
    return k


def _launch_tangent_fwd(x, tx, weights, biases, skip, activation, beta, channel):
    """K1t's forward kernel: (y [N, D_out] bf16, ty [N, K] f32 with a
    channel or [K, N, D_out] bf16 without)."""
    check_card(x, activation, len(weights))
    k = _check_tangents(tx, x)
    n, d_in = x.shape
    d_out = weights[-1].shape[1]
    in_dims, out_dims, p0, hidden = chain_geometry(d_in, weights, skip)
    wpack, bpack = pack_chain(weights, biases, in_dims, out_dims, hidden, skip)
    xb, txb = x.to(torch.bfloat16).contiguous(), tx.to(torch.bfloat16).contiguous()
    y = torch.empty((n, d_out), dtype=torch.bfloat16, device=x.device)
    if channel is None:
        ty = torch.empty((k, n, d_out), dtype=torch.bfloat16, device=x.device)
    else:
        ty = torch.empty((n, k), dtype=torch.float32, device=x.device)
    if n:
        fn = build.function(
            "fused_mlp", "mms_chain_tangent_fwd", "ptr", "ptr", "int", "int", "ptr", "ptr",
            "int", "int", "ptr", "ptr", "int", "int", "int", "int", "float", "int", "ptr", "int",
            "ptr", "ptr",
        )
        status = fn(
            build.ptr(xb), build.ptr(txb), d_in, k, build.ptr(wpack), build.ptr(bpack), n,
            len(weights), build.int_array(in_dims), build.int_array(out_dims),
            sum(1 << l for l in skip), hidden, p0, ACTIVATIONS[activation], 2.0 / beta,
            -1 if channel is None else channel, build.ptr(y), d_out, build.ptr(ty),
            build.stream_of(x),
        )
        build.check(status, "fused_chain with tangents")
        TANGENT_KERNEL.launches += 1
    return y, ty


def tangent_bwd_card(x, tx, gy, gty, weights, biases, skip, activation, beta, channel,
                     count=None):
    """K1t's backward on the card, prepared (n > 0): (Backward, gx, gtx), the
    pass writing gx and gtx (bf16) and gb and leaving the Hin and G stacks of
    every layer in scratch, chain_wgrad writing gW."""
    check_card(x, activation, len(weights))
    k = _check_tangents(tx, x)
    layout, geom = chain_of(x.shape[1], weights, skip, activation, beta)
    n, d_in = x.shape
    xb, txb = x.to(torch.bfloat16).contiguous(), tx.to(torch.bfloat16).contiguous()
    gyb = gy.to(torch.bfloat16).contiguous()
    gtyc = (gty.to(torch.bfloat16) if channel is None else gty.float()).contiguous()
    gx = torch.empty((n, d_in), dtype=torch.bfloat16, device=x.device)
    gtx = torch.empty((k, n, d_in), dtype=torch.bfloat16, device=x.device)

    def pass_args(packed, gw, gb, scratch):
        return ("mms_chain_tangent_bwd", xb.data_ptr(), txb.data_ptr(), k, n, gyb.data_ptr(),
                gtyc.data_ptr(), -1 if channel is None else channel, packed.wfw.data_ptr(),
                packed.wbw.data_ptr(), packed.bpk.data_ptr(), gx.data_ptr(), gtx.data_ptr(),
                gb.data_ptr(), scratch.data_ptr())

    bw = prepare_backward(layout, geom, weights, biases, x.device,
                          ("mms_tangent_bwd_bytes", n, k), pass_args,
                          -(-n // tangent_samples(k)), "fused_chain with tangents, backward",
                          count)
    bw.keep = (xb, txb, gyb, gtyc)
    return bw, gx, gtx


def _launch_tangent_bwd(x, tx, gy, gty, weights, biases, skip, activation, beta, channel):
    """K1t's backward: the per-tile pass and chain_wgrad over its stacks
    (and the pack of the weight images). Returns (gx bf16, gtx bf16, gW list
    f32, gb list f32)."""
    if x.shape[0] == 0:
        check_card(x, activation, len(weights))
        layout, _ = chain_of(x.shape[1], weights, skip, activation, beta)
        return (torch.empty(x.shape, dtype=torch.bfloat16, device=x.device),
                torch.empty(tx.shape, dtype=torch.bfloat16, device=x.device),
                *zero_grads(layout, x.device))
    bw, gx, gtx = tangent_bwd_card(x, tx, gy, gty, weights, biases, skip, activation, beta,
                                   channel)
    bw.tile()
    TANGENT_BWD_KERNEL.launches += 1
    bw.wgrad()
    TANGENT_WGRAD_KERNEL.launches += 1
    return gx, gtx, bw.gws, bw.gbs


def _forward(x, weights, biases, skip, activation, beta):
    """The forward without tangents: the plain version for a CPU tensor,
    the kernel for any other (which raises off a card)."""
    if x.device.type == "cpu":
        return fused_chain_plain(x, weights, biases, skip=skip, activation=activation, beta=beta)
    return _launch_fwd(x, weights, biases, skip, activation, beta)[0]


def _forward_tangents(x, tx, weights, biases, skip, activation, beta, channel):
    """The forward with tangents: the plain version for a CPU tensor, the
    kernel for any other (which raises off a card)."""
    if x.device.type == "cpu":
        return fused_chain_plain(x, weights, biases, skip=skip, activation=activation, beta=beta,
                                 tangents=tx, tangent_out_channel=channel)
    return _launch_tangent_fwd(x, tx, weights, biases, skip, activation, beta, channel)


class _FusedChain(torch.autograd.Function):
    """K1 with its backward; saves x and the parameters, as chain_fwd
    (:901-902) does, and on the card also the images the forward's pack
    wrote (backward images included), and recomputes the forward in the
    backward kernel."""

    @staticmethod
    def forward(ctx, cfg, x, *params):
        n_layers = len(params) // 2
        ctx.cfg = cfg
        ctx.save_for_backward(x, *params)
        ctx.packed = None
        if x.device.type == "cpu":
            return _forward(x, params[:n_layers], params[n_layers:], *cfg)
        y, ctx.packed = _launch_fwd(x, params[:n_layers], params[n_layers:], *cfg,
                                    backward_images=True)
        return y

    @staticmethod
    def backward(ctx, gy):
        skip, activation, beta = ctx.cfg
        x, *params = ctx.saved_tensors
        n_layers = len(params) // 2
        ws, bs = params[:n_layers], params[n_layers:]
        if x.device.type == "cpu":
            gx, gws, gbs = fused_chain_bwd_plain(
                x, gy.to(torch.bfloat16), ws, bs, skip=skip, activation=activation, beta=beta
            )  # gy in bf16: chain_bwd :907
        else:  # the kernel rounds gy to bf16 as it reads it
            gx, gws, gbs = _launch_bwd(x, gy, ws, bs, skip, activation, beta, ctx.packed)
        ctx.packed = None
        return (None, gx.to(x.dtype), *gws, *gbs)


class _FusedChainTangents(torch.autograd.Function):
    """K1t with its backward: saves x, the tangents and the parameters
    (chain_fwd :901-902) and recomputes the forward in the backward."""

    @staticmethod
    def forward(ctx, cfg, x, tx, *params):
        n_layers = len(params) // 2
        ctx.cfg = cfg
        ctx.save_for_backward(x, tx, *params)
        return _forward_tangents(x, tx, params[:n_layers], params[n_layers:], *cfg)

    @staticmethod
    def backward(ctx, gy, gty):
        skip, activation, beta, channel = ctx.cfg
        x, tx, *params = ctx.saved_tensors
        n_layers = len(params) // 2
        ws, bs = params[:n_layers], params[n_layers:]
        # chain_bwd :904-916: gy in bf16, gty f32 with a channel, else bf16
        gy = gy.to(torch.bfloat16)
        gty = gty.float() if channel is not None else gty.to(torch.bfloat16)
        if x.device.type == "cpu":
            gx, gtx, gws, gbs = fused_chain_tangent_bwd_plain(
                x, tx, gy, gty, ws, bs, skip=skip, activation=activation, beta=beta,
                tangent_out_channel=channel)
        else:
            gx, gtx, gws, gbs = _launch_tangent_bwd(x, tx, gy, gty, ws, bs, skip, activation,
                                                    beta, channel)
        return (None, gx.to(x.dtype), gtx.to(tx.dtype), *gws, *gbs)


def fused_chain(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    *,
    skip: Tuple[int, ...] = (),
    activation: str = "ReLU",
    beta: float = 100.0,
    tangents: Optional[torch.Tensor] = None,
    tangent_out_channel: Optional[int] = None,
):
    """Run the fused dense chain; y [N, D_out] bf16 before the output
    activation, and with tangents [K, N, D_in] also ty ([K, N, D_out] bf16,
    or [N, K] f32 = d y_c / d t with tangent_out_channel=c). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel. With grad
    enabled the chain is differentiable through K1's (K1t's) backward."""
    skip = tuple(sorted(skip))
    params = (*weights, *biases)
    grad = torch.is_grad_enabled()
    if tangents is not None:
        if tangent_out_channel is not None and not 0 <= tangent_out_channel < weights[-1].shape[1]:
            raise ValueError(f"fused_chain: tangent channel {tangent_out_channel} out of range")
        cfg = (skip, activation, beta, tangent_out_channel)
        if grad and any(t.requires_grad for t in (x, tangents, *params)):
            return _FusedChainTangents.apply(cfg, x, tangents, *params)
        return _forward_tangents(x, tangents, weights, biases, *cfg)
    if grad and any(t.requires_grad for t in (x, *params)):
        return _FusedChain.apply((skip, activation, beta), x, *params)
    return _forward(x, weights, biases, skip, activation, beta)
