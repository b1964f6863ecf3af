"""Fused dense chain (MLP): kernel K1, forward and backward, without and
with forward tangents (K1t), and their plain versions.

`fused_chain` runs a whole MLP layer chain for a tile of samples on the
card in one CUDA kernel (csrc/fused_mlp.cu), so activations between layers
never touch device memory. It replaces the Pallas TPU kernel
multimodalstudio_tpu/ops/pallas/fused_mlp.py::_fwd_kernel (:265), reached
through `fused_chain` (:1080), in its forward mode without tangents. With
grad enabled it runs as an autograd Function whose backward is the second
CUDA kernel of the file, replacing _bwd_kernel (:607, via chain_bwd :904):
it recomputes the forward per tile, keeping the bf16 pre-activations in a
per-CTA slab of device scratch (an 8-layer 256-wide chain's stack does not
fit in shared memory beside the activations), and runs the reverse sweep.

With `tangents` [K, N, D_in] (K1t, the same two Pallas bodies with
n_tangents = K) the chain also carries K forward tangents: y and ty
[K, N, D_out] bf16, or with `tangent_out_channel=c` only column c of the
last layer's f32 tangents, [N, K] f32. On the card a tile is 64 rows of
the same products: the primal rows of b samples and the K tangent rows of
each (b = 16 for K = 2, 3; 32 for K = 1), since u = t W shares W with z =
h W + b. The backward (reverse over the tangent chain, act'' term
included) is its own kernel with the z and u stacks in device scratch.

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
the card's ridge of ~295 flop/byte, so the tensor-core rate bounds it. The
tangent chains multiply the hidden layers' work by 1 + K.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from multimodalstudio_tpu_torch.ops.kernels import build

SKIP_SCALE = 1.0 / math.sqrt(2.0)
ACTIVATIONS = {"None": 0, "ReLU": 1, "SoftplusQuad": 2}

KERNEL = build.register(
    "fused_chain",
    source="multimodalstudio_tpu_torch/csrc/fused_mlp.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:265",
)
BWD_KERNEL = build.register(
    "fused_chain_bwd",
    source="multimodalstudio_tpu_torch/csrc/fused_mlp.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:607",
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


def ga_forward(ga, zs, ss, weights, skip, activation, beta, channel=0, qs=None):
    """The forward chain of the adjoint's cotangent ga [N, D_in] f32 in a
    reverse-over-reverse backward (_bwd_adj_kernel :489-524): qin_0 = ga, ga
    re-injected at a skip like x0; v_l = s_l * act'(z_l) (e_c at the last
    layer); gW_l = bf16(qin_l)^T bf16(v_l); m = bf16(qin_l) W_l;
    e_l = bf16(m * s_l * act''(z_l)); q = m * act'(z_l). zs, ss: the bf16
    pre-activations and adjoint rows. Returns (gW list, the injections e_l
    or None where act'' is 0); a list `qs` receives bf16(q) of each hidden
    layer (the split backward's q stack, slot_fused.py:895-896)."""
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
        if l < n_layers - 1:
            m = qb @ bf16_round(weights[l].float())
            if ddf is not None:
                inject.append(bf16_round(m * ss[l] * ddf(zs[l])))
            q = m * df(zs[l])
            if qs is not None:
                qs.append(bf16_round(q))
    return gws, (inject if ddf is not None else None)


def reverse_sweep(x0, zs, gy, weights, skip, activation, beta, inject=None, gw_extra=None,
                  gzs=None):
    """The chain's reverse sweep from the last layer's cotangent gy (f32):
    gz_{L-1} = gy; gz_l = gh * act'(z_l) (+ inject[l]); gW_l = hin_l^T
    bf16(gz_l) (+ gw_extra[l]); gb_l = sum of the f32 gz_l; gh = bf16(gz_l)
    W_l^T, a skip layer's x0 part added to gx0. zs: the bf16 hidden
    pre-activations. Returns (cotangent of x0 [N, D_in] f32, gW list, gb
    list); a list `gzs` receives bf16(gz_l) of each hidden layer, first
    layer first (the split backward's gz stack, slot_fused.py:910)."""
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


def tangent_backward(x0, t0, gh, gt, weights, biases, skip, activation, beta):
    """The backward of the chain with K forward tangents (_bwd_kernel
    :636-789) at its cast points: x0 [N, D_in] and t0 [K, N, D_in] as bf16
    values, the last layer's cotangents gh [N, D_out] and gt [K, N, D_out]
    (f32, as they enter the products rounded to bf16). Recomputes z and u
    stored in bf16, then per layer gz = gh act'(z) + (sum_k gt_k u_k)
    act''(z), gu = gt act'(z), gW = hin^T bf16(gz) + sum_k tin_k^T
    bf16(gu_k), gb = sum gz, gh = bf16(gz) W^T, gt = bf16(gu) W^T. Returns
    (gx0 [N, D_in] f32, gtx0 [K, N, D_in] f32, gW list, gb list)."""
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
    layer, back to back) and biases as one f32 buffer. A skip layer's rows
    are [h (hidden) | x0 (padded input width)]."""
    ws, bs = [], []
    for l, (w, b) in enumerate(zip(weights, biases)):
        wp = w.new_zeros((in_dims[l], out_dims[l]), dtype=torch.float32)
        if l in skip:
            wp[:hidden, : w.shape[1]] = w[:hidden]
            wp[hidden : hidden + w.shape[0] - hidden, : w.shape[1]] = w[hidden:]
        else:
            wp[: w.shape[0], : w.shape[1]] = w
        ws.append(wp.reshape(-1))
        bp = b.new_zeros(out_dims[l], dtype=torch.float32)
        bp[: b.shape[0]] = b
        bs.append(bp)
    return torch.cat(ws).to(torch.bfloat16).contiguous(), torch.cat(bs).contiguous()


def unpack_grads(gw: torch.Tensor, gb: torch.Tensor, weights, in_dims, out_dims, hidden, skip):
    """Per-layer gW [din_l, dout_l] and gb [dout_l] out of the packed,
    padded f32 gradient buffers (the layout of pack_chain)."""
    gws, gbs = [], []
    wo = bo = 0
    for l, w in enumerate(weights):
        g = gw[wo : wo + in_dims[l] * out_dims[l]].view(in_dims[l], out_dims[l])
        if l in skip:
            g = torch.cat([g[:hidden], g[hidden : w.shape[0]]], dim=0)
        gws.append(g[: w.shape[0], : w.shape[1]])
        gbs.append(gb[bo : bo + w.shape[1]])
        wo += in_dims[l] * out_dims[l]
        bo += out_dims[l]
    return gws, gbs


def _check_card(x: torch.Tensor, activation: str, n_layers: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"fused_chain: unsupported device {x.device}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unsupported fused activation {activation}")
    build.check_layers(n_layers, "fused_chain")


def _launch_fwd(x, weights, biases, skip, activation, beta):
    _check_card(x, activation, len(weights))
    n, d_in = x.shape
    d_out = weights[-1].shape[1]
    in_dims, out_dims, p0, hidden = chain_geometry(d_in, weights, skip)
    wpack, bpack = pack_chain(weights, biases, in_dims, out_dims, hidden, skip)
    xb = x.to(torch.bfloat16).contiguous()
    y = torch.empty((n, d_out), dtype=torch.bfloat16, device=x.device)
    if n == 0:
        return y
    fn = build.function(
        "fused_mlp", "mms_fused_chain_fwd", "ptr", "int", "ptr", "ptr", "ptr", "int", "int",
        "int", "ptr", "ptr", "int", "int", "int", "int", "float", "ptr",
    )
    skip_mask = sum(1 << l for l in skip)
    status = fn(
        build.ptr(xb), d_in, build.ptr(wpack), build.ptr(bpack), build.ptr(y), d_out, n,
        len(weights), build.int_array(in_dims), build.int_array(out_dims), skip_mask,
        hidden, p0, ACTIVATIONS[activation], 2.0 / beta, build.stream_of(x),
    )
    build.check(status, "fused_chain")
    KERNEL.launches += 1
    return y


def _launch_bwd(x, gy, weights, biases, skip, activation, beta):
    """K1's backward kernel: (gx bf16, gW list f32, gb list f32)."""
    _check_card(x, activation, len(weights))
    if 0 in skip:
        raise ValueError("fused_chain: layer 0 cannot be a skip layer")
    n, d_in = x.shape
    d_out = weights[-1].shape[1]
    in_dims, out_dims, p0, hidden = chain_geometry(d_in, weights, skip)
    wpack, bpack = pack_chain(weights, biases, in_dims, out_dims, hidden, skip)
    xb = x.to(torch.bfloat16).contiguous()
    gyb = gy.to(torch.bfloat16).contiguous()
    gx = torch.empty((n, d_in), dtype=torch.bfloat16, device=x.device)
    gw = torch.zeros(sum(a * b for a, b in zip(in_dims, out_dims)), device=x.device)
    gb = torch.zeros(sum(out_dims), device=x.device)
    if n:
        scratch, ctas = build.persistent_scratch(
            "fused_mlp", "mms_fused_chain_bwd_slab", (len(weights), hidden, p0), x.device, n)
        fn = build.function(
            "fused_mlp", "mms_fused_chain_bwd", "ptr", "int", "ptr", "ptr", "ptr", "ptr", "ptr",
            "ptr", "int", "int", "int", "ptr", "ptr", "int", "int", "int", "int", "float", "ptr",
            "int", "ptr",
        )
        status = fn(
            build.ptr(xb), d_in, build.ptr(gyb), build.ptr(wpack), build.ptr(bpack),
            build.ptr(gx), build.ptr(gw), build.ptr(gb), d_out, n, len(weights),
            build.int_array(in_dims), build.int_array(out_dims), sum(1 << l for l in skip),
            hidden, p0, ACTIVATIONS[activation], 2.0 / beta, build.ptr(scratch), ctas,
            build.stream_of(x),
        )
        build.check(status, "fused_chain backward")
        BWD_KERNEL.launches += 1
    gws, gbs = unpack_grads(gw, gb, weights, in_dims, out_dims, hidden, skip)
    return gx, gws, gbs


def _check_tangents(tangents: torch.Tensor, x: torch.Tensor) -> int:
    k = tangents.shape[0]
    if not 1 <= k <= MAX_TANGENTS or tuple(tangents.shape[1:]) != tuple(x.shape):
        raise ValueError(f"fused_chain: tangents {tuple(tangents.shape)} do not fit x "
                         f"{tuple(x.shape)} (1 to {MAX_TANGENTS} tangents)")
    return k


def _launch_tangent_fwd(x, tx, weights, biases, skip, activation, beta, channel):
    """K1t's forward kernel: (y [N, D_out] bf16, ty [N, K] f32 with a
    channel or [K, N, D_out] bf16 without)."""
    _check_card(x, activation, len(weights))
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


def _launch_tangent_bwd(x, tx, gy, gty, weights, biases, skip, activation, beta, channel):
    """K1t's backward kernel: (gx bf16, gtx bf16, gW list f32, gb list f32)."""
    _check_card(x, activation, len(weights))
    k = _check_tangents(tx, x)
    if 0 in skip:
        raise ValueError("fused_chain: layer 0 cannot be a skip layer")
    n, d_in = x.shape
    d_out = weights[-1].shape[1]
    in_dims, out_dims, p0, hidden = chain_geometry(d_in, weights, skip)
    wpack, bpack = pack_chain(weights, biases, in_dims, out_dims, hidden, skip)
    xb, txb = x.to(torch.bfloat16).contiguous(), tx.to(torch.bfloat16).contiguous()
    gyb = gy.to(torch.bfloat16).contiguous()
    gtyc = (gty.to(torch.bfloat16) if channel is None else gty.float()).contiguous()
    gx = torch.empty((n, d_in), dtype=torch.bfloat16, device=x.device)
    gtx = torch.empty((k, n, d_in), dtype=torch.bfloat16, device=x.device)
    gw = torch.zeros(sum(a * b for a, b in zip(in_dims, out_dims)), device=x.device)
    gb = torch.zeros(sum(out_dims), device=x.device)
    if n:
        scratch, ctas = build.persistent_scratch(
            "fused_mlp", "mms_fused_chain_bwd_slab", (len(weights), hidden, p0), x.device, n)
        fn = build.function(
            "fused_mlp", "mms_chain_tangent_bwd", "ptr", "ptr", "int", "int", "ptr", "ptr", "int",
            "ptr", "ptr", "ptr", "ptr", "ptr", "ptr", "int", "int", "int", "ptr", "ptr", "int",
            "int", "int", "int", "float", "ptr", "int", "ptr",
        )
        status = fn(
            build.ptr(xb), build.ptr(txb), d_in, k, build.ptr(gyb), build.ptr(gtyc),
            -1 if channel is None else channel, build.ptr(wpack), build.ptr(bpack),
            build.ptr(gx), build.ptr(gtx), build.ptr(gw), build.ptr(gb), d_out, n, len(weights),
            build.int_array(in_dims), build.int_array(out_dims), sum(1 << l for l in skip),
            hidden, p0, ACTIVATIONS[activation], 2.0 / beta, build.ptr(scratch), ctas,
            build.stream_of(x),
        )
        build.check(status, "fused_chain with tangents, backward")
        TANGENT_BWD_KERNEL.launches += 1
    gws, gbs = unpack_grads(gw, gb, weights, in_dims, out_dims, hidden, skip)
    return gx, gtx, gws, gbs


def _forward(x, weights, biases, skip, activation, beta):
    """The forward without tangents: the plain version for a CPU tensor,
    the kernel for any other (which raises off a card)."""
    if x.device.type == "cpu":
        return fused_chain_plain(x, weights, biases, skip=skip, activation=activation, beta=beta)
    return _launch_fwd(x, weights, biases, skip, activation, beta)


def _forward_tangents(x, tx, weights, biases, skip, activation, beta, channel):
    """The forward with tangents: the plain version for a CPU tensor, the
    kernel for any other (which raises off a card)."""
    if x.device.type == "cpu":
        return fused_chain_plain(x, weights, biases, skip=skip, activation=activation, beta=beta,
                                 tangents=tx, tangent_out_channel=channel)
    return _launch_tangent_fwd(x, tx, weights, biases, skip, activation, beta, channel)


class _FusedChain(torch.autograd.Function):
    """K1 with its backward; saves only x and the parameters, as chain_fwd
    (:901-902) does, and recomputes the forward in the backward kernel."""

    @staticmethod
    def forward(ctx, cfg, x, *params):
        n_layers = len(params) // 2
        ctx.cfg = cfg
        ctx.save_for_backward(x, *params)
        return _forward(x, params[:n_layers], params[n_layers:], *cfg)

    @staticmethod
    def backward(ctx, gy):
        skip, activation, beta = ctx.cfg
        x, *params = ctx.saved_tensors
        n_layers = len(params) // 2
        ws, bs = params[:n_layers], params[n_layers:]
        gy = gy.to(torch.bfloat16)  # chain_bwd :907
        if x.device.type == "cpu":
            gx, gws, gbs = fused_chain_bwd_plain(
                x, gy, ws, bs, skip=skip, activation=activation, beta=beta
            )
        else:
            gx, gws, gbs = _launch_bwd(x, gy, ws, bs, skip, activation, beta)
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
