"""Fused MLP chain + reverse-mode input gradient (adjoint mode): kernels K4
(NeRF encoding in front) and K5 (an already-encoded input), forward and
backward, and their plain versions.

`fused_sdf_chain` (K4) takes raw positions [N, 3] and returns (sdf [N] f32,
geo [N, D_out-1] bf16, grad [N, 3] f32 = d sdf / d positions) of a
grid-less SDF MLP whose input is the NeRF encoding with the raw input
included. On the card it is one CUDA kernel (csrc/sdf_chain.cu): the
encoding, the chain and one reverse (adjoint) sweep of the chain from the
sdf channel, replacing the Pallas TPU kernel
multimodalstudio_tpu/ops/pallas/fused_mlp.py::_fwd_adj_kernel (:362),
reached through fused_sdf_chain (:1145, mode="adjoint", built by
_build_adj_chain :930). With grad enabled it runs as an autograd Function
that saves only the positions and the parameters, as chain_fwd (:1004)
does; its backward is the second kernel of the file, replacing
_bwd_adj_kernel (:410): reverse over reverse, recomputing the primal and
adjoint stacks per tile.

`fused_chain_adjoint` (K5) is the same pair of kernels without the
encoding (fused_chain_adjoint :1215, enc=None): x [N, D] in (rounded to
bf16), (y [N, D_out] bf16, adj [N, D] f32 = d y[:, channel] / d x) out; its
backward takes the cotangents (gy rounded to bf16, ga f32) and returns gx
[N, D] bf16 (chain_bwd :1013-1015, :602). The slot-grid surface without a
position encoding feeds it [xyz, grid features] and contracts adj with the
input tangents outside (models/model.py).

Arithmetic (the reference's cast points, _fwd_adj_kernel :374-404):
encoding [x, sin(x_d s_i), cos(x_d s_i)] in f32 rounded to bf16 (cos
computed directly); the chain as K1's (bf16 inputs and weights, f32
accumulation and bias, act in f32 rounded to bf16, a skip layer's input
concat(h, x0) / sqrt(2) rounded to bf16) with the hidden pre-activations
stored in bf16; the last layer f32, K4's sdf its column 0 and geo the next
columns rounded to bf16, K5's y all columns rounded to bf16; the adjoint
sweep s = bf16(v) W^T with a skip layer's s split into its h part (scaled,
times act'(z), into v) and its x0 part (scaled, into adj); K4's grad =
J_enc^T adj in f32.

Backward (_bwd_adj_kernel :453-602): the adjoint's cotangent ga (K4: the
cotangent g3 of grad through the encoding's basis tangents, sum_k g3_k
bf16(t0_k); K5: given) runs a forward chain (re-injected at a skip) that
gives the adjoint path's weight gradients qin^T v and the act'' injections
e_l = bf16(m * s * act''(z)); the standard reverse sweep from the last
layer's cotangent adds them; K4's d pos = J_enc^T (gh + gx0) + g3_k <adj,
enc''_k>, K5's gx = bf16(gh + gx0).

`mode="jvp"` (K4j; fused_sdf_chain :1209-1211 through _build_chain with
the encoding inside, bodies _fwd_kernel :265 and _bwd_kernel :607) gives
the same outputs from the encoding, its 3 bf16 basis tangents (_enc_fwd
:180-212) and 3 forward tangent chains: K1t's two kernels with the
encoding front end (csrc/fused_mlp.cu), sdf the last layer's f32 column 0,
grad column 0 of its three f32 tangents. Its backward ends in _enc_bwd
(:215-239): d pos = J_enc^T gh0 + the tangent cotangents through the
encoding's Hessian diagonal. MMS_SDF_CHAIN_MODE, read at call time as the
reference reads it (:1177), overrides `mode`.

Bound on an H100: forward, the primal chain and the adjoint sweep through
the hidden layers and layer 0 (the last layer's adjoint product is a column
of W, v being one-hot), 2 * N * sum(din * dout) flops each; backward, about
five more. At the mlp_raw_tpu widths (8 x 256, skip at 4) that is 1.8
MFLOP per sample forward against 12 + 4 + 512 + 12 bytes of positions and
outputs: the tensor cores bound both directions. K5 at the slot-grid
surface's 15 -> 128 -> 128 -> 257 does 0.14 MFLOP per sample forward
against 60 + 514 + 60 bytes (x f32 in, y bf16 and adj f32 out): memory
bounds its forward, the tensor cores its backward (0.35 MFLOP against
about 660 bytes).
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import torch

from multimodalstudio_tpu_torch.ops.kernels import build
from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import (
    ACTIVATIONS,
    adjoint_sweep,
    bf16_round,
    chain_forward,
    chain_geometry,
    ga_forward,
    pack_chain,
    reverse_sweep,
    tangent_backward,
    tangent_forward,
    unpack_grads,
)
from multimodalstudio_tpu_torch.ops.kernels.slot_fused import PEncoding, pe_scales

KERNEL = build.register(
    "fused_sdf_chain",
    source="multimodalstudio_tpu_torch/csrc/sdf_chain.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:362",
)
BWD_KERNEL = build.register(
    "fused_sdf_chain_bwd",
    source="multimodalstudio_tpu_torch/csrc/sdf_chain.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:410",
)
ADJ_KERNEL = build.register(
    "fused_chain_adjoint",
    source="multimodalstudio_tpu_torch/csrc/sdf_chain.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:362",
)
ADJ_BWD_KERNEL = build.register(
    "fused_chain_adjoint_bwd",
    source="multimodalstudio_tpu_torch/csrc/sdf_chain.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:410",
)
JVP_KERNEL = build.register(
    "fused_sdf_chain_jvp",
    source="multimodalstudio_tpu_torch/csrc/fused_mlp.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:265",
)
JVP_BWD_KERNEL = build.register(
    "fused_sdf_chain_jvp_bwd",
    source="multimodalstudio_tpu_torch/csrc/fused_mlp.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:607",
)


def _check(weights, skip, activation, mode="adjoint"):
    if mode not in ("adjoint", "jvp"):
        raise ValueError(f"unknown fused_sdf_chain mode {mode}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unsupported fused activation {activation}")
    if len(weights) < 2 or 0 in skip:
        raise ValueError("the adjoint chains take 2 or more layers with no skip at layer 0")


def fused_sdf_chain_plain(positions, weights, biases, *, num_frequencies, min_freq_exp,
                          max_freq_exp, skip=(), activation="SoftplusQuad", beta=100.0):
    """Plain PyTorch version of K4's forward (_fwd_adj_kernel :362-404):
    (sdf [N] f32, geo [N, D_out-1] bf16, grad [N, 3] f32)."""
    skip = tuple(sorted(skip))
    enc = PEncoding(positions.float(), pe_scales(num_frequencies, min_freq_exp, max_freq_exp))
    y, zs = chain_forward(enc.x0, weights, biases, skip, activation, beta)
    adj, _ = adjoint_sweep(enc.x0, zs, weights, skip, activation, beta)
    return y[:, 0], y[:, 1:].to(torch.bfloat16), enc.jt(adj)


def fused_sdf_chain_bwd_plain(positions, weights, biases, gsdf, ggeo, g3, *, num_frequencies,
                              min_freq_exp, max_freq_exp, skip=(), activation="SoftplusQuad",
                              beta=100.0):
    """Plain PyTorch version of K4's backward (_bwd_adj_kernel :410-602),
    written out at its cast points: cotangents gsdf [N], ggeo [N, D_out-1]
    (rounded to bf16) and g3 [N, 3] in; returns (d_pos [N, 3] f32, gW list
    f32, gb list f32)."""
    skip = tuple(sorted(skip))
    enc = PEncoding(positions.float(), pe_scales(num_frequencies, min_freq_exp, max_freq_exp))
    _, zs = chain_forward(enc.x0, weights, biases, skip, activation, beta)
    adj, ss = adjoint_sweep(enc.x0, zs, weights, skip, activation, beta)
    # the cotangent of grad rides the encoding's basis tangents onto adj
    # (:479); its forward chain gives the adjoint path's gW and the act''
    # injections of the standard reverse sweep (:489-575)
    g3 = g3.float()
    gwd, inject = ga_forward(enc.tangent_cotangent(g3), zs, ss, weights, skip, activation, beta)
    gy = torch.cat([gsdf.float()[:, None], bf16_round(ggeo.float())], dim=-1)
    ghin, gws, gbs = reverse_sweep(enc.x0, zs, gy, weights, skip, activation, beta,
                                   inject=inject, gw_extra=gwd)
    # d pos: the encoding's Jacobian transpose and its Hessian term (:577-599)
    return enc.jt(ghin) + g3 * enc.hess(adj), gws, gbs


class _CardArgs:
    """The packed operands and geometry arguments every entry point of
    csrc/sdf_chain.cu takes first: the chain input (K4's positions [N, 3]
    f32, the encoding of width d_in built in the kernel; K5's x [N, d_in]
    bf16), the packed chain and its geometry; `keep` holds the tensors the
    pointers refer to."""

    def __init__(self, x, d_in, weights, biases, skip, activation, beta):
        if x.device.type != "cuda":
            raise ValueError(f"adjoint chain: unsupported device {x.device}")
        if len(weights) > 8:
            raise ValueError("adjoint chain: at most 8 layers")
        self.n = x.shape[0]
        self.in_dims, self.out_dims, p0, self.hidden = chain_geometry(d_in, weights, skip)
        wpack, bpack = pack_chain(weights, biases, self.in_dims, self.out_dims, self.hidden, skip)
        self.keep = (x, wpack, bpack)
        self.args = [
            build.ptr(x), self.n, build.ptr(wpack), build.ptr(bpack), len(weights),
            build.int_array(self.in_dims), build.int_array(self.out_dims),
            sum(1 << l for l in skip), self.hidden, p0, ACTIVATIONS[activation], 2.0 / beta,
        ]
        self.stream = build.stream_of(x)

    def scratch(self, backward: bool):
        return build.persistent_scratch(
            "sdf_chain", "mms_sdf_chain_slab", (len(self.in_dims), self.hidden, int(backward)),
            self.keep[0].device, self.n)

    def grads(self, weights, skip):
        """Zeroed packed gradient buffers (gw, gb) and their unpacker."""
        dev = self.keep[0].device
        gw = torch.zeros(sum(a * b for a, b in zip(self.in_dims, self.out_dims)), device=dev)
        gb = torch.zeros(sum(self.out_dims), device=dev)
        return gw, gb, lambda: unpack_grads(gw, gb, weights, self.in_dims, self.out_dims,
                                            self.hidden, skip)


def _k4_args(positions, weights, biases, skip, activation, beta, pe):
    pos = positions.float().contiguous()
    ca = _CardArgs(pos, 3 + 6 * len(pe), weights, biases, skip, activation, beta)
    ca.args += [len(pe), build.float_array(pe)]
    return ca


_CHAIN_TYPES = ("ptr", "int", "ptr", "ptr", "int", "ptr", "ptr", "int", "int", "int", "int",
                "float")
_K4_TYPES = _CHAIN_TYPES + ("int", "ptr")  # pe_freqs, pe_scale
_K5_TYPES = _CHAIN_TYPES + ("int", "int")  # d_in, channel


def _launch_fwd(positions, weights, biases, skip, activation, beta, pe):
    """K4's forward kernel: (sdf, geo, grad)."""
    ca = _k4_args(positions, weights, biases, skip, activation, beta, pe)
    dev, n = positions.device, ca.n
    geo_width = weights[-1].shape[1] - 1
    sdf = torch.empty(n, dtype=torch.float32, device=dev)
    geo = torch.empty((n, geo_width), dtype=torch.bfloat16, device=dev)
    grad = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n:
        scratch, ctas = ca.scratch(backward=False)
        fn = build.function("sdf_chain", "mms_sdf_chain_fwd", *_K4_TYPES, "ptr", "ptr", "int",
                            "ptr", "ptr", "int", "ptr")
        status = fn(*ca.args, build.ptr(sdf), build.ptr(geo), geo_width, build.ptr(grad),
                    build.ptr(scratch), ctas, ca.stream)
        build.check(status, "fused_sdf_chain")
        KERNEL.launches += 1
    return sdf, geo, grad


def _launch_bwd(positions, weights, biases, skip, activation, beta, pe, gsdf, ggeo, g3):
    """K4's backward kernel: (d_pos, gW list, gb list)."""
    ca = _k4_args(positions, weights, biases, skip, activation, beta, pe)
    d_pos = torch.empty((ca.n, 3), dtype=torch.float32, device=positions.device)
    gw, gb, unpack = ca.grads(weights, skip)
    if ca.n:
        scratch, ctas = ca.scratch(backward=True)
        fn = build.function("sdf_chain", "mms_sdf_chain_bwd", *_K4_TYPES, "ptr", "ptr", "int",
                            "ptr", "ptr", "ptr", "ptr", "ptr", "int", "ptr")
        cot = (gsdf.float().contiguous(), ggeo.to(torch.bfloat16).contiguous(),
               g3.float().contiguous())
        status = fn(*ca.args, build.ptr(cot[0]), build.ptr(cot[1]), ggeo.shape[1],
                    build.ptr(cot[2]), build.ptr(d_pos), build.ptr(gw), build.ptr(gb),
                    build.ptr(scratch), ctas, ca.stream)
        build.check(status, "fused_sdf_chain backward")
        BWD_KERNEL.launches += 1
    return (d_pos, *unpack())


# ---------------------------------------------------------------- K4j


def fused_sdf_chain_jvp_plain(positions, weights, biases, *, num_frequencies, min_freq_exp,
                              max_freq_exp, skip=(), activation="SoftplusQuad", beta=100.0):
    """Plain PyTorch version of K4j's forward (_fwd_kernel :265-312 with the
    encoding and 3 tangents): (sdf [N] f32, geo [N, D_out-1] bf16, grad [N,
    3] f32)."""
    skip = tuple(sorted(skip))
    enc = PEncoding(positions.float(), pe_scales(num_frequencies, min_freq_exp, max_freq_exp))
    z, u = tangent_forward(enc.x0, enc.basis_tangents(), weights, biases, skip, activation, beta)
    return z[:, 0], z[:, 1:].to(torch.bfloat16), u[:, :, 0].T.contiguous()


def fused_sdf_chain_jvp_bwd_plain(positions, weights, biases, gsdf, ggeo, g3, *,
                                  num_frequencies, min_freq_exp, max_freq_exp, skip=(),
                                  activation="SoftplusQuad", beta=100.0):
    """Plain PyTorch version of K4j's backward (_bwd_kernel :607-792, its
    split branch :678-696 and _enc_bwd :215-239): cotangents gsdf [N] f32,
    ggeo [N, D_out-1] (rounded to bf16) and g3 [N, 3] f32 in; returns (d_pos
    [N, 3] f32, gW list f32, gb list f32)."""
    skip = tuple(sorted(skip))
    enc = PEncoding(positions.float(), pe_scales(num_frequencies, min_freq_exp, max_freq_exp))
    n, d_out = positions.shape[0], weights[-1].shape[1]
    gh = torch.cat([gsdf.float()[:, None], bf16_round(ggeo.float())], dim=-1)
    gt = gh.new_zeros((3, n, d_out))
    gt[:, :, 0] = g3.float().T
    ghx, gtx, gws, gbs = tangent_backward(enc.x0, enc.basis_tangents(), gh, gt, weights, biases,
                                          skip, activation, beta)
    hess = torch.stack([enc.hess(gtx[k])[:, k] for k in range(3)], dim=-1)
    return enc.jt(ghx) + hess, gws, gbs


def _launch_jvp_fwd(positions, weights, biases, skip, activation, beta, pe):
    """K4j's forward kernel: (sdf, geo, grad)."""
    ca = _k4_args(positions, weights, biases, skip, activation, beta, pe)
    dev, n = positions.device, ca.n
    geo_width = weights[-1].shape[1] - 1
    sdf = torch.empty(n, dtype=torch.float32, device=dev)
    geo = torch.empty((n, geo_width), dtype=torch.bfloat16, device=dev)
    grad = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n:
        fn = build.function("fused_mlp", "mms_sdf_chain_jvp_fwd", *_K4_TYPES, "ptr", "ptr", "int",
                            "ptr", "ptr")
        status = fn(*ca.args, build.ptr(sdf), build.ptr(geo), geo_width, build.ptr(grad),
                    ca.stream)
        build.check(status, "fused_sdf_chain (jvp mode)")
        JVP_KERNEL.launches += 1
    return sdf, geo, grad


def _launch_jvp_bwd(positions, weights, biases, skip, activation, beta, pe, gsdf, ggeo, g3):
    """K4j's backward kernel: (d_pos, gW list, gb list)."""
    ca = _k4_args(positions, weights, biases, skip, activation, beta, pe)
    d_pos = torch.empty((ca.n, 3), dtype=torch.float32, device=positions.device)
    gw, gb, unpack = ca.grads(weights, skip)
    if ca.n:
        scratch, ctas = build.persistent_scratch(
            "fused_mlp", "mms_fused_chain_bwd_slab",
            (len(weights), ca.hidden, ca.in_dims[0]), positions.device, ca.n)
        fn = build.function("fused_mlp", "mms_sdf_chain_jvp_bwd", *_K4_TYPES, "ptr", "ptr", "int",
                            "ptr", "ptr", "ptr", "ptr", "ptr", "int", "ptr")
        cot = (gsdf.float().contiguous(), ggeo.to(torch.bfloat16).contiguous(),
               g3.float().contiguous())
        status = fn(*ca.args, build.ptr(cot[0]), build.ptr(cot[1]), ggeo.shape[1],
                    build.ptr(cot[2]), build.ptr(d_pos), build.ptr(gw), build.ptr(gb),
                    build.ptr(scratch), ctas, ca.stream)
        build.check(status, "fused_sdf_chain (jvp mode) backward")
        JVP_BWD_KERNEL.launches += 1
    return (d_pos, *unpack())


# (plain forward, plain backward, forward kernel, backward kernel) per mode
_ROUTES = {
    "adjoint": (fused_sdf_chain_plain, fused_sdf_chain_bwd_plain, _launch_fwd, _launch_bwd),
    "jvp": (fused_sdf_chain_jvp_plain, fused_sdf_chain_jvp_bwd_plain, _launch_jvp_fwd,
            _launch_jvp_bwd),
}


class _SdfChain(torch.autograd.Function):
    """K4 or K4j with its backward (chain_fwd / chain_bwd :901-916,
    :1004-1022): saves the positions and parameters only; the backward
    recomputes per tile."""

    @staticmethod
    def forward(ctx, cfg, positions, *params):
        ws, bs = params[: len(params) // 2], params[len(params) // 2 :]
        ctx.cfg = cfg
        ctx.save_for_backward(positions, *params)
        return _forward(positions, ws, bs, *cfg)

    @staticmethod
    def backward(ctx, gsdf, ggeo, g3):
        kw, pe, mode = ctx.cfg
        positions, *params = ctx.saved_tensors
        ws, bs = params[: len(params) // 2], params[len(params) // 2 :]
        ggeo = ggeo.to(torch.bfloat16)  # chain_bwd :912, :1012
        _, plain_bwd, _, launch_bwd = _ROUTES[mode]
        if positions.device.type == "cpu":
            d_pos, gws, gbs = plain_bwd(positions, ws, bs, gsdf, ggeo, g3, **kw)
        else:
            d_pos, gws, gbs = launch_bwd(positions, ws, bs, kw["skip"], kw["activation"],
                                         kw["beta"], pe, gsdf, ggeo, g3)
        return (None, d_pos.to(positions.dtype), *gws, *gbs)


def _forward(positions, weights, biases, kw, pe, mode):
    """The plain version for a CPU tensor, the kernel for any other (which
    raises off a card)."""
    plain, _, launch, _ = _ROUTES[mode]
    if positions.device.type == "cpu":
        return plain(positions, weights, biases, **kw)
    return launch(positions, weights, biases, kw["skip"], kw["activation"], kw["beta"], pe)


def fused_sdf_chain(
    positions: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    *,
    num_frequencies: int,
    min_freq_exp: float,
    max_freq_exp: float,
    skip: Tuple[int, ...] = (),
    activation: str = "SoftplusQuad",
    beta: float = 100.0,
    tangent_out_channel: int = 0,
    mode: str = "adjoint",
):
    """(sdf [N] f32, geo [N, D_out-1] bf16, grad [N, 3] f32 = d sdf / d
    positions) at raw positions [N, 3]: K4 in adjoint mode, K4j in jvp mode
    (MMS_SDF_CHAIN_MODE overrides `mode` at call time, as the reference
    does at :1177). weights[l] [din_l, dout_l] are the effective
    (weight-norm applied) matrices of a chain whose input is the NeRF
    encoding with the raw input (3 + 6F columns). With grad enabled,
    differentiable (second order through grad) in positions, weights and
    biases through the mode's backward."""
    mode = os.environ.get("MMS_SDF_CHAIN_MODE", mode)
    if tangent_out_channel != 0:
        raise ValueError("fused_sdf_chain: the sdf channel is column 0")
    skip = tuple(sorted(skip))
    _check(weights, skip, activation, mode)
    kw = dict(num_frequencies=num_frequencies, min_freq_exp=min_freq_exp,
              max_freq_exp=max_freq_exp, skip=skip, activation=activation, beta=beta)
    cfg = (kw, pe_scales(num_frequencies, min_freq_exp, max_freq_exp), mode)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (positions, *weights, *biases)):
        return _SdfChain.apply(cfg, positions, *weights, *biases)
    return _forward(positions, weights, biases, *cfg)


# ---------------------------------------------------------------- K5


def fused_chain_adjoint_plain(x, weights, biases, *, skip=(), activation="SoftplusQuad",
                              beta=100.0, channel=0):
    """Plain PyTorch version of K5's forward (_fwd_adj_kernel :362-407 with
    enc=None): (y [N, D_out] bf16, adj [N, D_in] f32)."""
    skip = tuple(sorted(skip))
    x0 = bf16_round(x.float())
    y, zs = chain_forward(x0, weights, biases, skip, activation, beta)
    adj, _ = adjoint_sweep(x0, zs, weights, skip, activation, beta, channel)
    return y.to(torch.bfloat16), adj


def fused_chain_adjoint_bwd_plain(x, weights, biases, gy, ga, *, skip=(), activation="SoftplusQuad",
                                  beta=100.0, channel=0):
    """Plain PyTorch version of K5's backward (_bwd_adj_kernel :410-602 with
    enc=None), at its cast points: cotangents gy [N, D_out] (rounded to
    bf16) and ga [N, D_in] f32 in; returns (gx [N, D_in] bf16, gW list f32,
    gb list f32)."""
    skip = tuple(sorted(skip))
    x0 = bf16_round(x.float())
    _, zs = chain_forward(x0, weights, biases, skip, activation, beta)
    _, ss = adjoint_sweep(x0, zs, weights, skip, activation, beta, channel)
    gwd, inject = ga_forward(ga.float(), zs, ss, weights, skip, activation, beta, channel)
    ghin, gws, gbs = reverse_sweep(x0, zs, bf16_round(gy.float()), weights, skip, activation,
                                   beta, inject=inject, gw_extra=gwd)
    return ghin.to(torch.bfloat16), gws, gbs


def _k5_args(x, weights, biases, skip, activation, beta, channel):
    d_in = x.shape[1]
    ca = _CardArgs(x.to(torch.bfloat16).contiguous(), d_in, weights, biases, skip, activation,
                   beta)
    ca.args += [d_in, channel]
    return ca


def _launch_adj_fwd(x, weights, biases, skip, activation, beta, channel):
    """K5's forward kernel: (y, adj)."""
    ca = _k5_args(x, weights, biases, skip, activation, beta, channel)
    dev, n, d_out = x.device, ca.n, weights[-1].shape[1]
    y = torch.empty((n, d_out), dtype=torch.bfloat16, device=dev)
    adj = torch.empty((n, x.shape[1]), dtype=torch.float32, device=dev)
    if n:
        scratch, ctas = ca.scratch(backward=False)
        fn = build.function("sdf_chain", "mms_chain_adj_fwd", *_K5_TYPES, "ptr", "int", "ptr",
                            "ptr", "int", "ptr")
        status = fn(*ca.args, build.ptr(y), d_out, build.ptr(adj), build.ptr(scratch), ctas,
                    ca.stream)
        build.check(status, "fused_chain_adjoint")
        ADJ_KERNEL.launches += 1
    return y, adj


def _launch_adj_bwd(x, weights, biases, skip, activation, beta, channel, gy, ga):
    """K5's backward kernel: (gx, gW list, gb list)."""
    ca = _k5_args(x, weights, biases, skip, activation, beta, channel)
    d_out = weights[-1].shape[1]
    gx = torch.empty((ca.n, x.shape[1]), dtype=torch.bfloat16, device=x.device)
    gw, gb, unpack = ca.grads(weights, skip)
    if ca.n:
        scratch, ctas = ca.scratch(backward=True)
        fn = build.function("sdf_chain", "mms_chain_adj_bwd", *_K5_TYPES, "ptr", "int", "ptr",
                            "ptr", "ptr", "ptr", "ptr", "int", "ptr")
        cot = (gy.to(torch.bfloat16).contiguous(), ga.float().contiguous())
        status = fn(*ca.args, build.ptr(cot[0]), d_out, build.ptr(cot[1]), build.ptr(gx),
                    build.ptr(gw), build.ptr(gb), build.ptr(scratch), ctas, ca.stream)
        build.check(status, "fused_chain_adjoint backward")
        ADJ_BWD_KERNEL.launches += 1
    return (gx, *unpack())


def _adj_forward(x, weights, biases, kw):
    """The plain version for a CPU tensor, the kernel for any other (which
    raises off a card)."""
    if x.device.type == "cpu":
        return fused_chain_adjoint_plain(x, weights, biases, **kw)
    return _launch_adj_fwd(x, weights, biases, kw["skip"], kw["activation"], kw["beta"],
                           kw["channel"])


class _ChainAdjoint(torch.autograd.Function):
    """K5 with its backward (chain_fwd / chain_bwd :1004-1022): saves only x
    and the parameters; the backward recomputes per tile."""

    @staticmethod
    def forward(ctx, kw, x, *params):
        ws, bs = params[: len(params) // 2], params[len(params) // 2 :]
        ctx.kw = kw
        ctx.save_for_backward(x, *params)
        return _adj_forward(x, ws, bs, kw)

    @staticmethod
    def backward(ctx, gy, ga):
        kw = ctx.kw
        x, *params = ctx.saved_tensors
        ws, bs = params[: len(params) // 2], params[len(params) // 2 :]
        gy = gy.to(torch.bfloat16)  # chain_bwd :1014
        if x.device.type == "cpu":
            gx, gws, gbs = fused_chain_adjoint_bwd_plain(x, ws, bs, gy, ga, **kw)
        else:
            gx, gws, gbs = _launch_adj_bwd(x, ws, bs, kw["skip"], kw["activation"], kw["beta"],
                                           kw["channel"], gy, ga)
        return (None, gx.to(x.dtype), *gws, *gbs)


def fused_chain_adjoint(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    *,
    skip: Tuple[int, ...] = (),
    activation: str = "SoftplusQuad",
    beta: float = 100.0,
    channel: int = 0,
):
    """(y [N, D_out] bf16, adj [N, D_in] f32 = d y[:, channel] / d x) of
    the chain at x [N, D_in] (K5). weights[l] [din_l, dout_l] are the
    effective (weight-norm applied) matrices. With grad enabled,
    differentiable (second order through adj) in x, weights and biases
    through K5's backward."""
    skip = tuple(sorted(skip))
    _check(weights, skip, activation)
    chain_geometry(x.shape[1], weights, skip)  # raises on a width that does not fit the chain
    if not 0 <= channel < weights[-1].shape[1]:
        raise ValueError(f"fused_chain_adjoint: channel {channel} out of range")
    kw = dict(skip=skip, activation=activation, beta=beta, channel=channel)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *weights, *biases)):
        return _ChainAdjoint.apply(kw, x, *weights, *biases)
    return _adj_forward(x, weights, biases, kw)
