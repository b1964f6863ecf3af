"""Fused MLP chain + reverse-mode input gradient (adjoint mode): kernels K4
(NeRF encoding in front) and K5 (an already-encoded input), forward and
backward, and their plain versions.

`fused_sdf_chain` (K4) takes raw positions [N, 3] and returns (sdf [N] f32,
geo [N, D_out-1] bf16, grad [N, 3] f32 = d sdf / d positions) of a
grid-less SDF MLP whose input is the NeRF encoding with the raw input
included. On the card it runs on K1's building blocks (fused_mlp.py): the
pack of the weight images (forward and backward), then one pass
(csrc/adj_fwd.cu, adj_fwd.cuh) of the encoding, the chain and one reverse
(adjoint) sweep of the chain from the sdf channel, two device operations,
replacing the Pallas TPU kernel
multimodalstudio_tpu/ops/pallas/fused_mlp.py::_fwd_adj_kernel (:362),
reached through fused_sdf_chain (:1145, mode="adjoint", built by
_build_adj_chain :930). With grad enabled it runs as an autograd Function
that saves the positions and the parameters, as chain_fwd (:1004) does,
and the forward's images; its backward replaces _bwd_adj_kernel (:410),
reverse over reverse: on those images, a per-tile pass (csrc/sdf_chain.cu)
that recomputes the primal and adjoint rows, runs the ga-forward chain and
the reverse sweep and writes d pos, gb and the stacks of every gW operand
(hin over qin, gz over v), and chain_wgrad over the stacks.

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
:180-212) and 3 forward tangent chains: K1t's kernels with the encoding
front end (csrc/tangent_fwd.cu, csrc/fused_mlp.cu), sdf the last layer's
f32 column 0, grad column 0 of its three f32 tangents. Its backward ends in _enc_bwd
(:215-239): d pos = J_enc^T gh0 + the tangent cotangents through the
encoding's Hessian diagonal; on the card it is the tangent backward's
pass (K1t's) with the encoding in front, and chain_wgrad.
MMS_SDF_CHAIN_MODE, read at call time as the reference reads it (:1177),
overrides `mode`.

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

import ctypes
import os
from typing import Sequence, Tuple

import torch

from multimodalstudio_tpu_torch.ops.kernels import build
from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import (
    ACTIVATIONS,
    _card_operand,
    _launch_pack,
    _scratch,
    _stream,
    adjoint_sweep,
    bf16_round,
    chain_forward,
    chain_of,
    chain_wgrad_plain,
    check_card,
    entry,
    ga_forward,
    prepare_backward,
    reverse_sweep,
    tangent_backward,
    tangent_bwd_tile_plain,
    tangent_forward,
    tangent_samples,
    zero_grads,
)
from multimodalstudio_tpu_torch.ops.kernels.slot_fused import PEncoding, pe_scales

KERNEL = build.register(
    "fused_sdf_chain",
    source="multimodalstudio_tpu_torch/csrc/adj_fwd.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:362",
)
BWD_KERNEL = build.register(
    "fused_sdf_chain_bwd",
    source="multimodalstudio_tpu_torch/csrc/sdf_chain.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:410",
)
ADJ_KERNEL = build.register(
    "fused_chain_adjoint",
    source="multimodalstudio_tpu_torch/csrc/adj_fwd.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:362",
)
ADJ_BWD_KERNEL = build.register(
    "fused_chain_adjoint_bwd",
    source="multimodalstudio_tpu_torch/csrc/sdf_chain.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:410",
)
JVP_KERNEL = build.register(
    "fused_sdf_chain_jvp",
    source="multimodalstudio_tpu_torch/csrc/tangent_fwd.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:265",
)
JVP_BWD_KERNEL = build.register(
    "fused_sdf_chain_jvp_bwd",
    source="multimodalstudio_tpu_torch/csrc/fused_mlp.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:607",
)
# chain_wgrad (csrc/fused_chain.cu) on each backward pass's stacks
WGRAD_KERNEL = build.register(
    "fused_sdf_chain_wgrad",
    source="multimodalstudio_tpu_torch/csrc/fused_chain.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:546",
)
ADJ_WGRAD_KERNEL = build.register(
    "fused_chain_adjoint_wgrad",
    source="multimodalstudio_tpu_torch/csrc/fused_chain.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:546",
)
JVP_WGRAD_KERNEL = build.register(
    "fused_sdf_chain_jvp_wgrad",
    source="multimodalstudio_tpu_torch/csrc/fused_chain.cu",
    replaces="multimodalstudio_tpu/ops/pallas/fused_mlp.py:732",
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


def adjoint_bwd_tile_plain(x0, zs, ss, ga, gy, weights, skip, activation, beta, channel=0):
    """Plain version of the adjoint backward's per-tile pass (csrc/sdf_chain.cu
    adj_bwd_pass_kernel) from the recomputed z and s stacks: the ga-forward
    chain and the reverse sweep without the weight gradients. Returns (the
    cotangent of x0 f32, the stacks of each layer's gW operands as rows: A_l
    = [hin_l; qin_l] and B_l = [bf16(gz_l); bf16(v_l)] (layer L-1: hin and
    gz only), gb list f32, the column sums of qin_{L-1}, its gW's term in
    column `channel`)."""
    fwd, rev = [], []
    _, inject = ga_forward(ga, zs, ss, weights, skip, activation, beta, channel, stacks=fwd)
    ghin, _, gbs = reverse_sweep(x0, zs, gy, weights, skip, activation, beta, inject=inject,
                                 stacks=rev)
    last = len(weights) - 1
    a = [torch.cat([rev[l][0], fwd[l][0]]) for l in range(last)] + [rev[last][0]]
    b = [torch.cat([rev[l][1], fwd[l][1]]) for l in range(last)] + [rev[last][1]]
    return ghin, a, b, gbs, fwd[last][0].sum(0)


def adjoint_wgrad_plain(a, b, col, channel=0):
    """Plain version of the adjoint backward's gW: chain_wgrad_plain of the
    pass's stacks, and the last layer's column-sum term in column `channel`."""
    gws = chain_wgrad_plain(a, b)
    gws[-1][:, channel] += col
    return gws


def fused_sdf_chain_bwd_tile_plain(positions, weights, biases, gsdf, ggeo, g3, *,
                                   num_frequencies, min_freq_exp, max_freq_exp, skip=(),
                                   activation="SoftplusQuad", beta=100.0):
    """Plain version of K4's per-tile backward pass, fused_sdf_chain_bwd_plain's
    arguments: (d_pos [N, 3] f32, the A and B stacks, gb list f32, the last
    layer's column term); adjoint_wgrad_plain of the rest gives gW."""
    skip = tuple(sorted(skip))
    enc = PEncoding(positions.float(), pe_scales(num_frequencies, min_freq_exp, max_freq_exp))
    _, zs = chain_forward(enc.x0, weights, biases, skip, activation, beta)
    adj, ss = adjoint_sweep(enc.x0, zs, weights, skip, activation, beta)
    g3 = g3.float()
    gy = torch.cat([gsdf.float()[:, None], bf16_round(ggeo.float())], dim=-1)
    ghin, a, b, gbs, col = adjoint_bwd_tile_plain(enc.x0, zs, ss, enc.tangent_cotangent(g3), gy,
                                                  weights, skip, activation, beta)
    return enc.jt(ghin) + g3 * enc.hess(adj), a, b, gbs, col


def fused_chain_adjoint_bwd_tile_plain(x, weights, biases, gy, ga, *, skip=(),
                                       activation="SoftplusQuad", beta=100.0, channel=0):
    """Plain version of K5's per-tile backward pass, fused_chain_adjoint_bwd_plain's
    arguments: (gx [N, D_in] bf16, the A and B stacks, gb list f32, the last
    layer's column term); adjoint_wgrad_plain of the rest gives gW."""
    skip = tuple(sorted(skip))
    x0 = bf16_round(x.float())
    _, zs = chain_forward(x0, weights, biases, skip, activation, beta)
    _, ss = adjoint_sweep(x0, zs, weights, skip, activation, beta, channel)
    ghin, a, b, gbs, col = adjoint_bwd_tile_plain(x0, zs, ss, ga.float(), bf16_round(gy.float()),
                                                  weights, skip, activation, beta, channel)
    return ghin.to(torch.bfloat16), a, b, gbs, col


def _sdf_outputs(n, d_out, dev):
    """K4's and K4j's outputs: sdf [N] f32, geo [N, D_out-1] bf16, grad [N, 3] f32."""
    return (torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty((n, d_out - 1), dtype=torch.bfloat16, device=dev),
            torch.empty((n, 3), dtype=torch.float32, device=dev))


def _launch_fwd(positions, weights, biases, skip, activation, beta, pe):
    """K4's forward on the card: the pack of the weight images (the backward
    images included: the adjoint sweep reads them, and the call's backward
    reuses them), then the pass, two device operations. Returns (sdf, geo,
    grad, the Packed images or None for N = 0)."""
    check_card(positions, activation, len(weights), "fused_sdf_chain")
    pos = positions.float().contiguous()
    layout, geom = chain_of(3 + 6 * len(pe), weights, skip, activation, beta, adjoint=True)
    n, dev = pos.shape[0], pos.device
    sdf, geo, grad = _sdf_outputs(n, layout.d_out, dev)
    if n == 0:
        return sdf, geo, grad, None
    packed = _launch_pack(layout, geom, weights, biases, True)
    scratch = _scratch("mms_adj_fwd_bytes", geom, dev, n)
    status = entry("mms_sdf_chain_fwd")(
        ctypes.byref(geom), pos.data_ptr(), n, len(pe), build.float_array(pe),
        packed.wfw.data_ptr(), packed.wbw.data_ptr(), packed.bpk.data_ptr(), sdf.data_ptr(),
        geo.data_ptr(), geo.shape[1], grad.data_ptr(), scratch.data_ptr(), _stream(dev))
    build.check(status, "fused_sdf_chain")
    KERNEL.launches += 1
    return sdf, geo, grad, packed


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous operand at a 16-byte aligned address (read as vectors)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def sdf_bwd_card(positions, weights, biases, skip, activation, beta, pe, gsdf, ggeo, g3,
                 count=None, packed=None):
    """K4's backward on the card, prepared (N > 0): (Backward, d_pos), the pass
    writing d_pos [N, 3] f32, gb and the last layer's column term of gW and
    leaving the A and B stacks in scratch, chain_wgrad adding the stacked gW;
    on the forward's images `packed` where given. count (an int64 tensor or
    None) receives the gW atomics of both."""
    check_card(positions, activation, len(weights), "fused_sdf_chain backward")
    pos = positions.float().contiguous()
    n = pos.shape[0]
    layout, geom = chain_of(3 + 6 * len(pe), weights, skip, activation, beta, adjoint=True)
    pe_arr = build.float_array(pe)
    cot = (gsdf.float().contiguous(), ggeo.to(torch.bfloat16).contiguous(),
           g3.float().contiguous())
    d_pos = torch.empty((n, 3), dtype=torch.float32, device=pos.device)
    cp = None if count is None else count.data_ptr()

    def pass_args(packed, gw, gb, scratch, _extra):
        return ("mms_sdf_chain_bwd", pos.data_ptr(), n, len(pe), pe_arr, cot[0].data_ptr(),
                cot[1].data_ptr(), ggeo.shape[1], cot[2].data_ptr(), packed.wfw.data_ptr(),
                packed.wbw.data_ptr(), packed.bpk.data_ptr(), d_pos.data_ptr(), gw.data_ptr(),
                gb.data_ptr(), scratch.data_ptr(), cp)

    bw = prepare_backward(layout, geom, weights, biases, pos.device, ("mms_adj_bwd_bytes", n),
                          pass_args, -(-n // 64), "fused_sdf_chain backward", count,
                          packed=packed)
    bw.keep = (pos, pe_arr, *cot)
    return bw, d_pos


def _launch_bwd(positions, weights, biases, skip, activation, beta, pe, gsdf, ggeo, g3,
                packed=None):
    """K4's backward: the per-tile pass and chain_wgrad over its stacks (on
    the forward's images `packed`, or a pack of its own). Returns (d_pos, gW
    list, gb list)."""
    if positions.shape[0] == 0:
        check_card(positions, activation, len(weights), "fused_sdf_chain backward")
        return (torch.empty((0, 3), device=positions.device),
                *zero_grads(chain_of(3 + 6 * len(pe), weights, skip, activation, beta, True)[0],
                            positions.device))
    bw, d_pos = sdf_bwd_card(positions, weights, biases, skip, activation, beta, pe, gsdf, ggeo,
                             g3, packed=packed)
    bw.tile()
    BWD_KERNEL.launches += 1
    bw.wgrad()
    WGRAD_KERNEL.launches += 1
    return d_pos, bw.gws, bw.gbs


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


def fused_sdf_chain_jvp_bwd_tile_plain(positions, weights, biases, gsdf, ggeo, g3, *,
                                       num_frequencies, min_freq_exp, max_freq_exp, skip=(),
                                       activation="SoftplusQuad", beta=100.0):
    """Plain version of K4j's per-tile backward pass, fused_sdf_chain_jvp_bwd_plain's
    arguments: (d_pos [N, 3] f32, the Hin and G stacks of every layer as rows,
    gb list f32); chain_wgrad_plain of the stacks gives gW."""
    skip = tuple(sorted(skip))
    enc = PEncoding(positions.float(), pe_scales(num_frequencies, min_freq_exp, max_freq_exp))
    n, d_out = positions.shape[0], weights[-1].shape[1]
    gh = torch.cat([gsdf.float()[:, None], bf16_round(ggeo.float())], dim=-1)
    gt = gh.new_zeros((3, n, d_out))
    gt[:, :, 0] = g3.float().T
    ghx, gtx, hins, gzs, gbs = tangent_bwd_tile_plain(enc.x0, enc.basis_tangents(), gh, gt,
                                                      weights, biases, skip, activation, beta)
    hess = torch.stack([enc.hess(gtx[k])[:, k] for k in range(3)], dim=-1)
    return enc.jt(ghx) + hess, hins, gzs, gbs


def _launch_jvp_fwd(positions, weights, biases, skip, activation, beta, pe,
                    backward_images=False):
    """K4j's forward on the card: the pack of the weight images (with the
    backward images for `backward_images`, which the call's backward reuses)
    and the tangent pass, two device operations. Returns (sdf, geo, grad, the
    Packed images or None for N = 0)."""
    check_card(positions, activation, len(weights), "fused_sdf_chain (jvp mode)")
    pos = positions.float().contiguous()
    layout, geom = chain_of(3 + 6 * len(pe), weights, skip, activation, beta)
    n, dev = pos.shape[0], pos.device
    sdf, geo, grad = _sdf_outputs(n, layout.d_out, dev)
    if n == 0:
        return sdf, geo, grad, None
    packed = _launch_pack(layout, geom, weights, biases, backward_images)
    scratch = _scratch("mms_tangent_fwd_bytes", geom, dev, n, 3)
    status = entry("mms_sdf_chain_jvp_fwd")(
        ctypes.byref(geom), pos.data_ptr(), n, len(pe), build.float_array(pe),
        packed.wfw.data_ptr(), packed.bpk.data_ptr(), sdf.data_ptr(), geo.data_ptr(),
        geo.shape[1], grad.data_ptr(), scratch.data_ptr() if scratch.numel() else None,
        _stream(dev))
    build.check(status, "fused_sdf_chain (jvp mode)")
    JVP_KERNEL.launches += 1
    return sdf, geo, grad, packed


def jvp_bwd_card(positions, weights, biases, skip, activation, beta, pe, gsdf, ggeo, g3,
                 count=None, packed=None):
    """K4j's backward on the card, prepared (N > 0): (Backward, d_pos), the
    pass writing d_pos [N, 3] f32 and gb and leaving the Hin and G stacks in
    scratch, chain_wgrad writing gW; on the forward's images `packed` where
    given."""
    check_card(positions, activation, len(weights), "fused_sdf_chain (jvp mode) backward")
    pos = positions.float().contiguous()
    n = pos.shape[0]
    layout, geom = chain_of(3 + 6 * len(pe), weights, skip, activation, beta)
    pe_arr = build.float_array(pe)
    cot = (gsdf.float().contiguous(), ggeo.to(torch.bfloat16).contiguous(),
           g3.float().contiguous())
    d_pos = torch.empty((n, 3), dtype=torch.float32, device=pos.device)

    def pass_args(packed, gw, gb, scratch, _extra):
        return ("mms_sdf_chain_jvp_bwd", pos.data_ptr(), n, len(pe), pe_arr, cot[0].data_ptr(),
                cot[1].data_ptr(), ggeo.shape[1], cot[2].data_ptr(), packed.wfw.data_ptr(),
                packed.wbw.data_ptr(), packed.bpk.data_ptr(), d_pos.data_ptr(), gb.data_ptr(),
                scratch.data_ptr())

    bw = prepare_backward(layout, geom, weights, biases, pos.device,
                          ("mms_tangent_bwd_bytes", n, 3), pass_args,
                          -(-n // tangent_samples(3)), "fused_sdf_chain (jvp mode) backward", count,
                          packed=packed)
    bw.keep = (pos, pe_arr, *cot)
    return bw, d_pos


def _launch_jvp_bwd(positions, weights, biases, skip, activation, beta, pe, gsdf, ggeo, g3,
                    packed=None):
    """K4j's backward: the per-tile pass and chain_wgrad over its stacks (on
    the forward's images `packed`, or a pack of its own). Returns (d_pos, gW
    list, gb list)."""
    if positions.shape[0] == 0:
        check_card(positions, activation, len(weights), "fused_sdf_chain (jvp mode) backward")
        return (torch.empty((0, 3), device=positions.device),
                *zero_grads(chain_of(3 + 6 * len(pe), weights, skip, activation, beta)[0],
                            positions.device))
    bw, d_pos = jvp_bwd_card(positions, weights, biases, skip, activation, beta, pe, gsdf, ggeo,
                             g3, packed=packed)
    bw.tile()
    JVP_BWD_KERNEL.launches += 1
    bw.wgrad()
    JVP_WGRAD_KERNEL.launches += 1
    return d_pos, bw.gws, bw.gbs


# (plain forward, plain backward, forward kernel, backward kernel) per mode
_ROUTES = {
    "adjoint": (fused_sdf_chain_plain, fused_sdf_chain_bwd_plain, _launch_fwd, _launch_bwd),
    "jvp": (fused_sdf_chain_jvp_plain, fused_sdf_chain_jvp_bwd_plain, _launch_jvp_fwd,
            _launch_jvp_bwd),
}


class _SdfChain(torch.autograd.Function):
    """K4 or K4j with its backward (chain_fwd / chain_bwd :901-916,
    :1004-1022): saves the positions and parameters, and on the card the
    images the forward's pack wrote (backward images included); the
    backward recomputes per tile on those images."""

    @staticmethod
    def forward(ctx, cfg, positions, *params):
        ws, bs = params[: len(params) // 2], params[len(params) // 2 :]
        ctx.cfg = cfg
        ctx.save_for_backward(positions, *params)
        ctx.packed = None
        out = _forward(positions, ws, bs, *cfg, backward_images=True)
        if positions.device.type != "cpu":
            *out, ctx.packed = out
        return tuple(out)

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
                                         kw["beta"], pe, gsdf, ggeo, g3, ctx.packed)
        ctx.packed = None
        return (None, d_pos.to(positions.dtype), *gws, *gbs)


def _forward(positions, weights, biases, kw, pe, mode, backward_images=False):
    """The plain version for a CPU tensor, the kernel for any other (which
    raises off a card); with `backward_images`, the kernel's outputs and the
    images of its pack, which the backward reuses."""
    plain, _, launch, _ = _ROUTES[mode]
    if positions.device.type == "cpu":
        return plain(positions, weights, biases, **kw)
    if mode == "jvp":
        out = launch(positions, weights, biases, kw["skip"], kw["activation"], kw["beta"], pe,
                     backward_images)
    else:
        out = launch(positions, weights, biases, kw["skip"], kw["activation"], kw["beta"], pe)
    return out if backward_images else out[:3]


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


def _launch_adj_fwd(x, weights, biases, skip, activation, beta, channel):
    """K5's forward on the card: the pack of the weight images (the backward
    images included: the adjoint sweep reads them, and the call's backward
    reuses them), then the pass, two device operations. x is read as it is
    (f32 or bf16) and rounded to bf16 in the kernel. Returns (y, adj, the
    Packed images or None for N = 0)."""
    check_card(x, activation, len(weights), "fused_chain_adjoint")
    layout, geom = chain_of(x.shape[1], weights, skip, activation, beta, adjoint=True)
    n, d_in, dev = x.shape[0], x.shape[1], x.device
    y = torch.empty((n, layout.d_out), dtype=torch.bfloat16, device=dev)
    adj = torch.empty((n, d_in), dtype=torch.float32, device=dev)
    if n == 0:
        return y, adj, None
    xc = _card_operand(x)
    packed = _launch_pack(layout, geom, weights, biases, True)
    scratch = _scratch("mms_adj_fwd_bytes", geom, dev, n)
    status = entry("mms_chain_adj_fwd")(
        ctypes.byref(geom), xc.data_ptr(), int(xc.dtype == torch.bfloat16), n, channel,
        packed.wfw.data_ptr(), packed.wbw.data_ptr(), packed.bpk.data_ptr(), y.data_ptr(),
        layout.d_out, adj.data_ptr(), scratch.data_ptr(), _stream(dev))
    build.check(status, "fused_chain_adjoint")
    ADJ_KERNEL.launches += 1
    return y, adj, packed


def adj_bwd_card(x, weights, biases, skip, activation, beta, channel, gy, ga, count=None,
                 packed=None):
    """K5's backward on the card, prepared (N > 0): (Backward, gx), the pass
    writing gx [N, D_in] bf16, gb and the last layer's column term of gW and
    leaving the A and B stacks in scratch, chain_wgrad adding the stacked gW;
    on the forward's images `packed` where given. count (an int64 tensor or
    None) receives the gW atomics of both."""
    check_card(x, activation, len(weights), "fused_chain_adjoint backward")
    n, d_in = x.shape
    layout, geom = chain_of(d_in, weights, skip, activation, beta, adjoint=True)
    xb = _aligned(x.to(torch.bfloat16))
    cot = (_aligned(gy.to(torch.bfloat16)), _aligned(ga.float()))
    gx = torch.empty((n, d_in), dtype=torch.bfloat16, device=x.device)
    cp = None if count is None else count.data_ptr()

    def pass_args(packed, gw, gb, scratch, _extra):
        return ("mms_chain_adj_bwd", xb.data_ptr(), n, channel, cot[0].data_ptr(),
                cot[1].data_ptr(), packed.wfw.data_ptr(), packed.wbw.data_ptr(),
                packed.bpk.data_ptr(), gx.data_ptr(), gw.data_ptr(), gb.data_ptr(),
                scratch.data_ptr(), cp)

    bw = prepare_backward(layout, geom, weights, biases, x.device, ("mms_adj_bwd_bytes", n),
                          pass_args, -(-n // 64), "fused_chain_adjoint backward", count,
                          packed=packed)
    bw.keep = (xb, *cot)
    return bw, gx


def _launch_adj_bwd(x, weights, biases, skip, activation, beta, channel, gy, ga, packed=None):
    """K5's backward: the per-tile pass and chain_wgrad over its stacks (on
    the forward's images `packed`, or a pack of its own). Returns (gx, gW
    list, gb list)."""
    if x.shape[0] == 0:
        check_card(x, activation, len(weights), "fused_chain_adjoint backward")
        return (torch.empty(x.shape, dtype=torch.bfloat16, device=x.device),
                *zero_grads(chain_of(x.shape[1], weights, skip, activation, beta, True)[0],
                            x.device))
    bw, gx = adj_bwd_card(x, weights, biases, skip, activation, beta, channel, gy, ga,
                          packed=packed)
    bw.tile()
    ADJ_BWD_KERNEL.launches += 1
    bw.wgrad()
    ADJ_WGRAD_KERNEL.launches += 1
    return gx, bw.gws, bw.gbs


def _adj_forward(x, weights, biases, kw):
    """The plain version for a CPU tensor, the kernel for any other (which
    raises off a card): (y, adj), and on the card the images of its pack."""
    if x.device.type == "cpu":
        return fused_chain_adjoint_plain(x, weights, biases, **kw)
    return _launch_adj_fwd(x, weights, biases, kw["skip"], kw["activation"], kw["beta"],
                           kw["channel"])


class _ChainAdjoint(torch.autograd.Function):
    """K5 with its backward (chain_fwd / chain_bwd :1004-1022): saves x and
    the parameters, and on the card the images the forward's pack wrote; the
    backward recomputes per tile on those images."""

    @staticmethod
    def forward(ctx, kw, x, *params):
        ws, bs = params[: len(params) // 2], params[len(params) // 2 :]
        ctx.kw = kw
        ctx.save_for_backward(x, *params)
        ctx.packed = None
        out = _adj_forward(x, ws, bs, kw)
        if x.device.type != "cpu":
            *out, ctx.packed = out
        return tuple(out)

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
                                           kw["channel"], gy, ga, ctx.packed)
        ctx.packed = None
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
    if x.shape[1] != weights[0].shape[0]:
        raise ValueError(f"fused_chain_adjoint: input width {x.shape[1]} != layer 0's "
                         f"{weights[0].shape[0]}")
    if not 0 <= channel < weights[-1].shape[1]:
        raise ValueError(f"fused_chain_adjoint: channel {channel} out of range")
    kw = dict(skip=skip, activation=activation, beta=beta, channel=channel)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *weights, *biases)):
        return _ChainAdjoint.apply(kw, x, *weights, *biases)
    return _adj_forward(x, weights, biases, kw)[:2]
