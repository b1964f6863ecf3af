"""Fused slot-grid + MLP SDF: kernels K2 and K3, forward and backward, and
their plain versions.

One CUDA kernel (csrc/slot_fused.cu) runs, for a tile of samples, the cell
geometry from raw positions, the packed-entry table read and trilerp, the
coarse-to-fine mask, the in-kernel NeRF encoding and the dense chain:

* `fused_slot_sdf_value` (K2) emits sdf only. It replaces the Pallas TPU
  kernel multimodalstudio_tpu/ops/pallas/slot_fused.py::_value_fwd_kernel
  (:1307), reached through fused_slot_sdf_value (:1772).
* `fused_slot_sdf_chain` (K3) also emits the geometric features and d sdf/dx
  from one reverse sweep of the chain. It replaces _fused_fwd_kernel (:353),
  reached through fused_slot_sdf_chain (:1197).

Both are bound on an H100 by the chain's tensor-core work; the bf16 table
(768 KB at the flagship size) stays in L2, and each (sample, level) reads
one 32-byte entry.

The plain versions repeat the JAX kernel's cast points (slot_fused.py:399-
416, 427-458): table and trilerp weight rounded to bf16, their product
rounded to bf16 before the 8-corner f32 sum, that sum times the mask
rounded to bf16 into the chain input; the NeRF encoding computes cos
directly (fused_mlp.py:192-196); act' of the adjoint sweep reads the
bf16-stored pre-activations; sdf is f32 and geo bf16.

With grad enabled both run as autograd Functions. Their forward launches
the same kernel in a training mode that also writes the residuals the
backward reads (bf16 pre-activations zs; for K3 the adjoint-sweep rows ss
and the f32 adjoint adj, slot_fused.py:1092-1094). The backwards are the
CUDA kernels of csrc/slot_fused_bwd.cu:

* K2's replaces _value_bwd_kernel (:1370, via op_bwd :1737): one reverse
  sweep from the sdf cotangent, the grid slice of the input cotangent
  scattered into the table through the bf16 trilerp weights, and the
  trilerp weight cotangent folded into d pos (_fold_pos_cotangent :330).
* K3's replaces _fused_bwd_kernel (:474, via op_bwd :1149): reverse over
  reverse, since the outputs include d sdf / dx. The cotangent of the
  adjoint (through the PE and grid tangents) runs a forward chain that
  gives the adjoint path's weight gradients and the act'' injections e_l;
  the standard reverse sweep adds them; the position cotangent adds the PE
  Hessian term and the second-order trilerp fold.

The plain backwards write these steps out with the kernels' cast points
(gz rounded to bf16 before both products, each sample's table cotangent
rounded to bf16 before the f32 sum, d pos, gW and gb f32) rather than
differentiating the plain forward, whose bf16 roundings autograd would
put on the gradients at other places.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
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
    unpack_grads,
)
from multimodalstudio_tpu_torch.ops.kernels.slot_grid import (
    CLIP_HI,
    LANE,
    NSLOT,
    SlotGridSpec,
    cell_factors,
)

VALUE_KERNEL = build.register(
    "fused_slot_sdf_value",
    source="multimodalstudio_tpu_torch/csrc/slot_fused.cu",
    replaces="multimodalstudio_tpu/ops/pallas/slot_fused.py:1307",
)
CHAIN_KERNEL = build.register(
    "fused_slot_sdf_chain",
    source="multimodalstudio_tpu_torch/csrc/slot_fused.cu",
    replaces="multimodalstudio_tpu/ops/pallas/slot_fused.py:353",
)
VALUE_BWD_KERNEL = build.register(
    "fused_slot_sdf_value_bwd",
    source="multimodalstudio_tpu_torch/csrc/slot_fused_bwd.cu",
    replaces="multimodalstudio_tpu/ops/pallas/slot_fused.py:1370",
)
CHAIN_BWD_KERNEL = build.register(
    "fused_slot_sdf_chain_bwd",
    source="multimodalstudio_tpu_torch/csrc/slot_fused_bwd.cu",
    replaces="multimodalstudio_tpu/ops/pallas/slot_fused.py:474",
)


def pe_scales(num_frequencies: int, min_freq_exp: float, max_freq_exp: float) -> np.ndarray:
    """Frequency scale 2^(min + i * step) per frequency, in f32."""
    step = 0.0 if num_frequencies == 1 else (max_freq_exp - min_freq_exp) / (num_frequencies - 1)
    exps = np.float32(min_freq_exp) + np.arange(num_frequencies, dtype=np.float32) * np.float32(step)
    return np.exp2(exps).astype(np.float32)


def _check(gspec: SlotGridSpec, skip, activation: str) -> None:
    if gspec.layout != "cell" or gspec.table_dtype != "bf16":
        raise ValueError("the fused slot kernels take the cell layout with a bf16 table")
    if skip:
        raise ValueError("the fused slot kernels take chains without skip connections")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unsupported fused activation {activation}")


def _mask(level_mask: Optional[torch.Tensor], width: int, like: torch.Tensor) -> torch.Tensor:
    if level_mask is None:
        return torch.ones(width, dtype=torch.float32, device=like.device)
    return level_mask.float().reshape(width).contiguous()


class PEncoding:
    """The NeRF encoding of positions [N, 3] as the fused kernels compute it
    (fused_mlp.py:181-260): x0 = bf16([x, sin(x_d s_i), cos(x_d s_i)]),
    d-major, cos computed directly; its Jacobian transpose, its Hessian
    diagonal and the cotangent its bf16 basis tangents carry."""

    def __init__(self, positions: torch.Tensor, scales):
        n = positions.shape[0]
        self.scale = torch.as_tensor(scales, device=positions.device)
        self.scaled = positions[:, :, None] * self.scale  # [N, 3, F]
        flat = self.scaled.reshape(n, -1)
        self.x0 = bf16_round(torch.cat([positions, torch.sin(flat), torch.cos(flat)], dim=-1))

    def _parts(self, a):
        n, f = a.shape[0], self.scale.shape[0]
        return a[:, 3 : 3 + 3 * f].reshape(n, 3, f), a[:, 3 + 3 * f : 3 + 6 * f].reshape(n, 3, f)

    def jt(self, a: torch.Tensor) -> torch.Tensor:
        """J_enc^T a [N, 3] for an encoding-level cotangent a (_enc_jt)."""
        gs, gc = self._parts(a)
        s = self.scale
        return a[:, :3] + (gs * (torch.cos(self.scaled) * s)
                           + gc * (-torch.sin(self.scaled) * s)).sum(-1)

    def hess(self, a: torch.Tensor) -> torch.Tensor:
        """<a, d^2 enc / d x_k^2> [N, 3] (enc'' = -s^2 enc)."""
        gs, gc = self._parts(a)
        s = self.scale
        return (gs * (-torch.sin(self.scaled) * s * s)
                + gc * (-torch.cos(self.scaled) * s * s)).sum(-1)

    def tangent_cotangent(self, g3: torch.Tensor) -> torch.Tensor:
        """sum_k g3_k bf16(t0_k) [N, 3+6F]: the cotangent g3 of d/dx carried
        onto the encoding through its bf16 basis tangents."""
        n, s = g3.shape[0], self.scale
        g = g3[:, :, None]
        return torch.cat([g3, (g * bf16_round(torch.cos(self.scaled) * s)).reshape(n, -1),
                          (g * bf16_round(-torch.sin(self.scaled) * s)).reshape(n, -1)], dim=-1)


class _Front:
    """The plain front end of one sample batch: cell geometry (idx, per-axis
    trilerp factors, clip gate), the bf16 corner values T [N, k, F, 8], the
    bf16 trilerp weights wb [N, k, 8], the position encoding pe and the
    chain input x0 [N, 3+6F_pe + num_levels*F] (bf16 values in f32)."""

    def __init__(self, pos, table, gspec, k, radius, mask, pe):
        n, feats = pos.shape[0], gspec.feats
        graw = (pos + radius) / (2.0 * radius)
        x = graw.clamp(0.0, CLIP_HI)
        self.gate = ((graw > 0.0) & (graw < CLIP_HI)).float()
        self.idx, self.wa, self.dwa, self.ddwa = cell_factors(x, gspec, k)
        entries = bf16_round(table).reshape(-1, NSLOT * feats)  # one row per absolute entry
        self.T = entries[self.idx].reshape(n, k, feats, NSLOT)
        wa = self.wa
        self.wb = bf16_round(wa[..., 0] * wa[..., 1] * wa[..., 2])
        encg = bf16_round(bf16_round(self.T * self.wb[:, :, None, :]).sum(-1)
                          * mask.reshape(1, k, feats))
        self.pe = PEncoding(pos, pe)
        pad = (gspec.num_levels - k) * feats
        self.x0 = torch.cat([self.pe.x0, encg.reshape(n, k * feats), pos.new_zeros(n, pad)], dim=-1)

    def axis_factor(self, t: int) -> torch.Tensor:
        """D_t = dwa_t * wa_u * wa_v [N, k, 8]: d w / d g_t."""
        u, v = (t + 1) % 3, (t + 2) % 3
        return self.dwa[..., t] * self.wa[..., u] * self.wa[..., v]


def _chain(x0, weights, biases, activation, beta):
    """Plain chain forward: (last layer z in f32, bf16-rounded hidden z's)."""
    return chain_forward(x0, weights, biases, (), activation, beta)


def _levels(gspec: SlotGridSpec, num_levels) -> int:
    return gspec.num_levels if num_levels is None else min(int(num_levels), gspec.num_levels)


def _value_fwd_plain(positions, table, weights, biases, gspec, k, radius, pe, activation, beta,
                     mask):
    """(sdf [N] f32, zs [L-1, N, H] bf16)."""
    front = _Front(positions.float(), table, gspec, k, radius, mask, pe)
    y, zs = _chain(front.x0, weights, biases, activation, beta)
    return y[:, 0], _stack(zs, y)


def _stack(rows, like):
    if not rows:
        return like.new_zeros((0, like.shape[0], 0), dtype=torch.bfloat16)
    return torch.stack(rows).to(torch.bfloat16)


def slot_sdf_value_plain(
    positions, table, weights, biases, gspec: SlotGridSpec, *, radius, num_frequencies,
    min_freq_exp, max_freq_exp, skip=(), activation="SoftplusQuad", beta=100.0,
    level_mask=None, num_levels=None,
):
    """Plain PyTorch version of K2: sdf [N] f32."""
    _check(gspec, skip, activation)
    k = _levels(gspec, num_levels)
    pe = pe_scales(num_frequencies, min_freq_exp, max_freq_exp)
    mask = _mask(level_mask, k * gspec.feats, positions)
    return _value_fwd_plain(positions, table, weights, biases, gspec, k, radius, pe, activation,
                            beta, mask)[0]


def _chain_fwd_plain(positions, table, weights, biases, gspec, radius, pe, activation, beta,
                     mask):
    """(sdf [N] f32, geo [N, D_out-1] bf16, grad [N, 3] f32) and the
    backward's residuals (zs, ss [L-1, N, H] bf16, adj [N, D_in] f32)."""
    k, feats = gspec.num_levels, gspec.feats
    n = positions.shape[0]
    pos = positions.float()
    front = _Front(pos, table, gspec, k, radius, mask, pe)
    y, zs = _chain(front.x0, weights, biases, activation, beta)
    # the rows s of layers l >= 1 of the adjoint sweep are the backward's
    # residual ss[l-1]
    adj, ss = adjoint_sweep(front.x0, zs, weights, (), activation, beta)

    # grid part: sum comp * bf16(dw_k / 2r) * bf16(adj_grid * mask) (slot_fused.py:445-458)
    pw = 3 + 6 * len(pe)
    a = bf16_round(adj[:, pw : pw + k * feats].reshape(n, k, feats) * mask.reshape(k, feats))
    cs = 1.0 / (2.0 * radius)
    grid = [(front.T * bf16_round(front.axis_factor(t) * cs)[:, :, None, :] * a[..., None])
            .sum(dim=(1, 2, 3)) for t in range(3)]
    grad = front.pe.jt(adj) + torch.stack(grid, -1)
    residuals = (_stack(zs, y), _stack(ss, y), adj.contiguous())
    return (y[:, 0], y[:, 1:].to(torch.bfloat16), grad), residuals


def slot_sdf_chain_plain(
    positions, table, weights, biases, gspec: SlotGridSpec, *, radius, num_frequencies,
    min_freq_exp, max_freq_exp, skip=(), activation="SoftplusQuad", beta=100.0,
    level_mask=None,
):
    """Plain PyTorch version of K3: (sdf [N] f32, geo [N, D_out-1] bf16,
    grad [N, 3] f32 = d sdf / d positions)."""
    _check(gspec, skip, activation)
    pe = pe_scales(num_frequencies, min_freq_exp, max_freq_exp)
    mask = _mask(level_mask, gspec.num_levels * gspec.feats, positions)
    return _chain_fwd_plain(positions, table, weights, biases, gspec, radius, pe, activation,
                            beta, mask)[0]


def _scatter_table(table, gspec, idx, d_comp):
    """d_table [rows, 128] f32: bf16(d_comp [N, k, F, 8]) added into each
    sample's entry (the one-hot scatter of slot_fused.py:201-236)."""
    width = NSLOT * gspec.feats
    d = torch.zeros(table.shape[0] * (LANE // width), width, device=table.device)
    d.index_add_(0, idx.reshape(-1), bf16_round(d_comp).reshape(-1, width))
    return d.reshape(table.shape)


def slot_sdf_value_bwd_plain(
    positions, table, weights, biases, gspec: SlotGridSpec, zs, gsdf, *, radius, num_frequencies,
    min_freq_exp, max_freq_exp, skip=(), activation="SoftplusQuad", beta=100.0,
    level_mask=None, num_levels=None,
):
    """Plain PyTorch version of K2's backward (_value_bwd_kernel :1370-1482):
    residuals zs [L-1, N, H] bf16 and the sdf cotangent gsdf [N] in; returns
    (d_pos [N, 3] f32, d_table [rows, 128] f32, gW list f32, gb list f32)."""
    _check(gspec, skip, activation)
    k, feats = _levels(gspec, num_levels), gspec.feats
    pe = pe_scales(num_frequencies, min_freq_exp, max_freq_exp)
    mask = _mask(level_mask, k * feats, positions).reshape(k, feats)
    n = positions.shape[0]
    front = _Front(positions.float(), table, gspec, k, radius, mask, pe)
    gy = front.x0.new_zeros(n, weights[-1].shape[1])
    gy[:, 0] = gsdf.float()
    ghin, gws, gbs = reverse_sweep(front.x0, zs, gy, weights, (), activation, beta)

    pw = 3 + 6 * len(pe)
    gt0 = bf16_round(ghin[:, pw : pw + k * feats].reshape(n, k, feats) * mask)
    d_table = _scatter_table(table, gspec, front.idx, gt0[..., None] * front.wb[:, :, None, :])
    d_w = bf16_round(front.T * gt0[..., None]).sum(2)  # [N, k, 8]
    cs = 1.0 / (2.0 * radius)
    gpos = torch.stack([(d_w * front.axis_factor(t)).sum((1, 2)) for t in range(3)], -1)
    d_pos = front.pe.jt(ghin) + gpos * (front.gate * cs)
    return d_pos, d_table, gws, gbs


def slot_sdf_chain_bwd_plain(
    positions, table, weights, biases, gspec: SlotGridSpec, zs, ss, adj, gsdf, ggeo, g3, *,
    radius, num_frequencies, min_freq_exp, max_freq_exp, skip=(), activation="SoftplusQuad",
    beta=100.0, level_mask=None,
):
    """Plain PyTorch version of K3's backward (_fused_bwd_kernel :474-735),
    reverse-over-reverse through the chain and the grid: residuals zs, ss
    [L-1, N, H] bf16 and adj [N, D_in] f32, cotangents gsdf [N], ggeo
    [N, D_out-1] (bf16) and g3 [N, 3] in; returns (d_pos [N, 3] f32,
    d_table [rows, 128] f32, gW list f32, gb list f32)."""
    _check(gspec, skip, activation)
    k, feats = gspec.num_levels, gspec.feats
    kf = k * feats
    pe = pe_scales(num_frequencies, min_freq_exp, max_freq_exp)
    pw = 3 + 6 * len(pe)
    mask = _mask(level_mask, kf, positions).reshape(k, feats)
    n = positions.shape[0]
    front = _Front(positions.float(), table, gspec, k, radius, mask, pe)
    cs = 1.0 / (2.0 * radius)
    g3 = g3.float()
    T = front.T

    # ga = cotangent of adj (:586-601): the PE tangents and the grid tangents
    ga_pe = front.pe.tangent_cotangent(g3)
    D = [front.axis_factor(t) for t in range(3)]
    dwsum = g3[:, 0, None, None] * (D[0] * cs)
    dwsum = dwsum + g3[:, 1, None, None] * (D[1] * cs)
    dwsum = dwsum + g3[:, 2, None, None] * (D[2] * cs)
    dwg = bf16_round(dwsum)  # [N, k, 8]
    ga_g = bf16_round(T * dwg[:, :, None, :]).sum(-1) * mask  # [N, k, F]
    gc0 = bf16_round(adj[:, pw : pw + kf].reshape(n, k, feats) * mask)
    d_comp = gc0[..., None] * dwg[:, :, None, :]  # [N, k, F, 8]
    dd0 = bf16_round(T * gc0[..., None]).sum(2)  # [N, k, 8]
    ga = torch.cat([ga_pe, ga_g.reshape(n, kf), ga_pe.new_zeros(n, adj.shape[1] - pw - kf)], -1)

    # ga-forward chain (:603-638), then the standard reverse sweep with its
    # act'' injections (:648-694)
    gwd, inject = ga_forward(ga, zs, ss, weights, (), activation, beta)
    gy = torch.cat([gsdf.float()[:, None], ggeo.float()], dim=-1)
    ghin, gws, gbs = reverse_sweep(front.x0, zs, gy, weights, (), activation, beta,
                                   inject=inject, gw_extra=gwd)

    # grid slice of the input cotangent -> table scatter (:696-708)
    gt0 = bf16_round(ghin[:, pw : pw + kf].reshape(n, k, feats) * mask)
    d_comp = d_comp + gt0[..., None] * front.wb[:, :, None, :]
    d_w = bf16_round(T * gt0[..., None]).sum(2)
    d_table = _scatter_table(table, gspec, front.idx, d_comp)

    # position cotangent (:710-735): PE Jacobian transpose, the PE Hessian
    # term weighted by g3, and the second-order trilerp fold
    sec = g3 * front.pe.hess(adj)
    wa, dwa, ddwa = front.wa, front.dwa, front.ddwa
    cols = []
    for t in range(3):
        u, v = (t + 1) % 3, (t + 2) % 3
        acc = d_w * D[t]
        for kk in range(3):
            if kk == t:
                dD = ddwa[..., kk] * wa[..., u] * wa[..., v]
            else:
                dD = dwa[..., kk] * dwa[..., t] * wa[..., 3 - kk - t]
            acc = acc + cs * ((g3[:, kk, None, None] * dd0) * dD)
        cols.append(acc.sum((1, 2)))
    gpos = torch.stack(cols, -1) * (front.gate * cs)
    d_pos = front.pe.jt(ghin) + sec + gpos
    return d_pos, d_table, gws, gbs


_COMMON_TYPES = ("ptr", "int", "ptr", "ptr", "ptr", "ptr", "int", "ptr", "ptr", "int", "int",
                 "int", "float", "int", "int", "int", "ptr", "ptr", "ptr", "ptr", "float",
                 "float", "int", "int", "ptr")


class _CardArgs:
    """The packed operands and the geometry arguments every slot kernel
    entry point takes first (positions, table, mask, weights, grid and
    encoding constants); `keep` holds the tensors the pointers refer to."""

    def __init__(self, positions, table, weights, biases, gspec, k, radius, pe, activation, beta,
                 mask):
        _on_card(positions)
        if not 2 <= len(weights) <= 8:
            raise ValueError("the fused slot kernels take chains of 2 to 8 layers")
        self.n = positions.shape[0]
        self.d_in = 3 + 6 * len(pe) + gspec.num_levels * gspec.feats
        self.in_dims, self.out_dims, p0, self.hidden = chain_geometry(self.d_in, weights, ())
        wpack, bpack = pack_chain(weights, biases, self.in_dims, self.out_dims, self.hidden, ())
        pos = positions.float().contiguous()
        tbl = table.to(torch.bfloat16).contiguous()
        if tbl.shape != (gspec.total_rows, 128):
            raise ValueError(f"table shape {tuple(tbl.shape)} != ({gspec.total_rows}, 128)")
        self.keep = (pos, tbl, mask, wpack, bpack)
        res = gspec.resolutions[:k]
        self.args = [
            build.ptr(pos), self.n, build.ptr(tbl), build.ptr(mask), build.ptr(wpack),
            build.ptr(bpack), len(weights), build.int_array(self.in_dims),
            build.int_array(self.out_dims), self.hidden, p0, ACTIVATIONS[activation], 2.0 / beta,
            k, gspec.feats, gspec.entries_per_row.bit_length() - 1, build.int_array(res),
            build.int_array(res.astype(np.int64) ** 3 <= gspec.rows_per_level),
            build.int_array(gspec.level_entries[:k] - 1), build.int_array(gspec.level_offsets[:k]),
            float(radius), CLIP_HI, int(gspec.interpolation == "Smoothstep"), len(pe),
            build.float_array(pe),
        ]
        self.stream = build.stream_of(pos)

    def grads(self, weights, dev):
        """Zeroed packed gradient buffers (gw, gb) and their unpacker."""
        gw = torch.zeros(sum(a * b for a, b in zip(self.in_dims, self.out_dims)), device=dev)
        gb = torch.zeros(sum(self.out_dims), device=dev)
        return gw, gb, lambda: unpack_grads(gw, gb, weights, self.in_dims, self.out_dims,
                                            self.hidden, ())


def _launch(positions, table, weights, biases, gspec, k, radius, pe, activation, beta,
            mask, with_grad, resid=False):
    """Launch the forward kernel; returns (sdf, geo, grad, zs, ss, adj): geo
    and grad without `with_grad` and the backward's residuals without
    `resid` are None (ss and adj come with the gradient only)."""
    ca = _CardArgs(positions, table, weights, biases, gspec, k, radius, pe, activation, beta, mask)
    dev, n = positions.device, ca.n
    d_out = weights[-1].shape[1]
    sdf = torch.empty(n, dtype=torch.float32, device=dev)
    geo = grad = zs = ss = adj = None
    if with_grad:
        geo = torch.empty((n, d_out - 1), dtype=torch.bfloat16, device=dev)
        grad = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if resid:
        zs = torch.empty((len(weights) - 1, n, ca.hidden), dtype=torch.bfloat16, device=dev)
        if with_grad:
            ss = torch.empty_like(zs)
            adj = torch.empty((n, ca.d_in), dtype=torch.float32, device=dev)
    if n:
        fn = build.function("slot_fused", "mms_slot_sdf_fwd", *_COMMON_TYPES,
                            "ptr", "ptr", "int", "ptr", "int", "ptr", "ptr", "ptr", "int", "ptr")
        status = fn(*ca.args, build.ptr(sdf), build.ptr(geo), d_out - 1, build.ptr(grad),
                    int(with_grad), build.ptr(zs), build.ptr(ss), build.ptr(adj), ca.d_in,
                    ca.stream)
        build.check(status, "fused slot sdf")
        (CHAIN_KERNEL if with_grad else VALUE_KERNEL).launches += 1
    return sdf, geo, grad, zs, ss, adj


def _launch_value_bwd(positions, table, weights, biases, gspec, k, radius, pe, activation, beta,
                      mask, zs, gsdf):
    """K2's backward kernel: (d_pos, d_table, gW list, gb list)."""
    ca = _CardArgs(positions, table, weights, biases, gspec, k, radius, pe, activation, beta, mask)
    dev = positions.device
    d_pos = torch.empty((ca.n, 3), dtype=torch.float32, device=dev)
    d_table = torch.zeros(table.shape, dtype=torch.float32, device=dev)
    gw, gb, unpack = ca.grads(weights, dev)
    if ca.n:
        fn = build.function("slot_fused_bwd", "mms_slot_value_bwd", *_COMMON_TYPES,
                            "ptr", "ptr", "ptr", "ptr", "ptr", "ptr", "ptr")
        g = gsdf.float().contiguous()
        status = fn(*ca.args, build.ptr(zs), build.ptr(g), build.ptr(d_pos), build.ptr(d_table),
                    build.ptr(gw), build.ptr(gb), ca.stream)
        build.check(status, "fused slot sdf value backward")
        VALUE_BWD_KERNEL.launches += 1
    return (d_pos, d_table, *unpack())


def _launch_chain_bwd(positions, table, weights, biases, gspec, radius, pe, activation, beta,
                      mask, zs, ss, adj, gsdf, ggeo, g3):
    """K3's backward kernel: (d_pos, d_table, gW list, gb list)."""
    ca = _CardArgs(positions, table, weights, biases, gspec, gspec.num_levels, radius, pe,
                   activation, beta, mask)
    dev = positions.device
    d_pos = torch.empty((ca.n, 3), dtype=torch.float32, device=dev)
    d_table = torch.zeros(table.shape, dtype=torch.float32, device=dev)
    gw, gb, unpack = ca.grads(weights, dev)
    if ca.n:
        fn = build.function("slot_fused_bwd", "mms_slot_chain_bwd", *_COMMON_TYPES,
                            "ptr", "ptr", "ptr", "int", "ptr", "ptr", "int", "ptr", "ptr", "ptr",
                            "ptr", "ptr", "ptr")
        cot = (gsdf.float().contiguous(), ggeo.to(torch.bfloat16).contiguous(),
               g3.float().contiguous())
        status = fn(*ca.args, build.ptr(zs), build.ptr(ss), build.ptr(adj), ca.d_in,
                    build.ptr(cot[0]), build.ptr(cot[1]), ggeo.shape[1], build.ptr(cot[2]),
                    build.ptr(d_pos), build.ptr(d_table), build.ptr(gw), build.ptr(gb), ca.stream)
        build.check(status, "fused slot sdf chain backward")
        CHAIN_BWD_KERNEL.launches += 1
    return (d_pos, d_table, *unpack())


def _on_card(positions: torch.Tensor) -> bool:
    if positions.device.type == "cpu":
        return False
    if positions.device.type != "cuda":
        raise ValueError(f"unsupported device {positions.device}")
    return True


class _SlotValue(torch.autograd.Function):
    """K2 with its backward (op_fwd/op_bwd :1728-1766): the forward keeps
    the bf16 pre-activations; the mask's cotangent is dropped (:1765)."""

    @staticmethod
    def forward(ctx, cfg, positions, table, mask, *params):
        gspec, k, pe, kw = cfg
        ws, bs = params[: len(params) // 2], params[len(params) // 2 :]
        if _on_card(positions):
            sdf, _, _, zs, _, _ = _launch(positions, table, ws, bs, gspec, k, kw["radius"], pe,
                                          kw["activation"], kw["beta"], mask, False, resid=True)
        else:
            sdf, zs = _value_fwd_plain(positions, table, ws, bs, gspec, k, kw["radius"], pe,
                                       kw["activation"], kw["beta"], mask)
        ctx.cfg = cfg
        ctx.save_for_backward(positions, table, mask, zs, *params)
        return sdf

    @staticmethod
    def backward(ctx, gsdf):
        gspec, k, pe, kw = ctx.cfg
        positions, table, mask, zs, *params = ctx.saved_tensors
        ws, bs = params[: len(params) // 2], params[len(params) // 2 :]
        if _on_card(positions):
            d_pos, d_table, gws, gbs = _launch_value_bwd(
                positions, table, ws, bs, gspec, k, kw["radius"], pe, kw["activation"],
                kw["beta"], mask, zs, gsdf)
        else:
            d_pos, d_table, gws, gbs = slot_sdf_value_bwd_plain(
                positions, table, ws, bs, gspec, zs, gsdf, level_mask=mask, num_levels=k, **kw)
        return (None, d_pos, d_table, None, *gws, *gbs)


class _SlotChain(torch.autograd.Function):
    """K3 with its backward (op_fwd/op_bwd :1140-1191): the forward keeps
    zs, ss and adj; the mask's cotangent is dropped (:1188-1190)."""

    @staticmethod
    def forward(ctx, cfg, positions, table, mask, *params):
        gspec, _, pe, kw = cfg
        ws, bs = params[: len(params) // 2], params[len(params) // 2 :]
        if _on_card(positions):
            sdf, geo, grad, zs, ss, adj = _launch(
                positions, table, ws, bs, gspec, gspec.num_levels, kw["radius"], pe,
                kw["activation"], kw["beta"], mask, True, resid=True)
        else:
            (sdf, geo, grad), (zs, ss, adj) = _chain_fwd_plain(
                positions, table, ws, bs, gspec, kw["radius"], pe, kw["activation"], kw["beta"],
                mask)
        ctx.cfg = cfg
        ctx.save_for_backward(positions, table, mask, zs, ss, adj, *params)
        return sdf, geo, grad

    @staticmethod
    def backward(ctx, gsdf, ggeo, g3):
        gspec, _, pe, kw = ctx.cfg
        positions, table, mask, zs, ss, adj, *params = ctx.saved_tensors
        ws, bs = params[: len(params) // 2], params[len(params) // 2 :]
        ggeo = ggeo.to(torch.bfloat16)  # op_bwd :1155
        if _on_card(positions):
            d_pos, d_table, gws, gbs = _launch_chain_bwd(
                positions, table, ws, bs, gspec, kw["radius"], pe, kw["activation"], kw["beta"],
                mask, zs, ss, adj, gsdf, ggeo, g3)
        else:
            d_pos, d_table, gws, gbs = slot_sdf_chain_bwd_plain(
                positions, table, ws, bs, gspec, zs, ss, adj, gsdf, ggeo, g3, level_mask=mask,
                **kw)
        return (None, d_pos, d_table, None, *gws, *gbs)


def _differentiable(positions, table, weights, biases) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in (positions, table, *weights, *biases))


def fused_slot_sdf_value(
    positions: torch.Tensor,
    table: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    gspec: SlotGridSpec,
    *,
    radius: float,
    num_frequencies: int,
    min_freq_exp: float,
    max_freq_exp: float,
    skip: Tuple[int, ...] = (),
    activation: str = "SoftplusQuad",
    beta: float = 100.0,
    level_mask: Optional[torch.Tensor] = None,
    num_levels: Optional[int] = None,
) -> torch.Tensor:
    """SDF values [N] f32 at raw positions [N, 3] (K2). num_levels keeps
    only the first k levels (their columns past k enter the chain as
    zeros); level_mask [k*F] is the coarse-to-fine mask of those levels.
    With grad enabled, differentiable in positions, table, weights and
    biases through K2's backward."""
    _check(gspec, skip, activation)
    k = _levels(gspec, num_levels)
    pe = pe_scales(num_frequencies, min_freq_exp, max_freq_exp)
    mask = _mask(level_mask, k * gspec.feats, positions)
    kw = dict(radius=radius, num_frequencies=num_frequencies, min_freq_exp=min_freq_exp,
              max_freq_exp=max_freq_exp, activation=activation, beta=beta)
    if _differentiable(positions, table, weights, biases):
        return _SlotValue.apply((gspec, k, pe, kw), positions, table, mask, *weights, *biases)
    if not _on_card(positions):
        return _value_fwd_plain(positions, table, weights, biases, gspec, k, radius, pe,
                                activation, beta, mask)[0]
    return _launch(positions, table, weights, biases, gspec, k, radius, pe, activation, beta,
                   mask, with_grad=False)[0]


def fused_slot_sdf_chain(
    positions: torch.Tensor,
    table: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    gspec: SlotGridSpec,
    *,
    radius: float,
    num_frequencies: int,
    min_freq_exp: float,
    max_freq_exp: float,
    skip: Tuple[int, ...] = (),
    activation: str = "SoftplusQuad",
    beta: float = 100.0,
    level_mask: Optional[torch.Tensor] = None,
):
    """(sdf [N] f32, geo [N, D_out-1] bf16, grad [N, 3] f32) at raw
    positions [N, 3] over all levels (K3); level_mask [num_levels*F]. With
    grad enabled, differentiable (second order through grad) in positions,
    table, weights and biases through K3's backward."""
    _check(gspec, skip, activation)
    pe = pe_scales(num_frequencies, min_freq_exp, max_freq_exp)
    mask = _mask(level_mask, gspec.num_levels * gspec.feats, positions)
    kw = dict(radius=radius, num_frequencies=num_frequencies, min_freq_exp=min_freq_exp,
              max_freq_exp=max_freq_exp, activation=activation, beta=beta)
    if _differentiable(positions, table, weights, biases):
        return _SlotChain.apply((gspec, gspec.num_levels, pe, kw), positions, table, mask,
                                *weights, *biases)
    if not _on_card(positions):
        return _chain_fwd_plain(positions, table, weights, biases, gspec, radius, pe, activation,
                                beta, mask)[0]
    return _launch(positions, table, weights, biases, gspec, gspec.num_levels, radius, pe,
                   activation, beta, mask, with_grad=True)[:3]
