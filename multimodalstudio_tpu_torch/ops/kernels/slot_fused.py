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
one 32-byte entry. A tile keeps the chain's residual stacks in shared
memory, or, where they do not fit (deeper chains), in a per-CTA slab of
device scratch that a persistent grid reuses tile after tile.

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
CUDA kernels of csrc/slot_bwd.cuh, entered through csrc/slot_fused_bwd.cu:

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

MMS_SLOT_BWD_SPLIT=1, read at call time as the JAX package reads it
(slot_fused.py:1274, 1851), selects the split backward for chains of at
least 2 layers. The forward then also keeps the chain input x0 (bf16
[N, P0], :1028-1032, 1626-1630), and the backward runs in three parts:

* (a) a per-sample pass, the CUDA kernels of csrc/slot_split.cu replacing
  _bwd_sample_kernel (:758, K3s) and _value_bwd_sample_kernel (:1485, K2s):
  everything the merged backward does per sample, without its weight
  gradient and table atomics. It writes d pos, each (sample, level)'s bf16
  table cotangent compact as [N, K, 8F] (the TPU's lane-padded
  [N, K*128] is a mechanism of its one-hot MXU scatter), and the stacks
  the weight gradients contract: gz [L-1, N, H] bf16, for K3 also ga
  [N, P0] and q [L-1, N, H] bf16;
* (b) a scatter of that cotangent into the f32 table gradient
  (csrc/slot_split.cu, replacing _bwd_scatter_kernel :925), recomputing
  each sample's entry from its position;
* (c) the weight gradients as dense products over the stacks
  (_wgrads_xla :938-977, _value_wgrads_xla :1567-1590), PyTorch matrix
  products on either device, as the JAX package leaves them to XLA.

The split differs from the merged backward in one rounding: gb of a hidden
layer sums the gz read back from the bf16 stack, where the merged one sums
the f32 gz.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from multimodalstudio_tpu_torch.ops.kernels import build
from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import (
    ACTIVATIONS,
    act_pair,
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
VALUE_SPLIT_KERNEL = build.register(
    "fused_slot_sdf_value_bwd_sample",
    source="multimodalstudio_tpu_torch/csrc/slot_split.cu",
    replaces="multimodalstudio_tpu/ops/pallas/slot_fused.py:1485",
)
CHAIN_SPLIT_KERNEL = build.register(
    "fused_slot_sdf_chain_bwd_sample",
    source="multimodalstudio_tpu_torch/csrc/slot_split.cu",
    replaces="multimodalstudio_tpu/ops/pallas/slot_fused.py:758",
)
SCATTER_KERNEL = build.register(
    "slot_table_scatter",
    source="multimodalstudio_tpu_torch/csrc/slot_split.cu",
    replaces="multimodalstudio_tpu/ops/pallas/slot_fused.py:925",
)


def bwd_split(n_layers: int) -> bool:
    """Whether the split backward runs: MMS_SLOT_BWD_SPLIT=1, read at each
    call, and a chain of at least 2 layers (slot_fused.py:1274-1275, 1851)."""
    return os.environ.get("MMS_SLOT_BWD_SPLIT", "0") == "1" and n_layers > 1


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

    def basis_tangents(self) -> torch.Tensor:
        """The bf16 basis tangents t0 [3, N, 3+6F] (_enc_fwd :199-211): the
        unit column of x_k, and cos(x_k s) s / -sin(x_k s) s in coordinate
        k's sin / cos columns."""
        n, f = self.scaled.shape[0], self.scale.shape[0]
        eye = torch.eye(3, dtype=self.scaled.dtype, device=self.scaled.device)
        mask = eye[:, None, :, None]  # [k, 1, d, 1]
        dsin = bf16_round(torch.cos(self.scaled) * self.scale)[None] * mask
        dcos = bf16_round(-torch.sin(self.scaled) * self.scale)[None] * mask
        return torch.cat([eye[:, None, :].expand(3, n, 3), dsin.reshape(3, n, 3 * f),
                          dcos.reshape(3, n, 3 * f)], dim=-1)

    def tangent_cotangent(self, g3: torch.Tensor) -> torch.Tensor:
        """sum_k g3_k bf16(t0_k) [N, 3+6F]: the cotangent g3 of d/dx carried
        onto the encoding through its bf16 basis tangents."""
        n, s = g3.shape[0], self.scale
        g = g3[:, :, None]
        return torch.cat([g3, (g * bf16_round(torch.cos(self.scaled) * s)).reshape(n, -1),
                          (g * bf16_round(-torch.sin(self.scaled) * s)).reshape(n, -1)], dim=-1)


def _cell_coords(pos, radius):
    """Grid coordinates in [0, 1) of raw positions [N, 3] and the clip gate
    (1 where the coordinate was not clipped)."""
    graw = (pos + radius) / (2.0 * radius)
    return graw.clamp(0.0, CLIP_HI), ((graw > 0.0) & (graw < CLIP_HI)).float()


class _Front:
    """The plain front end of one sample batch: cell geometry (idx, per-axis
    trilerp factors, clip gate), the bf16 corner values T [N, k, F, 8], the
    bf16 trilerp weights wb [N, k, 8], the position encoding pe and the
    chain input x0 [N, 3+6F_pe + num_levels*F] (bf16 values in f32)."""

    def __init__(self, pos, table, gspec, k, radius, mask, pe):
        n, feats = pos.shape[0], gspec.feats
        x, self.gate = _cell_coords(pos, radius)
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
    """(sdf [N] f32, zs [L-1, N, H] bf16, x0 [N, D_in] bf16)."""
    front = _Front(positions.float(), table, gspec, k, radius, mask, pe)
    y, zs = _chain(front.x0, weights, biases, activation, beta)
    return y[:, 0], _stack(zs, y), front.x0.to(torch.bfloat16)


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
    backward's residuals (zs, ss [L-1, N, H] bf16, adj [N, D_in] f32, x0
    [N, D_in] bf16)."""
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
    residuals = (_stack(zs, y), _stack(ss, y), adj.contiguous(), front.x0.to(torch.bfloat16))
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


def _scatter_table(gspec, idx, d_comp):
    """d_table [rows, 128] f32: bf16(d_comp [N, k, F, 8]) added into each
    sample's entry (the one-hot scatter of slot_fused.py:201-236)."""
    width = NSLOT * gspec.feats
    d = torch.zeros(gspec.total_rows * (LANE // width), width, device=d_comp.device)
    d.index_add_(0, idx.reshape(-1), bf16_round(d_comp).reshape(-1, width))
    return d.reshape(gspec.total_rows, LANE)


def _compact(d_comp):
    """The per-sample table cotangent d_comp [N, k, F, 8] as the split pass
    stores it: bf16 [N, k, 8F], each level's values in its entry's layout."""
    n, k = d_comp.shape[:2]
    return d_comp.to(torch.bfloat16).reshape(n, k, -1)


def _value_bwd_parts(positions, table, weights, gspec, zs, gsdf, k, radius, pe, activation, beta,
                     mask):
    """The per-sample math of K2's backward: (d_pos [N, 3] f32, the table
    cotangent d_comp [N, k, F, 8] f32, the entry indices [N, k], gW list, gb
    list, the bf16 gz stack [L-1, N, H])."""
    feats = gspec.feats
    mask = mask.reshape(k, feats)
    n = positions.shape[0]
    front = _Front(positions.float(), table, gspec, k, radius, mask, pe)
    gy = front.x0.new_zeros(n, weights[-1].shape[1])
    gy[:, 0] = gsdf.float()
    gzs = []
    ghin, gws, gbs = reverse_sweep(front.x0, zs, gy, weights, (), activation, beta, gzs=gzs)

    pw = 3 + 6 * len(pe)
    gt0 = bf16_round(ghin[:, pw : pw + k * feats].reshape(n, k, feats) * mask)
    d_comp = gt0[..., None] * front.wb[:, :, None, :]
    d_w = bf16_round(front.T * gt0[..., None]).sum(2)  # [N, k, 8]
    cs = 1.0 / (2.0 * radius)
    gpos = torch.stack([(d_w * front.axis_factor(t)).sum((1, 2)) for t in range(3)], -1)
    d_pos = front.pe.jt(ghin) + gpos * (front.gate * cs)
    return d_pos, d_comp, front.idx, gws, gbs, _stack(gzs, gy)


def slot_sdf_value_bwd_plain(
    positions, table, weights, biases, gspec: SlotGridSpec, zs, gsdf, *, radius, num_frequencies,
    min_freq_exp, max_freq_exp, skip=(), activation="SoftplusQuad", beta=100.0,
    level_mask=None, num_levels=None,
):
    """Plain PyTorch version of K2's backward (_value_bwd_kernel :1370-1482):
    residuals zs [L-1, N, H] bf16 and the sdf cotangent gsdf [N] in; returns
    (d_pos [N, 3] f32, d_table [rows, 128] f32, gW list f32, gb list f32)."""
    _check(gspec, skip, activation)
    k = _levels(gspec, num_levels)
    pe = pe_scales(num_frequencies, min_freq_exp, max_freq_exp)
    mask = _mask(level_mask, k * gspec.feats, positions)
    d_pos, d_comp, idx, gws, gbs, _ = _value_bwd_parts(positions, table, weights, gspec, zs, gsdf,
                                                       k, radius, pe, activation, beta, mask)
    return d_pos, _scatter_table(gspec, idx, d_comp), gws, gbs


def _chain_bwd_parts(positions, table, weights, gspec, zs, ss, adj, gsdf, ggeo, g3, radius, pe,
                     activation, beta, mask):
    """The per-sample math of K3's backward: (d_pos [N, 3] f32, the table
    cotangent d_comp [N, K, F, 8] f32, the entry indices [N, K], gW list, gb
    list, and the split's stacks: bf16 ga [N, D_in], q and gz [L-1, N, H])."""
    k, feats = gspec.num_levels, gspec.feats
    kf = k * feats
    pw = 3 + 6 * len(pe)
    mask = mask.reshape(k, feats)
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
    qs, gzs = [], []
    gwd, inject = ga_forward(ga, zs, ss, weights, (), activation, beta, qs=qs)
    gy = torch.cat([gsdf.float()[:, None], ggeo.float()], dim=-1)
    ghin, gws, gbs = reverse_sweep(front.x0, zs, gy, weights, (), activation, beta,
                                   inject=inject, gw_extra=gwd, gzs=gzs)

    # grid slice of the input cotangent -> the table cotangent (:696-708)
    gt0 = bf16_round(ghin[:, pw : pw + kf].reshape(n, k, feats) * mask)
    d_comp = d_comp + gt0[..., None] * front.wb[:, :, None, :]
    d_w = bf16_round(T * gt0[..., None]).sum(2)

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
    stacks = (ga.to(torch.bfloat16), _stack(qs, gy), _stack(gzs, gy))
    return d_pos, d_comp, front.idx, gws, gbs, stacks


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
    pe = pe_scales(num_frequencies, min_freq_exp, max_freq_exp)
    mask = _mask(level_mask, gspec.num_levels * gspec.feats, positions)
    d_pos, d_comp, idx, gws, gbs, _ = _chain_bwd_parts(
        positions, table, weights, gspec, zs, ss, adj, gsdf, ggeo, g3, radius, pe, activation,
        beta, mask)
    return d_pos, _scatter_table(gspec, idx, d_comp), gws, gbs


# ------------------------------------------------------------ split backward


def slot_sdf_value_bwd_sample_plain(positions, table, weights, gspec, zs, gsdf, *, radius, pe,
                                    activation, beta, mask, num_levels):
    """Plain version of K2s's per-sample pass (_value_bwd_sample_kernel
    :1485-1565): (d_pos [N, 3] f32, d_comp [N, k, 8F] bf16, gz [L-1, N, H]
    bf16)."""
    d_pos, d_comp, _, _, _, gzs = _value_bwd_parts(positions, table, weights, gspec, zs, gsdf,
                                                   num_levels, radius, pe, activation, beta, mask)
    return d_pos, _compact(d_comp), gzs


def slot_sdf_chain_bwd_sample_plain(positions, table, weights, gspec, zs, ss, adj, gsdf, ggeo, g3,
                                    *, radius, pe, activation, beta, mask):
    """Plain version of K3s's per-sample pass (_bwd_sample_kernel :758-922):
    (d_pos [N, 3] f32, d_comp [N, K, 8F] bf16, ga [N, D_in] bf16, q and gz
    [L-1, N, H] bf16)."""
    d_pos, d_comp, _, _, _, stacks = _chain_bwd_parts(
        positions, table, weights, gspec, zs, ss, adj, gsdf, ggeo, g3, radius, pe, activation,
        beta, mask)
    return (d_pos, _compact(d_comp), *stacks)


def slot_table_scatter_plain(positions, d_comp, gspec: SlotGridSpec, *, radius):
    """Plain version of the split's table scatter (_bwd_scatter_kernel
    :925-935): d_table [rows, 128] f32, each sample's bf16 d_comp [N, k, 8F]
    added into the entry its position falls in on each of the first k
    levels."""
    n, k = d_comp.shape[:2]
    idx = cell_factors(_cell_coords(positions.float(), radius)[0], gspec, k)[0]
    return _scatter_table(gspec, idx, d_comp.float().reshape(n, k, gspec.feats, NSLOT))


def split_weight_grads(weights, x0, zs, gy, gzs, activation, beta, ss=None, ga=None, qs=None,
                       channel=0):
    """The split backward's weight gradients from its stacks (_wgrads_xla
    :938-977; _value_wgrads_xla :1567-1590 without ss, ga, qs): gW_l = hin_l^T
    gz_l, plus qin_l^T v_l with v_l = bf16(s_l act'(z_l)) for K3, whose last
    layer takes the rank-1 term gW[:, channel] += sum of qin instead; hin_0 =
    x0, hin_l = bf16(act(z_{l-1})), qin_0 = ga, qin_l = q_{l-1}; gb_l = the
    column sum of the f32 view of the bf16 gz stack, of gy (f32) at the last
    layer. gy [N, D_out] f32, the rest bf16. The products take their bf16
    operands to f32: each product of two bf16 values is then exact and the
    sums f32, on the CPU and on the card alike, where TF32, if it is on,
    keeps 10 of f32's mantissa bits and so every bit of a bf16 value.
    Returns (gW list [din_l, dout_l], gb list), the first layer's rows cut to
    weights[0]'s (x0 and ga may carry the kernels' zero padding)."""
    f, df = act_pair(activation, beta)
    n_layers = len(weights)
    gws, gbs = [], []
    for l in range(n_layers):
        hin = x0.float() if l == 0 else bf16_round(f(zs[l - 1].float()))
        gz = gy if l == n_layers - 1 else gzs[l].float()
        gw = hin.T @ bf16_round(gz)
        if ga is not None:
            qin = (ga if l == 0 else qs[l - 1]).float()
            if l == n_layers - 1:
                gw[:, channel] += qin.sum(0)
            else:
                gw = gw + qin.T @ bf16_round(ss[l].float() * df(zs[l].float()))
        gws.append(gw[: weights[l].shape[0]])
        gbs.append(gz.sum(0))
    return gws, gbs


def _value_gy(gsdf, weights):
    gy = gsdf.new_zeros((gsdf.shape[0], weights[-1].shape[1]), dtype=torch.float32)
    gy[:, 0] = gsdf.float()
    return gy


def _chain_gy(gsdf, ggeo):
    """[gsdf, ggeo] in f32, ggeo taken in bf16 (op_bwd :1160-1173)."""
    return torch.cat([gsdf.float()[:, None], ggeo.to(torch.bfloat16).float()], dim=-1)


def slot_sdf_value_bwd_split_plain(
    positions, table, weights, biases, gspec: SlotGridSpec, zs, x0, gsdf, *, radius,
    num_frequencies, min_freq_exp, max_freq_exp, skip=(), activation="SoftplusQuad", beta=100.0,
    level_mask=None, num_levels=None,
):
    """Plain PyTorch version of K2's split backward: the per-sample pass,
    the table scatter and the weight gradients. Residuals zs [L-1, N, H] and
    x0 [N, D_in] bf16 in; returns (d_pos, d_table, gW list, gb list)."""
    _check(gspec, skip, activation)
    k = _levels(gspec, num_levels)
    pe = pe_scales(num_frequencies, min_freq_exp, max_freq_exp)
    mask = _mask(level_mask, k * gspec.feats, positions)
    d_pos, d_comp, gzs = slot_sdf_value_bwd_sample_plain(
        positions, table, weights, gspec, zs, gsdf, radius=radius, pe=pe, activation=activation,
        beta=beta, mask=mask, num_levels=k)
    d_table = slot_table_scatter_plain(positions, d_comp, gspec, radius=radius)
    gws, gbs = split_weight_grads(weights, x0, zs, _value_gy(gsdf, weights), gzs, activation, beta)
    return d_pos, d_table, gws, gbs


def slot_sdf_chain_bwd_split_plain(
    positions, table, weights, biases, gspec: SlotGridSpec, zs, ss, adj, x0, gsdf, ggeo, g3, *,
    radius, num_frequencies, min_freq_exp, max_freq_exp, skip=(), activation="SoftplusQuad",
    beta=100.0, level_mask=None,
):
    """Plain PyTorch version of K3's split backward: the per-sample pass, the
    table scatter and the weight gradients. Residuals zs, ss [L-1, N, H]
    bf16, adj [N, D_in] f32 and x0 [N, D_in] bf16 in; returns (d_pos,
    d_table, gW list, gb list)."""
    _check(gspec, skip, activation)
    pe = pe_scales(num_frequencies, min_freq_exp, max_freq_exp)
    mask = _mask(level_mask, gspec.num_levels * gspec.feats, positions)
    d_pos, d_comp, ga, qs, gzs = slot_sdf_chain_bwd_sample_plain(
        positions, table, weights, gspec, zs, ss, adj, gsdf, ggeo, g3, radius=radius, pe=pe,
        activation=activation, beta=beta, mask=mask)
    d_table = slot_table_scatter_plain(positions, d_comp, gspec, radius=radius)
    gws, gbs = split_weight_grads(weights, x0, zs, _chain_gy(gsdf, ggeo), gzs, activation, beta,
                                  ss=ss, ga=ga, qs=qs)
    return d_pos, d_table, gws, gbs


_COMMON_TYPES = ("ptr", "int", "ptr", "ptr", "ptr", "ptr", "int", "ptr", "ptr", "int", "int",
                 "int", "float", "int", "int", "int", "ptr", "ptr", "ptr", "ptr", "float",
                 "float", "int", "int", "ptr")
_GRID_TYPES = ("int", "int", "int", "ptr", "ptr", "ptr", "ptr", "float", "float")


def _grid_args(gspec: SlotGridSpec, k: int, radius: float) -> list:
    """The cell geometry of the first k levels, as the entry points take it:
    levels, F, log2(entries per row), resolutions, dense flags, entry masks,
    row offsets, radius, the clip bound."""
    res = gspec.resolutions[:k]
    return [k, gspec.feats, gspec.entries_per_row.bit_length() - 1, build.int_array(res),
            build.int_array(res.astype(np.int64) ** 3 <= gspec.rows_per_level),
            build.int_array(gspec.level_entries[:k] - 1), build.int_array(gspec.level_offsets[:k]),
            float(radius), CLIP_HI]


class _CardArgs:
    """The packed operands and the geometry arguments every slot kernel
    entry point takes first (positions, table, mask, weights, grid and
    encoding constants); `keep` holds the tensors the pointers refer to."""

    def __init__(self, positions, table, weights, biases, gspec, k, radius, pe, activation, beta,
                 mask):
        _on_card(positions)
        if len(weights) < 2:
            raise ValueError("the fused slot kernels take chains of at least 2 layers")
        build.check_layers(len(weights), "the fused slot kernels")
        if gspec.num_levels > build.MAX_LEVELS:
            raise ValueError(f"the fused slot kernels take at most {build.MAX_LEVELS} grid levels "
                             "(csrc/slot.cuh MAXLV)")
        self.n, self.k, self.feats = positions.shape[0], k, gspec.feats
        self.d_in = 3 + 6 * len(pe) + gspec.num_levels * gspec.feats
        self.in_dims, self.out_dims, self.p0, self.hidden = chain_geometry(self.d_in, weights, ())
        wpack, bpack = pack_chain(weights, biases, self.in_dims, self.out_dims, self.hidden, ())
        pos = positions.float().contiguous()
        tbl = table.to(torch.bfloat16).contiguous()
        if tbl.shape != (gspec.total_rows, 128):
            raise ValueError(f"table shape {tuple(tbl.shape)} != ({gspec.total_rows}, 128)")
        self.keep = (pos, tbl, mask, wpack, bpack)
        self.args = [
            build.ptr(pos), self.n, build.ptr(tbl), build.ptr(mask), build.ptr(wpack),
            build.ptr(bpack), len(weights), build.int_array(self.in_dims),
            build.int_array(self.out_dims), self.hidden, self.p0, ACTIVATIONS[activation],
            2.0 / beta, *_grid_args(gspec, k, radius), int(gspec.interpolation == "Smoothstep"),
            len(pe), build.float_array(pe),
        ]
        self.stream = build.stream_of(pos)

    def grads(self, weights, dev):
        """Zeroed packed gradient buffers (gw, gb) and their unpacker."""
        gw = torch.zeros(sum(a * b for a, b in zip(self.in_dims, self.out_dims)), device=dev)
        gb = torch.zeros(sum(self.out_dims), device=dev)
        return gw, gb, lambda: unpack_grads(gw, gb, weights, self.in_dims, self.out_dims,
                                            self.hidden, ())

    def stack(self, n_layers, dev):
        """An empty bf16 stack [L-1, N, H]."""
        return torch.empty((n_layers - 1, self.n, self.hidden), dtype=torch.bfloat16, device=dev)

    def _scratch(self, library: str, slab_fn: str, args):
        """(scratch, max_ctas) for a kernel's residual stacks: (None, 0) when
        they fit in shared memory beside the tile's buffers (slab_fn gives 0),
        else one slab of device scratch per CTA of a persistent grid."""
        slab = build.function(library, slab_fn, *["int"] * len(args), restype=ctypes.c_longlong)
        if not slab(*args):
            return None, 0
        return build.persistent_scratch(library, slab_fn, args, self.keep[0].device, self.n)

    def fwd_scratch(self, with_grad: bool, keep_z: bool):
        return self._scratch("slot_fused", "mms_slot_fwd_slab", (
            len(self.in_dims), self.hidden, self.p0, self.k, self.feats, self.out_dims[-1],
            int(with_grad), int(keep_z)))

    def bwd_scratch(self, library: str, stacks: int):
        """K2's backwards keep one stack (zs), K3's two (zs, ss)."""
        return self._scratch(library, "mms_slot_bwd_slab", (
            stacks, len(self.in_dims), self.hidden, self.p0, self.k, self.feats,
            self.out_dims[-1]))


def _launch(positions, table, weights, biases, gspec, k, radius, pe, activation, beta,
            mask, with_grad, resid=False, x0=False):
    """Launch the forward kernel; returns (sdf, geo, grad, zs, ss, adj, x0):
    geo and grad without `with_grad`, the backward's residuals without
    `resid` (ss and adj come with the gradient only) and the chain input x0
    [N, P0] bf16 without `x0` (the split backward's residual) are None."""
    ca = _CardArgs(positions, table, weights, biases, gspec, k, radius, pe, activation, beta, mask)
    dev, n = positions.device, ca.n
    d_out = weights[-1].shape[1]
    sdf = torch.empty(n, dtype=torch.float32, device=dev)
    geo = grad = zs = ss = adj = x0_out = None
    if with_grad:
        geo = torch.empty((n, d_out - 1), dtype=torch.bfloat16, device=dev)
        grad = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if resid:
        zs = ca.stack(len(weights), dev)
        if with_grad:
            ss = torch.empty_like(zs)
            adj = torch.empty((n, ca.d_in), dtype=torch.float32, device=dev)
    if x0:
        x0_out = torch.empty((n, ca.p0), dtype=torch.bfloat16, device=dev)
    if n:
        fn = build.function("slot_fused", "mms_slot_sdf_fwd", *_COMMON_TYPES,
                            "ptr", "ptr", "int", "ptr", "int", "ptr", "ptr", "ptr", "int", "ptr",
                            "ptr", "int", "ptr")
        scratch, ctas = ca.fwd_scratch(with_grad, with_grad or resid)
        status = fn(*ca.args, build.ptr(sdf), build.ptr(geo), d_out - 1, build.ptr(grad),
                    int(with_grad), build.ptr(zs), build.ptr(ss), build.ptr(adj), ca.d_in,
                    build.ptr(x0_out), build.ptr(scratch), ctas, ca.stream)
        build.check(status, "fused slot sdf")
        (CHAIN_KERNEL if with_grad else VALUE_KERNEL).launches += 1
    return sdf, geo, grad, zs, ss, adj, x0_out


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
                            "ptr", "ptr", "ptr", "ptr", "ptr", "ptr", "ptr", "int", "ptr")
        g = gsdf.float().contiguous()
        scratch, ctas = ca.bwd_scratch("slot_fused_bwd", 1)
        status = fn(*ca.args, build.ptr(zs), build.ptr(g), build.ptr(d_pos), build.ptr(d_table),
                    build.ptr(gw), build.ptr(gb), build.ptr(scratch), ctas, ca.stream)
        build.check(status, "fused slot sdf value backward")
        VALUE_BWD_KERNEL.launches += 1
    return (d_pos, d_table, *unpack())


def _chain_cotangents(gsdf, ggeo, g3):
    return gsdf.float().contiguous(), ggeo.to(torch.bfloat16).contiguous(), g3.float().contiguous()


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
                            "ptr", "ptr", "ptr", "int", "ptr")
        cot = _chain_cotangents(gsdf, ggeo, g3)
        scratch, ctas = ca.bwd_scratch("slot_fused_bwd", 2)
        status = fn(*ca.args, build.ptr(zs), build.ptr(ss), build.ptr(adj), ca.d_in,
                    build.ptr(cot[0]), build.ptr(cot[1]), ggeo.shape[1], build.ptr(cot[2]),
                    build.ptr(d_pos), build.ptr(d_table), build.ptr(gw), build.ptr(gb),
                    build.ptr(scratch), ctas, ca.stream)
        build.check(status, "fused slot sdf chain backward")
        CHAIN_BWD_KERNEL.launches += 1
    return (d_pos, d_table, *unpack())


def _launch_value_bwd_sample(positions, table, weights, biases, gspec, k, radius, pe, activation,
                             beta, mask, zs, gsdf):
    """K2s's per-sample kernel: (d_pos [N, 3] f32, d_comp [N, k, 8F] bf16,
    gz [L-1, N, H] bf16)."""
    ca = _CardArgs(positions, table, weights, biases, gspec, k, radius, pe, activation, beta, mask)
    dev = positions.device
    d_pos = torch.empty((ca.n, 3), dtype=torch.float32, device=dev)
    d_comp = torch.empty((ca.n, k, NSLOT * gspec.feats), dtype=torch.bfloat16, device=dev)
    gzs = ca.stack(len(weights), dev)
    if ca.n:
        fn = build.function("slot_split", "mms_slot_value_bwd_sample", *_COMMON_TYPES,
                            "ptr", "ptr", "ptr", "ptr", "ptr", "ptr", "int", "ptr")
        g = gsdf.float().contiguous()
        scratch, ctas = ca.bwd_scratch("slot_split", 1)
        status = fn(*ca.args, build.ptr(zs), build.ptr(g), build.ptr(d_pos), build.ptr(d_comp),
                    build.ptr(gzs), build.ptr(scratch), ctas, ca.stream)
        build.check(status, "fused slot sdf value backward, per-sample pass")
        VALUE_SPLIT_KERNEL.launches += 1
    return d_pos, d_comp, gzs


def _launch_chain_bwd_sample(positions, table, weights, biases, gspec, radius, pe, activation,
                             beta, mask, zs, ss, adj, gsdf, ggeo, g3):
    """K3s's per-sample kernel: (d_pos [N, 3] f32, d_comp [N, K, 8F] bf16, ga
    [N, P0] bf16, q and gz [L-1, N, H] bf16)."""
    k = gspec.num_levels
    ca = _CardArgs(positions, table, weights, biases, gspec, k, radius, pe, activation, beta, mask)
    dev = positions.device
    d_pos = torch.empty((ca.n, 3), dtype=torch.float32, device=dev)
    d_comp = torch.empty((ca.n, k, NSLOT * gspec.feats), dtype=torch.bfloat16, device=dev)
    ga = torch.empty((ca.n, ca.p0), dtype=torch.bfloat16, device=dev)
    qs, gzs = ca.stack(len(weights), dev), ca.stack(len(weights), dev)
    if ca.n:
        fn = build.function("slot_split", "mms_slot_chain_bwd_sample", *_COMMON_TYPES,
                            "ptr", "ptr", "ptr", "int", "ptr", "ptr", "int", "ptr", "ptr", "ptr",
                            "ptr", "ptr", "ptr", "ptr", "int", "ptr")
        cot = _chain_cotangents(gsdf, ggeo, g3)
        scratch, ctas = ca.bwd_scratch("slot_split", 2)
        status = fn(*ca.args, build.ptr(zs), build.ptr(ss), build.ptr(adj), ca.d_in,
                    build.ptr(cot[0]), build.ptr(cot[1]), ggeo.shape[1], build.ptr(cot[2]),
                    build.ptr(d_pos), build.ptr(d_comp), build.ptr(ga), build.ptr(qs),
                    build.ptr(gzs), build.ptr(scratch), ctas, ca.stream)
        build.check(status, "fused slot sdf chain backward, per-sample pass")
        CHAIN_SPLIT_KERNEL.launches += 1
    return d_pos, d_comp, ga, qs, gzs


def _launch_table_scatter(positions, d_comp, gspec, radius):
    """The split's scatter kernel: d_table [rows, 128] f32 from the bf16
    d_comp [N, k, 8F]."""
    _on_card(positions)
    n, k = d_comp.shape[:2]
    if d_comp.shape[2] != NSLOT * gspec.feats or d_comp.dtype != torch.bfloat16:
        raise ValueError(f"d_comp {tuple(d_comp.shape)} {d_comp.dtype} is not bf16 "
                         f"[N, k, {NSLOT * gspec.feats}]")
    pos = positions.float().contiguous()
    dc = d_comp.contiguous()
    d_table = torch.zeros((gspec.total_rows, LANE), dtype=torch.float32, device=pos.device)
    if n:
        fn = build.function("slot_split", "mms_slot_table_scatter", "ptr", "int", "ptr",
                            *_GRID_TYPES, "ptr", "ptr")
        status = fn(build.ptr(pos), n, build.ptr(dc), *_grid_args(gspec, k, radius),
                    build.ptr(d_table), build.stream_of(pos))
        build.check(status, "slot table scatter")
        SCATTER_KERNEL.launches += 1
    return d_table


def _value_split_card(positions, table, weights, biases, gspec, k, radius, pe, activation, beta,
                      mask, zs, x0, gsdf):
    """K2's split backward on the card: the per-sample kernel, the scatter
    kernel and the weight-gradient products. Returns (d_pos, d_table, gW
    list, gb list)."""
    d_pos, d_comp, gzs = _launch_value_bwd_sample(positions, table, weights, biases, gspec, k,
                                                  radius, pe, activation, beta, mask, zs, gsdf)
    d_table = _launch_table_scatter(positions, d_comp, gspec, radius)
    gws, gbs = split_weight_grads(weights, x0, zs, _value_gy(gsdf, weights), gzs, activation,
                                  beta)
    return d_pos, d_table, gws, gbs


def _chain_split_card(positions, table, weights, biases, gspec, radius, pe, activation, beta,
                      mask, zs, ss, adj, x0, gsdf, ggeo, g3):
    """K3's split backward on the card, as _value_split_card."""
    d_pos, d_comp, ga, qs, gzs = _launch_chain_bwd_sample(
        positions, table, weights, biases, gspec, radius, pe, activation, beta, mask, zs, ss, adj,
        gsdf, ggeo, g3)
    d_table = _launch_table_scatter(positions, d_comp, gspec, radius)
    gws, gbs = split_weight_grads(weights, x0, zs, _chain_gy(gsdf, ggeo), gzs, activation, beta,
                                  ss=ss, ga=ga, qs=qs)
    return d_pos, d_table, gws, gbs


def _on_card(positions: torch.Tensor) -> bool:
    if positions.device.type == "cpu":
        return False
    if positions.device.type != "cuda":
        raise ValueError(f"unsupported device {positions.device}")
    return True


class _SlotValue(torch.autograd.Function):
    """K2 with its backward (op_fwd/op_bwd :1728-1766): the forward keeps
    the bf16 pre-activations, and in split mode the chain input x0; the
    mask's cotangent is dropped (:1765)."""

    @staticmethod
    def forward(ctx, cfg, positions, table, mask, *params):
        gspec, k, pe, split, kw = cfg
        ws, bs = params[: len(params) // 2], params[len(params) // 2 :]
        if _on_card(positions):
            sdf, _, _, zs, _, _, x0 = _launch(positions, table, ws, bs, gspec, k, kw["radius"], pe,
                                              kw["activation"], kw["beta"], mask, False,
                                              resid=True, x0=split)
        else:
            sdf, zs, x0 = _value_fwd_plain(positions, table, ws, bs, gspec, k, kw["radius"], pe,
                                           kw["activation"], kw["beta"], mask)
        ctx.cfg = cfg
        ctx.save_for_backward(positions, table, mask, zs, x0 if split else None, *params)
        return sdf

    @staticmethod
    def backward(ctx, gsdf):
        gspec, k, pe, split, kw = ctx.cfg
        positions, table, mask, zs, x0, *params = ctx.saved_tensors
        ws, bs = params[: len(params) // 2], params[len(params) // 2 :]
        geom = (gspec, k, kw["radius"], pe, kw["activation"], kw["beta"], mask)
        if not _on_card(positions):
            plain = slot_sdf_value_bwd_split_plain if split else slot_sdf_value_bwd_plain
            d_pos, d_table, gws, gbs = plain(positions, table, ws, bs, gspec, zs,
                                             *((x0,) if split else ()), gsdf, level_mask=mask,
                                             num_levels=k, **kw)
        elif split:
            d_pos, d_table, gws, gbs = _value_split_card(positions, table, ws, bs, *geom, zs, x0,
                                                         gsdf)
        else:
            d_pos, d_table, gws, gbs = _launch_value_bwd(positions, table, ws, bs, *geom, zs,
                                                         gsdf)
        return (None, d_pos, d_table, None, *gws, *gbs)


class _SlotChain(torch.autograd.Function):
    """K3 with its backward (op_fwd/op_bwd :1140-1191): the forward keeps
    zs, ss and adj, and in split mode the chain input x0; the mask's
    cotangent is dropped (:1188-1190)."""

    @staticmethod
    def forward(ctx, cfg, positions, table, mask, *params):
        gspec, _, pe, split, kw = cfg
        ws, bs = params[: len(params) // 2], params[len(params) // 2 :]
        if _on_card(positions):
            sdf, geo, grad, zs, ss, adj, x0 = _launch(
                positions, table, ws, bs, gspec, gspec.num_levels, kw["radius"], pe,
                kw["activation"], kw["beta"], mask, True, resid=True, x0=split)
        else:
            (sdf, geo, grad), (zs, ss, adj, x0) = _chain_fwd_plain(
                positions, table, ws, bs, gspec, kw["radius"], pe, kw["activation"], kw["beta"],
                mask)
        ctx.cfg = cfg
        ctx.save_for_backward(positions, table, mask, zs, ss, adj, x0 if split else None, *params)
        return sdf, geo, grad

    @staticmethod
    def backward(ctx, gsdf, ggeo, g3):
        gspec, _, pe, split, kw = ctx.cfg
        positions, table, mask, zs, ss, adj, x0, *params = ctx.saved_tensors
        ws, bs = params[: len(params) // 2], params[len(params) // 2 :]
        ggeo = ggeo.to(torch.bfloat16)  # op_bwd :1155
        geom = (gspec, kw["radius"], pe, kw["activation"], kw["beta"], mask)
        if not _on_card(positions):
            plain = slot_sdf_chain_bwd_split_plain if split else slot_sdf_chain_bwd_plain
            d_pos, d_table, gws, gbs = plain(positions, table, ws, bs, gspec, zs, ss, adj,
                                             *((x0,) if split else ()), gsdf, ggeo, g3,
                                             level_mask=mask, **kw)
        elif split:
            d_pos, d_table, gws, gbs = _chain_split_card(positions, table, ws, bs, *geom, zs, ss,
                                                         adj, x0, gsdf, ggeo, g3)
        else:
            d_pos, d_table, gws, gbs = _launch_chain_bwd(positions, table, ws, bs, *geom, zs, ss,
                                                         adj, gsdf, ggeo, g3)
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
    biases through K2's backward, merged or split (bwd_split)."""
    _check(gspec, skip, activation)
    k = _levels(gspec, num_levels)
    pe = pe_scales(num_frequencies, min_freq_exp, max_freq_exp)
    mask = _mask(level_mask, k * gspec.feats, positions)
    kw = dict(radius=radius, num_frequencies=num_frequencies, min_freq_exp=min_freq_exp,
              max_freq_exp=max_freq_exp, activation=activation, beta=beta)
    if _differentiable(positions, table, weights, biases):
        cfg = (gspec, k, pe, bwd_split(len(weights)), kw)
        return _SlotValue.apply(cfg, positions, table, mask, *weights, *biases)
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
    table, weights and biases through K3's backward, merged or split
    (bwd_split)."""
    _check(gspec, skip, activation)
    pe = pe_scales(num_frequencies, min_freq_exp, max_freq_exp)
    mask = _mask(level_mask, gspec.num_levels * gspec.feats, positions)
    kw = dict(radius=radius, num_frequencies=num_frequencies, min_freq_exp=min_freq_exp,
              max_freq_exp=max_freq_exp, activation=activation, beta=beta)
    if _differentiable(positions, table, weights, biases):
        cfg = (gspec, gspec.num_levels, pe, bwd_split(len(weights)), kw)
        return _SlotChain.apply(cfg, positions, table, mask, *weights, *biases)
    if not _on_card(positions):
        return _chain_fwd_plain(positions, table, weights, biases, gspec, radius, pe, activation,
                                beta, mask)[0]
    return _launch(positions, table, weights, biases, gspec, gspec.num_levels, radius, pe,
                   activation, beta, mask, with_grad=True)[:3]
