"""Fused slot-grid + MLP SDF forward: kernels K2 and K3 and their plain versions.

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
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from multimodalstudio_tpu_torch.ops.kernels import build
from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import (
    ACTIVATIONS,
    act_pair,
    bf16_round,
    chain_geometry,
    pack_chain,
)
from multimodalstudio_tpu_torch.ops.kernels.slot_grid import NSLOT, SlotGridSpec, slot_geometry

CLIP_HI = float(np.float32(1.0 - 1e-6))

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


def _front_end(pos, table, gspec, k, radius, mask, pe):
    """Plain chain input x0 [N, 3+6F_pe + num_levels*F] (bf16 values in f32)
    plus what the gradient needs: (x0, corner values T [N, k, F, 8], w, dw,
    scaled PE arguments [N, 3, F_pe])."""
    n = pos.shape[0]
    feats = gspec.feats
    x = ((pos + radius) / (2.0 * radius)).clamp(0.0, CLIP_HI)
    idx, w, dw = slot_geometry(x, gspec, k)
    entries = bf16_round(table).reshape(-1, NSLOT * feats)  # one row per absolute entry
    T = entries[idx].reshape(n, k, feats, NSLOT)
    wb = bf16_round(w).reshape(n, k, 1, NSLOT)
    encg = bf16_round(bf16_round(T * wb).sum(-1) * mask.reshape(1, k, feats))
    scale = torch.as_tensor(pe, device=pos.device)
    scaled = pos[:, :, None] * scale  # [N, 3, F_pe], d-major columns
    flat = scaled.reshape(n, -1)
    pad = (gspec.num_levels - k) * feats
    x0 = torch.cat(
        [pos, torch.sin(flat), torch.cos(flat), encg.reshape(n, k * feats), pos.new_zeros(n, pad)],
        dim=-1,
    )
    return bf16_round(x0), T, w, dw, scaled


def _chain(x0, weights, biases, activation, beta):
    """Plain chain forward: (last layer z in f32, bf16-rounded hidden z's)."""
    f, _ = act_pair(activation, beta)
    h, zs = x0, []
    for l, (w, b) in enumerate(zip(weights, biases)):
        z = h @ bf16_round(w) + b.float()
        if l < len(weights) - 1:
            zs.append(bf16_round(z))
            h = bf16_round(f(z))
        else:
            h = z
    return h, zs


def slot_sdf_value_plain(
    positions, table, weights, biases, gspec: SlotGridSpec, *, radius, num_frequencies,
    min_freq_exp, max_freq_exp, skip=(), activation="SoftplusQuad", beta=100.0,
    level_mask=None, num_levels=None,
):
    """Plain PyTorch version of K2: sdf [N] f32."""
    _check(gspec, skip, activation)
    k = gspec.num_levels if num_levels is None else min(int(num_levels), gspec.num_levels)
    pe = pe_scales(num_frequencies, min_freq_exp, max_freq_exp)
    mask = _mask(level_mask, k * gspec.feats, positions)
    x0, *_ = _front_end(positions.float(), table, gspec, k, radius, mask, pe)
    y, _ = _chain(x0, weights, biases, activation, beta)
    return y[:, 0]


def slot_sdf_chain_plain(
    positions, table, weights, biases, gspec: SlotGridSpec, *, radius, num_frequencies,
    min_freq_exp, max_freq_exp, skip=(), activation="SoftplusQuad", beta=100.0,
    level_mask=None,
):
    """Plain PyTorch version of K3: (sdf [N] f32, geo [N, D_out-1] bf16,
    grad [N, 3] f32 = d sdf / d positions)."""
    _check(gspec, skip, activation)
    k, feats = gspec.num_levels, gspec.feats
    n = positions.shape[0]
    pos = positions.float()
    pe = pe_scales(num_frequencies, min_freq_exp, max_freq_exp)
    mask = _mask(level_mask, k * feats, positions)
    x0, T, _, dw, scaled = _front_end(pos, table, gspec, k, radius, mask, pe)
    y, zs = _chain(x0, weights, biases, activation, beta)
    _, df = act_pair(activation, beta)

    # adjoint sweep: v = e_0; s = bf16(v) W_l^T; v = s * act'(z_{l-1})
    v = torch.zeros_like(y)
    v[:, 0] = 1.0
    for l in reversed(range(len(weights))):
        s = bf16_round(v) @ bf16_round(weights[l]).T
        if l == 0:
            adj = s
        else:
            v = s * df(zs[l - 1])

    # encoding part: J_enc^T adj (fused_mlp.py:242-260)
    fp = num_frequencies
    scale = torch.as_tensor(pe, device=pos.device)
    gs = adj[:, 3 : 3 + 3 * fp].reshape(n, 3, fp)
    gc = adj[:, 3 + 3 * fp : 3 + 6 * fp].reshape(n, 3, fp)
    grad = adj[:, :3] + (gs * (torch.cos(scaled) * scale) + gc * (-torch.sin(scaled) * scale)).sum(-1)
    # grid part: sum comp * bf16(dw_k / 2r) * bf16(adj_grid * mask) (slot_fused.py:445-458)
    pw = 3 + 6 * fp
    a = bf16_round(adj[:, pw : pw + k * feats] * mask).reshape(n, 1, k, feats, 1)
    dwk = bf16_round(dw.reshape(n, 3, k, 1, NSLOT) * (1.0 / (2.0 * radius)))
    grad = grad + (T[:, None] * dwk * a).sum(dim=(2, 3, 4))
    return y[:, 0], y[:, 1:].to(torch.bfloat16), grad


def _launch(positions, table, weights, biases, gspec, k, radius, pe, activation, beta,
            mask, with_grad):
    """Launch the CUDA kernel; returns (sdf, geo, grad) (geo/grad None
    without the gradient)."""
    dev = positions.device
    n = positions.shape[0]
    d_in = 3 + 6 * len(pe) + gspec.num_levels * gspec.feats
    in_dims, out_dims, p0, hidden = chain_geometry(d_in, weights, ())
    if len(weights) > 8:
        raise ValueError("at most 8 layers")
    wpack, bpack = pack_chain(weights, biases, in_dims, out_dims, hidden, ())
    pos = positions.float().contiguous()
    tbl = table.to(torch.bfloat16).contiguous()
    if tbl.shape != (gspec.total_rows, 128):
        raise ValueError(f"table shape {tuple(tbl.shape)} != ({gspec.total_rows}, 128)")
    d_out = weights[-1].shape[1]
    sdf = torch.empty(n, dtype=torch.float32, device=dev)
    geo = grad = None
    if with_grad:
        geo = torch.empty((n, d_out - 1), dtype=torch.bfloat16, device=dev)
        grad = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return sdf, geo, grad
    res = gspec.resolutions[:k]
    fn = build.function(
        "slot_fused", "mms_slot_sdf_fwd",
        "ptr", "int", "ptr", "ptr", "ptr", "ptr", "int", "ptr", "ptr", "int", "int", "int",
        "float", "int", "int", "int", "ptr", "ptr", "ptr", "ptr", "float", "float", "int",
        "int", "ptr", "ptr", "ptr", "int", "ptr", "int", "ptr",
    )
    null = build.ctypes.c_void_p(0)
    status = fn(
        build.ptr(pos), n, build.ptr(tbl), build.ptr(mask), build.ptr(wpack), build.ptr(bpack),
        len(weights), build.int_array(in_dims), build.int_array(out_dims), hidden, p0,
        ACTIVATIONS[activation], 2.0 / beta, k, gspec.feats,
        gspec.entries_per_row.bit_length() - 1, build.int_array(res),
        build.int_array(res.astype(np.int64) ** 3 <= gspec.rows_per_level),
        build.int_array(gspec.level_entries[:k] - 1), build.int_array(gspec.level_offsets[:k]),
        float(radius), CLIP_HI, int(gspec.interpolation == "Smoothstep"), len(pe),
        build.float_array(pe), build.ptr(sdf), build.ptr(geo) if with_grad else null,
        d_out - 1, build.ptr(grad) if with_grad else null, int(with_grad), build.stream_of(pos),
    )
    build.check(status, "fused slot sdf")
    return sdf, geo, grad


def _on_card(positions: torch.Tensor) -> bool:
    if positions.device.type == "cpu":
        return False
    if positions.device.type != "cuda":
        raise ValueError(f"unsupported device {positions.device}")
    return True


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
    zeros); level_mask [k*F] is the coarse-to-fine mask of those levels."""
    kw = dict(radius=radius, num_frequencies=num_frequencies, min_freq_exp=min_freq_exp,
              max_freq_exp=max_freq_exp, skip=skip, activation=activation, beta=beta,
              level_mask=level_mask)
    if not _on_card(positions):
        return slot_sdf_value_plain(positions, table, weights, biases, gspec,
                                    num_levels=num_levels, **kw)
    _check(gspec, skip, activation)
    k = gspec.num_levels if num_levels is None else min(int(num_levels), gspec.num_levels)
    pe = pe_scales(num_frequencies, min_freq_exp, max_freq_exp)
    mask = _mask(level_mask, k * gspec.feats, positions)
    sdf, _, _ = _launch(positions, table, weights, biases, gspec, k, radius, pe, activation,
                        beta, mask, with_grad=False)
    VALUE_KERNEL.launches += 1
    return sdf


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
    positions [N, 3] over all levels (K3); level_mask [num_levels*F]."""
    kw = dict(radius=radius, num_frequencies=num_frequencies, min_freq_exp=min_freq_exp,
              max_freq_exp=max_freq_exp, skip=skip, activation=activation, beta=beta,
              level_mask=level_mask)
    if not _on_card(positions):
        return slot_sdf_chain_plain(positions, table, weights, biases, gspec, **kw)
    _check(gspec, skip, activation)
    k = gspec.num_levels
    pe = pe_scales(num_frequencies, min_freq_exp, max_freq_exp)
    mask = _mask(level_mask, k * gspec.feats, positions)
    out = _launch(positions, table, weights, biases, gspec, k, radius, pe, activation, beta,
                  mask, with_grad=True)
    CHAIN_KERNEL.launches += 1
    return out
