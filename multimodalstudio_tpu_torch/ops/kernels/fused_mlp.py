"""Fused dense chain (MLP) forward: kernel K1 and its plain version.

`fused_chain` runs a whole MLP layer chain for a tile of samples on the
card in one CUDA kernel (csrc/fused_mlp.cu), so activations between layers
never touch device memory. It replaces the Pallas TPU kernel
multimodalstudio_tpu/ops/pallas/fused_mlp.py::_fwd_kernel (:265), reached
through `fused_chain` (:1080), in its forward mode without tangents.

Arithmetic (the JAX kernel's cast points, chain_reference :1263-1302):
inputs and weights bf16, products accumulated in f32 plus an f32 bias,
the hidden activation evaluated in f32 and rounded to bf16, a skip layer's
input concat(h, x0) * 1/sqrt(2) rounded to bf16, and the last layer's z
rounded to bf16 for y.

Bound on an H100 at the slice's widths: about 2 * N * sum(din * dout)
flops against 2 * N * (din + dout) bytes of input and output, far above
the card's ridge of ~295 flop/byte, so the tensor-core rate bounds it.
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


def fused_chain_plain(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    *,
    skip: Tuple[int, ...] = (),
    activation: str = "ReLU",
    beta: float = 100.0,
    tangents: Optional[torch.Tensor] = None,
):
    """Plain PyTorch version of K1: bf16 emulated by rounding, f32 math.

    x [N, D_in]; weights[l] [din_l, dout_l]; biases[l] [dout_l]. Returns
    y [N, D_out] bf16 (and ty [K, N, D_out] bf16 for tangents [K, N, D_in],
    the forward-mode variant of the JAX kernel)."""
    f, df = act_pair(activation, beta)
    n_layers = len(weights)
    x0 = bf16_round(x)
    h = x0
    t0 = t = None if tangents is None else bf16_round(tangents)
    for l in range(n_layers):
        if l in skip:
            h = bf16_round(torch.cat([h, x0], dim=-1) * SKIP_SCALE)
            if t is not None:
                t = bf16_round(torch.cat([t, t0], dim=-1) * SKIP_SCALE)
        w = bf16_round(weights[l])
        z = h @ w + biases[l].float()
        u = None if t is None else t @ w
        if l < n_layers - 1:
            h = bf16_round(f(z))
            if t is not None:
                t = bf16_round(u * df(z)[None])
        else:
            h, t = z, u
    y = h.to(torch.bfloat16)
    return y if t is None else (y, t.to(torch.bfloat16))


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


def fused_chain(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    *,
    skip: Tuple[int, ...] = (),
    activation: str = "ReLU",
    beta: float = 100.0,
    tangents: Optional[torch.Tensor] = None,
):
    """Run the fused dense chain; y [N, D_out] bf16 before the output
    activation. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (forward tangents raise there until the training
    slice brings the tangent kernel)."""
    if x.device.type == "cpu":
        return fused_chain_plain(
            x, weights, biases, skip=skip, activation=activation, beta=beta, tangents=tangents
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_chain: unsupported device {x.device}")
    if tangents is not None:
        raise NotImplementedError("fused_chain: forward tangents have no CUDA kernel yet")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unsupported fused activation {activation}")
    skip = tuple(sorted(skip))
    n, d_in = x.shape
    d_out = weights[-1].shape[1]
    in_dims, out_dims, p0, hidden = chain_geometry(d_in, weights, skip)
    if len(weights) > 8:
        raise ValueError("fused_chain: at most 8 layers")
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
