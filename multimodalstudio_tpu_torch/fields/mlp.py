"""MLP with weight normalization and geometric (SDF) init
(JAX reference: fields/mlp.py).

Kernels are stored [in, out] like the reference's flax params, so weights
carry across unchanged (convert.py). Weight norm: w = g * kernel / |kernel|
per output column; init sets g = |kernel| so the initial forward equals the
raw initialization.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn

from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import fused_chain


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    num_layers: int = 8
    hidden_dim: int = 128
    weight_norm: bool = True
    activation: str = "ReLU"
    activation_beta: float = 100.0  # Softplus beta
    out_activation: Optional[str] = "Sigmoid"
    skip_connections: Tuple[int, ...] = ()
    geometric_init: bool = False
    geometric_init_bias: float = 0.5
    inside_outside: bool = False
    dtype: str = "float32"  # float32 | bfloat16 compute dtype of the layer chain
    fused: bool = False  # run the chain as one fused kernel (ops/kernels/fused_mlp)


def make_activation(name: Optional[str], beta: float = 100.0) -> Callable:
    if name is None or name == "None":
        return lambda x: x
    if name == "ReLU":
        return torch.relu
    if name == "Softplus":
        return lambda x: nn.functional.softplus(x * beta) / beta
    if name == "SoftplusQuad":
        # C^1 piecewise-quadratic softplus stand-in: 0 below -a, z above +a,
        # (z+a)^2/(4a) between, with a = 2/beta
        a = 2.0 / beta
        return lambda x: torch.where(x.abs() < a, (x + a) * (x + a) * (0.25 / a), torch.relu(x))
    if name == "Sigmoid":
        # 1 / (1 + exp(-x)) op by op, which rounds each step on a bf16 input
        # as the reference's bf16 sigmoid does
        return lambda x: 1.0 / (1.0 + torch.exp(-x))
    if name == "LeakyReLU":
        return lambda x: nn.functional.leaky_relu(x, 0.01)
    if name == "Tanh":
        return torch.tanh
    raise ValueError(f"unknown activation {name}")


class WNDense(nn.Module):
    """Dense layer [in, out] with optional weight normalization."""

    def __init__(self, in_dim: int, features: int, use_weight_norm: bool = True,
                 dtype: str = "float32", device=None):
        super().__init__()
        self.use_weight_norm = use_weight_norm
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(in_dim, features, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features, device=device), requires_grad=False)
        if use_weight_norm:
            self.g = nn.Parameter(torch.ones(features, device=device), requires_grad=False)

    def weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Effective (weight-norm applied) (w [in, out], b [out])."""
        if not self.use_weight_norm:
            return self.kernel, self.bias
        norm = torch.linalg.vector_norm(self.kernel, dim=0, keepdim=True)
        return self.g * self.kernel / norm.clamp_min(1e-12), self.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weights()
        if self.dtype == "bfloat16":
            # bf16 inputs and weights, f32 accumulation, the product rounded
            # to bf16, then a bf16 bias add (reference fields/mlp.py:102-115)
            out = (x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()).to(torch.bfloat16)
            return out + b.to(torch.bfloat16)
        return x @ w + b


def can_fuse(spec: MLPSpec) -> bool:
    """Whether this MLP geometry runs as the fused chain kernel."""
    return (
        spec.fused
        and spec.dtype == "bfloat16"
        and spec.num_layers >= 2
        and spec.hidden_dim % 128 == 0
        and spec.activation in ("ReLU", "SoftplusQuad", "None")
    )


def layer_dims(spec: MLPSpec, in_dim: int, output_dim: int) -> List[Tuple[int, int]]:
    """(in, out) width of every layer; a skip layer's input is widened by
    the network input."""
    dims, cur = [], in_dim
    for layer in range(spec.num_layers):
        if layer in spec.skip_connections:
            cur += in_dim
        if layer + 1 in spec.skip_connections or layer < spec.num_layers - 1:
            out = spec.hidden_dim
        else:
            out = output_dim
        dims.append((cur, out))
        cur = out
    return dims


def _geometric_kernel(layer, n_layers, skip, first_in_dim, inside_outside, additional_input,
                      shape, gen) -> torch.Tensor:
    """Geometric (unit-sphere SDF) init of one [in, out] kernel."""
    in_dim, out_dim = shape
    normal = torch.randn(shape, generator=gen, device=gen.device)
    if layer == n_layers - 1:
        mean = math.sqrt(math.pi) / math.sqrt(in_dim)
        return (-mean if inside_outside else mean) + 1e-4 * normal
    w = math.sqrt(2.0) / math.sqrt(out_dim) * normal
    if additional_input and layer == 0:
        w[3:, :] = 0.0  # zero every encoded column beyond raw xyz
    elif additional_input and layer in skip and first_in_dim > 3:
        w[-(first_in_dim - 3):, :] = 0.0
    return w


class MLP(nn.Module):
    """`num_layers` linear layers of width `hidden_dim`; a skip layer's
    input is concat(h, x) / sqrt(2)."""

    def __init__(self, spec: MLPSpec, in_dim: int, output_dim: int, device=None):
        super().__init__()
        self.spec = spec
        self.in_dim = in_dim
        self.output_dim = output_dim
        for l, (din, dout) in enumerate(layer_dims(spec, in_dim, output_dim)):
            self.add_module(
                f"layer_{l}", WNDense(din, dout, spec.weight_norm, spec.dtype, device=device)
            )

    def layers(self) -> List[WNDense]:
        return [getattr(self, f"layer_{l}") for l in range(self.spec.num_layers)]

    def effective_weights(self):
        ws, bs = zip(*(layer.weights() for layer in self.layers()))
        return list(ws), list(bs)

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """Draw from the reference's distributions: he-uniform kernels and
        zero biases, or the geometric SDF init; then g = |kernel|."""
        spec = self.spec
        n = spec.num_layers
        for l, layer in enumerate(self.layers()):
            shape = tuple(layer.kernel.shape)
            if spec.geometric_init:
                k = _geometric_kernel(l, n, spec.skip_connections, self.in_dim,
                                      spec.inside_outside, self.in_dim > 3, shape, gen)
                bias = spec.geometric_init_bias if spec.inside_outside else -spec.geometric_init_bias
                b = torch.full((shape[1],), bias if l == n - 1 else 0.0)
            else:
                limit = math.sqrt(6.0 / shape[0])
                k = (torch.rand(shape, generator=gen, device=gen.device) * 2.0 - 1.0) * limit
                b = torch.zeros(shape[1])
            layer.kernel.copy_(k)
            layer.bias.copy_(b)
            if layer.use_weight_norm:
                layer.g.copy_(torch.linalg.vector_norm(layer.kernel, dim=0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        act = make_activation(spec.activation, spec.activation_beta)
        out_act = make_activation(spec.out_activation, spec.activation_beta)
        lead = x.shape[:-1]
        if can_fuse(spec):
            ws, bs = self.effective_weights()
            x = fused_chain(
                x.reshape(-1, self.in_dim), ws, bs, skip=spec.skip_connections,
                activation=spec.activation, beta=spec.activation_beta,
            ).reshape(*lead, self.output_dim)
        else:
            inputs = x
            for l, layer in enumerate(self.layers()):
                if l in spec.skip_connections:
                    x = torch.cat([x, inputs], dim=-1) / math.sqrt(2.0)
                x = layer(x)
                if l < spec.num_layers - 1:
                    x = act(x)
        # bf16 stays inside the layer chain: rendering math runs float32
        return out_act(x).float()
