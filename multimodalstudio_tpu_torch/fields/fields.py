"""Scene fields: SDF surface field, radiance trunk, vanilla-NeRF background
(JAX reference: fields/fields.py). A field component is a plain MLP
(child "mlp") or a feature grid + MLP head (child "grid_mlp")."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from multimodalstudio_tpu_torch.fields.components import FeatureGridAndMLP, FeatureGridSpec
from multimodalstudio_tpu_torch.fields.mlp import MLP, MLPSpec
from multimodalstudio_tpu_torch.ops.encodings import nerf_encoding


@dataclasses.dataclass(frozen=True)
class NeRFEncodingSpec:
    num_frequencies: int = 6
    min_freq_exp: float = 0.0
    max_freq_exp: float = 5.0
    include_input: bool = True

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return nerf_encoding(
            x, self.num_frequencies, self.min_freq_exp, self.max_freq_exp, self.include_input
        )

    def out_dim(self, in_dim: int) -> int:
        return in_dim * self.num_frequencies * 2 + (in_dim if self.include_input else 0)


@dataclasses.dataclass(frozen=True)
class FieldComponentSpec:
    """MLP-only when `grid` is None, else grid + MLP head."""

    mlp: MLPSpec = MLPSpec()
    grid: Optional[FeatureGridSpec] = None


class FieldComponent(nn.Module):
    def __init__(self, spec: FieldComponentSpec, in_dim: int, output_dim: int, device=None):
        super().__init__()
        self.spec = spec
        if spec.grid is None:
            self.mlp = MLP(spec.mlp, in_dim, output_dim, device=device)
        else:
            self.grid_mlp = FeatureGridAndMLP(spec.grid, spec.mlp, in_dim, output_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.spec.grid is not None:
            raise NotImplementedError(
                "a grid field component evaluates only through the fused slot kernels"
            )
        return self.mlp(x)


@dataclasses.dataclass(frozen=True)
class SDFFieldSpec:
    field: FieldComponentSpec = FieldComponentSpec()
    use_position_encoding: bool = True
    position_encoding: NeRFEncodingSpec = NeRFEncodingSpec()
    geo_feature_dim: int = 256
    inside_outside: bool = False


class SDFField(nn.Module):
    """SDF + geometric feature from positions; the models evaluate it
    through the fused slot kernels (models/model.py)."""

    def __init__(self, spec: SDFFieldSpec, device=None):
        super().__init__()
        self.spec = spec
        in_dim = spec.position_encoding.out_dim(3) if spec.use_position_encoding else 3
        self.field = FieldComponent(spec.field, in_dim, 1 + spec.geo_feature_dim, device=device)


@dataclasses.dataclass(frozen=True)
class RadianceFieldSpec:
    base_field: FieldComponentSpec = FieldComponentSpec()


class RadianceField(nn.Module):
    """Shared radiance trunk: concat(pos, dir-enc, extras) -> feature."""

    def __init__(self, spec: RadianceFieldSpec, in_dim: int, output_dim: int, device=None):
        super().__init__()
        self.spec = spec
        self.base_field = FieldComponent(spec.base_field, in_dim, output_dim, device=device)

    def forward(self, positions, view_directions, additional_inputs):
        parts = [positions, view_directions, additional_inputs]
        if self.spec.base_field.mlp.dtype == "bfloat16" and self.spec.base_field.grid is None:
            # the trunk consumes bf16: cast the pieces before the wide concat
            parts = [p.to(torch.bfloat16) for p in parts]
        return self.base_field(torch.cat(parts, dim=-1))


@dataclasses.dataclass(frozen=True)
class NeRFFieldSpec:
    base_field: FieldComponentSpec = FieldComponentSpec(
        mlp=MLPSpec(num_layers=4, hidden_dim=256, activation="ReLU", out_activation="ReLU")
    )
    base_output_dim: int = 256
    head_field: MLPSpec = MLPSpec(num_layers=4, hidden_dim=128, out_activation="ReLU")
    use_position_encoding: bool = True
    position_encoding: NeRFEncodingSpec = NeRFEncodingSpec()
    use_direction_encoding: bool = True
    direction_encoding: NeRFEncodingSpec = NeRFEncodingSpec(
        num_frequencies=4, min_freq_exp=0.0, max_freq_exp=3.0
    )


# the background's density head: one float32 layer with softplus
DENSITY_HEAD = MLPSpec(num_layers=1, hidden_dim=64, weight_norm=True, out_activation="Softplus",
                       activation_beta=1.0)


class NeRFField(nn.Module):
    """Vanilla-NeRF background field: density + radiance feature."""

    def __init__(self, spec: NeRFFieldSpec, radiance_output_dim: int = 128, device=None):
        super().__init__()
        self.spec = spec
        pos_dim = spec.position_encoding.out_dim(3) if spec.use_position_encoding else 3
        dir_dim = spec.direction_encoding.out_dim(3) if spec.use_direction_encoding else 3
        self.base_field = FieldComponent(spec.base_field, pos_dim, spec.base_output_dim,
                                         device=device)
        self.density_head = MLP(DENSITY_HEAD, spec.base_output_dim, 1, device=device)
        self.head_field = MLP(spec.head_field, spec.base_output_dim + dir_dim,
                              radiance_output_dim, device=device)

    def forward(self, x: torch.Tensor, viewing_direction: torch.Tensor):
        spec = self.spec
        if spec.use_position_encoding:
            x = spec.position_encoding.apply(x)
        if spec.use_direction_encoding:
            viewing_direction = spec.direction_encoding.apply(viewing_direction)
        feature = self.base_field(x)
        density = self.density_head(feature)
        radiance_feature = self.head_field(torch.cat([feature, viewing_direction], dim=-1))
        return density, radiance_feature
