"""Field components: variance, feature grid, grid+MLP stack, modality heads
(JAX reference: fields/components.py).

Module and parameter names follow the reference's flax tree, so a state
dict key is the dotted flax path (convert.py relies on that).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch import nn

from multimodalstudio_tpu_torch.fields.mlp import MLP, MLPSpec
from multimodalstudio_tpu_torch.ops.encodings import HashEncoding, HashGridSpec
from multimodalstudio_tpu_torch.ops.kernels.slot_grid import (
    CLIP_HI,
    LANE,
    SlotGridSpec,
    make_table_init,
    slot_grid_lookup,
)
from multimodalstudio_tpu_torch.ops.polarization import (
    align_polarization_filters,
    stokes_to_intensity,
)


class SingleVariance(nn.Module):
    """NeuS single-parameter variance: inv_std = clip(exp(10 s), 1e-6, 1e6)."""

    def __init__(self, init_val: float = 0.3, device=None):
        super().__init__()
        self.init_val = init_val
        self.s = nn.Parameter(torch.full((1,), init_val, device=device))

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        self.s.fill_(self.init_val)

    def forward(self) -> torch.Tensor:
        return torch.clamp(torch.exp(self.s * 10.0), 1e-6, 1e6)


@dataclasses.dataclass(frozen=True)
class FeatureGridSpec:
    """`encoding` selects the backend: HashGridSpec (the multiresolution
    hash grid, ops/encodings.py) or SlotGridSpec (the slot-hash grid of the
    fused kernels)."""

    encoding: Union[HashGridSpec, SlotGridSpec] = HashGridSpec()
    coarse_to_fine: bool = True
    steps_per_level_ratio: float = 0.1
    level_init: int = 1
    radius: float = 1.0


class SlotGridEncoding(nn.Module):
    """Owns a slot-grid table [total_rows, 128] f32; its forward is the
    lookup K6 (JAX components.py:61-69)."""

    def __init__(self, spec: SlotGridSpec, device=None):
        super().__init__()
        self.spec = spec
        self.table = nn.Parameter(torch.zeros((spec.total_rows, LANE), device=device))

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        self.table.copy_(make_table_init(self.spec)(gen))

    def forward(self, x: torch.Tensor, num_levels: Optional[int] = None) -> torch.Tensor:
        return slot_grid_lookup(self.table, x, self.spec, num_levels)


class FeatureGrid(nn.Module):
    """The grid of a field: positions in [-r, r] map to [0, 1] (clamped
    below 1), then the hash-grid or slot-grid lookup; features of levels at
    or above the active level are masked (coarse to fine). The fused slot
    kernels (ops/kernels/slot_fused.py) run the slot lookup inside them."""

    def __init__(self, spec: FeatureGridSpec, device=None):
        super().__init__()
        self.spec = spec
        if isinstance(spec.encoding, SlotGridSpec):
            self.encoding = SlotGridEncoding(spec.encoding, device=device)
        else:
            self.encoding = HashEncoding(spec.encoding, device=device)

    def forward(self, x: torch.Tensor, active_level: Optional[int] = None,
                max_level: Optional[int] = None, with_tangents: bool = False):
        """positions x [N, 3] -> features [N, num_levels * F] (JAX
        components.py:82-103); max_level keeps the first levels (the rest
        are zero). with_tangents: (features, d features / d x [3, N,
        num_levels * F]), the tangents through the rescale and the mask
        (model.py:615-621), on a slot grid only."""
        r = self.spec.radius
        rescaled = ((x + r) / (2.0 * r)).clamp(0.0, CLIP_HI)
        mask = self.level_mask(active_level, self.spec.encoding.num_levels)
        if not with_tangents:
            features = self.encoding(rescaled, max_level)
            return features if mask is None else features * mask
        features, tangents = slot_grid_lookup(self.encoding.table, rescaled, self.spec.encoding,
                                              max_level, with_tangents=True)
        tangents = tangents / (2.0 * r)  # chain rule through the rescale
        if mask is not None:
            features, tangents = features * mask, tangents * mask
        return features, tangents

    def level_mask(self, active_level: Optional[int], num_levels: int) -> Optional[torch.Tensor]:
        """Coarse-to-fine mask [num_levels * F] of the first num_levels
        levels, or None when every feature is live by construction."""
        if not self.spec.coarse_to_fine or active_level is None:
            return None
        fpl = self.spec.encoding.features_per_level
        level = torch.arange(num_levels * fpl, device=self.encoding.table.device) // fpl
        return (level < active_level).float()


class FeatureGridAndMLP(nn.Module):
    """Grid features concatenated with [xyz, auxiliary] into an MLP head
    (JAX components.py:106-130): the first 3 input columns are positions,
    the rest ride along."""

    def __init__(self, grid_spec: FeatureGridSpec, mlp_spec: MLPSpec, in_dim: int,
                 output_dim: int, device=None):
        super().__init__()
        self.feature_grid = FeatureGrid(grid_spec, device=device)
        self.mlp_head = MLP(mlp_spec, in_dim + grid_spec.encoding.out_dim, output_dim, device=device)

    def forward(self, x: torch.Tensor, active_level: Optional[int] = None,
                max_level: Optional[int] = None) -> torch.Tensor:
        positions = x[..., :3]
        features = self.feature_grid(positions, active_level, max_level)
        return self.mlp_head(torch.cat([positions, x[..., 3:], features], dim=-1))


class ModalityHead(nn.Module):
    """Per-modality radiance decoder: an MLP on the radiance feature."""

    def __init__(self, mlp_spec: MLPSpec, in_dim: int, output_dim: int, device=None):
        super().__init__()
        self.field = MLP(mlp_spec, in_dim, output_dim, device=device)

    def forward(self, radiance_feature, directions=None, up_directions=None):
        return self.field(radiance_feature)


class PolarizationHead(nn.Module):
    """Stokes head: s0 through leaky ReLU, rotation into the camera
    polarizer frame, projection to the 0/45/90/135-degree intensities."""

    def __init__(self, mlp_spec: MLPSpec, in_dim: int, device=None):
        super().__init__()
        self.field = MLP(mlp_spec, in_dim, 3, device=device)

    def forward(self, radiance_feature, directions, up_directions):
        stokes = self.field(radiance_feature)
        s0 = nn.functional.leaky_relu(stokes[..., 0:1], 0.01)
        stokes = torch.cat([s0, stokes[..., 1:]], dim=-1)
        aligned = align_polarization_filters(stokes, directions, up_directions)
        channels, _ = stokes_to_intensity(aligned)
        return channels
