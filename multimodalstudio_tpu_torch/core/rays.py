"""Ray bundles and samples (JAX reference: core/rays.py).

Flat static shapes: a bundle is [num_rays], samples are [num_rays,
num_samples]; region-of-interest membership travels as a float mask.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class RayBundle:
    origins: torch.Tensor  # [N, 3]
    directions: torch.Tensor  # [N, 3] unit
    up_directions: torch.Tensor  # [N, 3] camera +Y in world (polarization)
    pixel_area: torch.Tensor  # [N, 1]
    camera_indices: torch.Tensor  # [N] int
    directions_norm: torch.Tensor  # [N, 1] pre-normalization norm
    nears: Optional[torch.Tensor] = None  # [N, 1]
    fars: Optional[torch.Tensor] = None  # [N, 1]

    @property
    def num_rays(self) -> int:
        return self.origins.shape[0]

    def replace(self, **kw) -> "RayBundle":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class RaySamples:
    origins: torch.Tensor  # [N, 3]
    directions: torch.Tensor  # [N, 3]
    up_directions: torch.Tensor  # [N, 3]
    starts: torch.Tensor  # [N, S]
    ends: torch.Tensor  # [N, S]
    deltas: torch.Tensor  # [N, S]
    spacing_starts: torch.Tensor  # [N, S]
    spacing_ends: torch.Tensor  # [N, S]

    @property
    def num_rays(self) -> int:
        return self.starts.shape[0]

    @property
    def num_samples(self) -> int:
        return self.starts.shape[1]

    def start_positions(self) -> torch.Tensor:
        """[N, S, 3] frustum start points (NeuS section convention)."""
        return self.origins[:, None, :] + self.directions[:, None, :] * self.starts[..., None]


def samples_from_bins(
    rays: RayBundle, euclid_bins: torch.Tensor, spacing_bins: torch.Tensor
) -> RaySamples:
    """RaySamples from [N, S+1] euclidean and spacing bin edges."""
    return RaySamples(
        origins=rays.origins,
        directions=rays.directions,
        up_directions=rays.up_directions,
        starts=euclid_bins[:, :-1],
        ends=euclid_bins[:, 1:],
        deltas=euclid_bins[:, 1:] - euclid_bins[:, :-1],
        spacing_starts=spacing_bins[:, :-1],
        spacing_ends=spacing_bins[:, 1:],
    )


def weights_from_alphas(alphas: torch.Tensor) -> torch.Tensor:
    """weights_i = alpha_i * prod_{j<i} (1 - alpha_j + 1e-7), [N, S]."""
    shifted = torch.cat(
        [torch.ones_like(alphas[:, :1]), 1.0 - alphas[:, :-1] + 1e-7], dim=-1
    )
    return alphas * torch.cumprod(shifted, dim=-1)


def alphas_from_densities(deltas: torch.Tensor, densities: torch.Tensor) -> torch.Tensor:
    """alpha = 1 - exp(-delta * density), [N, S]."""
    return 1.0 - torch.exp(-deltas * densities)


def weights_from_densities(deltas: torch.Tensor, densities: torch.Tensor) -> torch.Tensor:
    """Exponential-transmittance weights [N, S]: alpha_i * exp(-sum_{j<i}
    delta_j density_j) (rays.py:124-133)."""
    delta_density = deltas * densities
    alphas = 1.0 - torch.exp(-delta_density)
    accum = torch.cat([torch.zeros_like(delta_density[:, :1]),
                       torch.cumsum(delta_density[:, :-1], dim=-1)], dim=-1)
    return alphas * torch.exp(-accum)
