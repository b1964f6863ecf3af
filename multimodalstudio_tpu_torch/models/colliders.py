"""Scene colliders: near/far bounds and a region-of-interest mask
(JAX reference: models/colliders.py). Every ray is kept; the hit mask
travels as a float vector."""

from __future__ import annotations

from typing import Tuple

import torch

from multimodalstudio_tpu_torch.core.rays import RayBundle


def sphere_collide(rays: RayBundle, radius: float = 1.0) -> Tuple[RayBundle, torch.Tensor]:
    """Ray-sphere near/far (clamped to >= 0.01) and a float hit mask [N] of
    rays whose discriminant exceeds 0.01."""
    ray_cam_dot = (rays.directions * rays.origins).sum(-1, keepdim=True)
    norm_sq = (rays.origins * rays.origins).sum(-1, keepdim=True)
    under_sqrt = ray_cam_dot**2 - (norm_sq - radius**2)
    mask = (under_sqrt[:, 0] > 0.01).to(rays.origins.dtype)
    half = torch.sqrt(under_sqrt.clamp_min(0.01))
    nears = (-half - ray_cam_dot).clamp_min(0.01)
    fars = (half - ray_cam_dot).clamp_min(0.01)
    return rays.replace(nears=nears, fars=fars), mask


def background_bounds(rays: RayBundle, mask: torch.Tensor, radius: float = 1.0) -> RayBundle:
    """Background sampling range: hit rays start at their ROI far, the rest
    at their near; all end 3 units past their far."""
    collided, _ = sphere_collide(rays, radius)
    m = mask[:, None]
    nears = m * collided.fars + (1.0 - m) * collided.nears
    return rays.replace(nears=nears, fars=collided.fars + 3.0)
