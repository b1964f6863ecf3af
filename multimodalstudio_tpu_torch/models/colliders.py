"""Scene colliders: near/far bounds and a region-of-interest mask
(JAX reference: models/colliders.py). Every ray is kept; the hit mask
travels as a float vector."""

from __future__ import annotations

from typing import Tuple

import torch

from multimodalstudio_tpu_torch.core.rays import RayBundle


def near_far_collide(rays: RayBundle, near: float, far: float) -> Tuple[RayBundle, torch.Tensor]:
    """Constant near/far bounds; every ray hits (colliders.py:18-27)."""
    n, o = rays.origins.shape[0], rays.origins
    nears = torch.full((n, 1), float(near), dtype=o.dtype, device=o.device)
    fars = torch.full((n, 1), float(far), dtype=o.dtype, device=o.device)
    return rays.replace(nears=nears, fars=fars), torch.ones(n, dtype=o.dtype, device=o.device)


def box_collide(rays: RayBundle, aabb) -> Tuple[RayBundle, torch.Tensor]:
    """Axis-aligned box intersection (colliders.py:30-43), the reference's
    numbers kept: a direction component under 1e-9 in magnitude becomes
    +1e-9 (a tiny negative one too), nears clamp to 0.01 and fars to
    near + 0.01, and the mask is (tmax > tmin) & (tmax > 0)."""
    o, d = rays.origins, rays.directions
    lo = torch.tensor(aabb[0], dtype=o.dtype, device=o.device)
    hi = torch.tensor(aabb[1], dtype=o.dtype, device=o.device)
    inv = 1.0 / torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    tmin = torch.minimum(t0, t1).amax(-1, keepdim=True)
    tmax = torch.maximum(t0, t1).amin(-1, keepdim=True)
    mask = ((tmax > tmin) & (tmax > 0.0))[:, 0].to(o.dtype)
    nears = tmin.clamp_min(0.01)
    return rays.replace(nears=nears, fars=torch.maximum(tmax, nears + 0.01)), mask


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
