"""Cameras and ray generation (JAX reference: cameras/cameras.py).

Ray generation for a pixel batch (intrinsics lookup, Newton undistortion,
per-type direction math, pose-delta composition, up-directions, pixel
area) runs as tensor code on the cameras' device, in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from multimodalstudio_tpu_torch.core.rays import RayBundle
from multimodalstudio_tpu_torch.ops.distortion import radial_and_tangential_undistort
from multimodalstudio_tpu_torch.ops.lie_groups import pose_multiply

PERSPECTIVE = 1
FISHEYE = 2
EQUIRECTANGULAR = 3


@dataclasses.dataclass
class Cameras:
    """One modality's cameras, one entry per frame: fx/fy/cx/cy [F],
    camera_to_worlds [F, 3, 4], distortion_params [F, 6] or None."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    camera_to_worlds: torch.Tensor
    distortion_params: Optional[torch.Tensor] = None
    width: int = 0
    height: int = 0
    pixel_offset: float = 0.5
    camera_type: int = PERSPECTIVE

    @property
    def num_cameras(self) -> int:
        return self.fx.shape[0]

    @property
    def device(self) -> torch.device:
        return self.fx.device

    def rescaled(self, scale: float) -> "Cameras":
        """The intrinsics of a render at `scale` times the resolution
        (cameras.py:54-64)."""
        return dataclasses.replace(
            self, fx=self.fx * scale, fy=self.fy * scale, cx=self.cx * scale,
            cy=self.cy * scale, width=int(self.width * scale), height=int(self.height * scale))


def generate_rays(
    cameras: Cameras,
    camera_indices: torch.Tensor,
    pixel_coords: torch.Tensor,
    camera_opt_to_camera: Optional[torch.Tensor] = None,
) -> RayBundle:
    """World-space rays for [N, 2] (y, x) pixel coordinates (pixel offset
    already applied). A 3-way stack (coord, +1x, +1y) feeds undistortion and
    the adjacent-ray pixel area."""
    idx = camera_indices.long()
    fx, fy = cameras.fx[idx], cameras.fy[idx]
    cx, cy = cameras.cx[idx], cameras.cy[idx]
    y, x = pixel_coords[..., 0], pixel_coords[..., 1]

    coord = torch.stack([(x - cx) / fx, -(y - cy) / fy], -1)
    coord_x = torch.stack([(x - cx + 1) / fx, -(y - cy) / fy], -1)
    coord_y = torch.stack([(x - cx) / fx, -(y - cy + 1) / fy], -1)
    coord_stack = torch.stack([coord, coord_x, coord_y], dim=0)  # [3, N, 2]

    if cameras.distortion_params is not None and cameras.camera_type != EQUIRECTANGULAR:
        dist = cameras.distortion_params[idx]
        coord_stack = radial_and_tangential_undistort(coord_stack, dist[None])

    if cameras.camera_type == PERSPECTIVE:
        dirs_stack = torch.cat([coord_stack, -torch.ones_like(coord_stack[..., :1])], dim=-1)
    elif cameras.camera_type == FISHEYE:
        theta = torch.sqrt((coord_stack**2).sum(-1)).clamp(0.0, math.pi)
        sin_over = torch.sin(theta) / theta.clamp_min(1e-12)
        dirs_stack = torch.stack(
            [coord_stack[..., 0] * sin_over, coord_stack[..., 1] * sin_over, -torch.cos(theta)],
            dim=-1,
        )
    elif cameras.camera_type == EQUIRECTANGULAR:
        theta = -math.pi * coord_stack[..., 0]
        phi = math.pi * (0.5 - coord_stack[..., 1])
        dirs_stack = torch.stack(
            [-torch.sin(theta) * torch.sin(phi), torch.cos(phi), -torch.cos(theta) * torch.sin(phi)],
            dim=-1,
        )
    else:
        raise ValueError(f"camera type {cameras.camera_type} not supported")

    c2w = cameras.camera_to_worlds[idx]  # [N, 3, 4]
    if camera_opt_to_camera is not None:
        c2w = pose_multiply(c2w, camera_opt_to_camera)
    rotation = c2w[..., :3, :3]

    dirs_world = (dirs_stack[..., None, :] * rotation[None]).sum(-1)  # [3, N, 3]
    directions_norm = torch.linalg.vector_norm(dirs_world[0], dim=-1, keepdim=True)
    dirs_world = dirs_world / torch.linalg.vector_norm(dirs_world, dim=-1, keepdim=True).clamp_min(1e-12)
    directions = dirs_world[0]
    dx = torch.sqrt(((directions - dirs_world[1]) ** 2).sum(-1))
    dy = torch.sqrt(((directions - dirs_world[2]) ** 2).sum(-1))
    return RayBundle(
        origins=c2w[..., :3, 3],
        directions=directions,
        up_directions=rotation[..., :, 1],
        pixel_area=(dx * dy)[..., None],
        camera_indices=idx,
        directions_norm=directions_norm,
    )
