"""Per-modality camera pose corrections (JAX reference:
cameras/camera_optimizer.py). Pose deltas are [K, 6] tangents per
modality; the exp map turns them into [N, 3, 4] transforms."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from multimodalstudio_tpu_torch.ops.lie_groups import exp_map_SE3, exp_map_SO3xR3


@dataclasses.dataclass(frozen=True)
class CameraOptimizerSpec:
    mode: str = "off"  # off | SO3xR3 | SE3
    shared_optimization: bool = False
    # (modality, optimize?) pairs; missing modalities default to True
    modalities_to_optimize: Tuple[Tuple[str, bool], ...] = ()

    def optimize(self, mod: str) -> bool:
        for name, flag in self.modalities_to_optimize:
            if name == mod:
                return flag
        return True


def init_camera_poses(
    spec: CameraOptimizerSpec, modalities, num_cameras: Dict[str, int], device="cpu"
) -> Dict[str, torch.Tensor]:
    """Zero tangents per modality ([1, 6] when shared)."""
    if spec.mode == "off":
        return {}
    return {
        mod: torch.zeros((1 if spec.shared_optimization else num_cameras[mod], 6), device=device)
        for mod in modalities
    }


def tangent_transform(
    spec: CameraOptimizerSpec, tangent: torch.Tensor, camera_indices: torch.Tensor
) -> torch.Tensor:
    """Tangents -> [N, 3, 4] exp-map transforms for the given frames."""
    if spec.shared_optimization:
        params = tangent.expand(camera_indices.shape[0], 6)
    else:
        params = tangent[camera_indices.long()]
    exp_map = exp_map_SO3xR3 if spec.mode == "SO3xR3" else exp_map_SE3
    return exp_map(params)


def camera_opt_transform(
    spec: CameraOptimizerSpec, camera_poses: Dict[str, torch.Tensor], mod: str,
    camera_indices: torch.Tensor,
) -> Optional[torch.Tensor]:
    """The modality's pose correction, or None when it has no tangents."""
    if spec.mode == "off" or mod not in camera_poses:
        return None
    return tangent_transform(spec, camera_poses[mod], camera_indices)
