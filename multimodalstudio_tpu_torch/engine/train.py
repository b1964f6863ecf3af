"""Training-state pieces the renderer needs (JAX reference: engine/train.py):
the per-step schedules and the state a render reads. The training step
itself comes with the training slice."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from multimodalstudio_tpu_torch.configs.config import TrainerConfig
from multimodalstudio_tpu_torch.engine.schedules import (
    active_level,
    cos_anneal_ratio,
    numerical_gradients_delta,
)
from multimodalstudio_tpu_torch.models.model import ScheduleState


@dataclasses.dataclass
class TrainState:
    """What a render reads besides the model's own parameters: the camera
    pose tangents {modality: [K, 6]} and the step."""

    camera_poses: Dict[str, torch.Tensor]
    step: int


def make_schedules(config: TrainerConfig, step: int) -> ScheduleState:
    grid = config.model.surface.surface_field.field.grid
    return ScheduleState(
        cos_anneal_ratio=cos_anneal_ratio(
            step, config.max_num_iterations, config.model.surface.anneal_end_ratio
        ),
        active_level=active_level(step, config.max_num_iterations, grid),
        numerical_delta=numerical_gradients_delta(step, config.max_num_iterations, grid),
    )
