"""Loss specs (JAX reference: engine/losses.py). The loss functions come
with the training step; the specs are here because TrainerConfig holds
them."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from multimodalstudio_tpu_torch.engine.schedules import CurvatureWarmupSpec


@dataclasses.dataclass(frozen=True)
class RadianceLossSpec:
    loss: str = "L1"  # L1 | MSE
    weight: float = 1.0
    saturation_threshold: Optional[float] = None
    per_channel_probability: Optional[Tuple[float, ...]] = None
    scheduler: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class GeometryLossSpec:
    eikonal_loss: str = "MSE"
    eikonal_weight: float = 0.1
    curvature_loss: Optional[str] = None  # "L1" when enabled
    curvature_weight: float = 5e-4
    curvature_scheduler: Optional[CurvatureWarmupSpec] = None


@dataclasses.dataclass(frozen=True)
class LossManagerSpec:
    radiance_losses: Tuple[Tuple[str, RadianceLossSpec], ...] = ()
    geometry: GeometryLossSpec = GeometryLossSpec()

    def radiance_spec(self, mod: str) -> RadianceLossSpec:
        for name, spec in self.radiance_losses:
            if name == mod:
                return spec
        return RadianceLossSpec()
