"""Loss manager: per-modality radiance losses and the geometry losses
(JAX reference: engine/losses.py)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

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


def _elementwise(loss: str, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    if loss == "L1":
        return (pred - target).abs()
    if loss == "MSE":
        return (pred - target) ** 2
    raise ValueError(f"unknown loss {loss}")


def radiance_loss(spec: RadianceLossSpec, pred: torch.Tensor, target: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-modality radiance loss [N, C] -> scalar (losses.py:63-85).

    Saturation skipping zeroes the residuals of saturated target pixels
    but keeps them in the mean's denominator. Channel decimation supervises
    one channel per pixel drawn from the configured distribution (with a
    generator only, as the reference draws only with an rng)."""
    if spec.per_channel_probability is not None and generator is not None:
        probs = torch.as_tensor(spec.per_channel_probability, dtype=torch.float32,
                                device=pred.device)
        idx = torch.multinomial(probs, pred.shape[0], replacement=True, generator=generator)
        pred = pred.gather(-1, idx[:, None])
        target = target.gather(-1, idx[:, None])
    err = _elementwise(spec.loss, pred, target)
    if spec.saturation_threshold is not None:
        err = torch.where(target > spec.saturation_threshold, torch.zeros_like(err), err)
    return err.mean()


def eikonal_loss(spec: GeometryLossSpec, gradients: torch.Tensor) -> torch.Tensor:
    """||grad sdf|| -> 1 with the safe norm sqrt(sum g^2 + 1e-12): an
    all-zero SDF gradient would otherwise give a NaN gradient
    (losses.py:88-98)."""
    grad_norm = torch.sqrt((gradients * gradients).sum(-1) + 1e-12)
    return _elementwise(spec.eikonal_loss, grad_norm, torch.ones_like(grad_norm)).mean()


def curvature_loss(spec: GeometryLossSpec, hessians: torch.Tensor) -> torch.Tensor:
    """L1 on the laplacian proxy (losses.py:101-104); hessians [..., 3]."""
    laplacian = hessians.sum(-1)
    return _elementwise(spec.curvature_loss or "L1", laplacian, torch.zeros_like(laplacian)).mean()


def compute_losses(spec: LossManagerSpec, outputs: Dict[str, torch.Tensor],
                   targets: Dict[str, torch.Tensor], step: int, max_iters: int, grid,
                   generator: Optional[torch.Generator] = None, train: bool = True):
    """All losses and the weighted total (losses.py:107-153): radiance per
    modality, then in training the eikonal loss and the curvature loss with
    its warm-up weight. Returns (losses, total)."""
    losses: Dict[str, torch.Tensor] = {}
    total = 0.0
    for mod in targets:
        lspec = spec.radiance_spec(mod)
        loss = radiance_loss(lspec, outputs[mod], targets[mod], generator)
        losses[mod] = loss
        weight = lspec.weight
        if lspec.scheduler is not None:
            weight = weight * lspec.scheduler.factor(step, max_iters)
        total = total + weight * loss
    if train:
        g = spec.geometry
        if outputs.get("gradients") is not None:
            loss = eikonal_loss(g, outputs["gradients"])
            losses["eikonal_loss"] = loss
            total = total + g.eikonal_weight * loss
        if g.curvature_loss is not None and outputs.get("hessians") is not None:
            loss = curvature_loss(g, outputs["hessians"])
            weight = g.curvature_weight
            if g.curvature_scheduler is not None and grid is not None:
                weight = weight * g.curvature_scheduler.factor(step, max_iters, grid)
            losses["curvature_loss"] = loss
            losses["curvature_weight"] = torch.as_tensor(weight)
            total = total + weight * loss
    return losses, total
