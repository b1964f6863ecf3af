"""Per-step schedules as plain functions of the integer step
(JAX reference: engine/schedules.py)."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence


def cos_anneal_ratio(step: int, max_iters: int, anneal_end_ratio: float) -> float:
    """NeuS cosine anneal, 0 -> 1 over the first `anneal_end_ratio` fraction."""
    if anneal_end_ratio <= 0:
        return 1.0
    anneal_end = max(int(max_iters * anneal_end_ratio), 1)
    return min(1.0, step / anneal_end)


def steps_per_level(max_iters: int, grid) -> int:
    spl = int(max_iters * grid.steps_per_level_ratio)
    return max(min(spl, int(max_iters / grid.encoding.num_levels)), 1)


def active_level(step: int, max_iters: int, grid) -> int:
    """Active grid level for the coarse-to-fine mask."""
    if grid is None or not grid.coarse_to_fine:
        return 1 << 20
    level = max(int(step) // steps_per_level(max_iters, grid) + 1, grid.level_init)
    return min(level, grid.encoding.num_levels)


def numerical_gradients_delta(step: int, max_iters: int, grid) -> float:
    """Numerical-gradient epsilon annealed with the active grid resolution."""
    if grid is None:
        return 1e-4
    enc = grid.encoding
    lvl = math.floor(step / steps_per_level(max_iters, grid))
    delta = 1.0 / (enc.min_res * enc.growth_factor**lvl)
    return max(1.0 / enc.max_res, delta) * (grid.radius * 2.0)


@dataclasses.dataclass(frozen=True)
class MultiStepWarmupSpec:
    """Linear warm-up then gamma^k at milestone fractions."""

    warm_up_ratio: float = 0.1
    milestones: Sequence[float] = (0.5, 0.75, 0.9)
    gamma: float = 0.4

    def factor(self, step: int, max_iters: int) -> float:
        warm_up_end = max(int(max_iters * self.warm_up_ratio), 1)
        if step < warm_up_end:
            return step / warm_up_end
        return self.gamma ** sum(m < step / max_iters for m in self.milestones)


@dataclasses.dataclass(frozen=True)
class ExponentialDecaySpec:
    """Log-linear decay to lr_final_ratio, with an optional sine-eased
    delay (schedules.py:86-104)."""

    lr_final_ratio: float = 0.1
    lr_delay_steps_ratio: float = 0.0
    lr_delay_mult: float = 1.0

    def factor(self, step: int, max_iters: int) -> float:
        delay_steps = int(max_iters * self.lr_delay_steps_ratio)
        delay = 1.0
        if delay_steps > 0:
            delay = self.lr_delay_mult + (1 - self.lr_delay_mult) * math.sin(
                0.5 * math.pi * min(max(step / delay_steps, 0.0), 1.0))
        t = min(max(step / max_iters, 0.0), 1.0)
        return delay * math.exp(math.log(1.0) * (1 - t) + math.log(self.lr_final_ratio) * t)


@dataclasses.dataclass(frozen=True)
class NeuSSchedulerSpec:
    """Linear warm-up then cosine decay to learning_rate_alpha
    (schedules.py:107-120)."""

    warm_up_ratio: float = 0.1
    learning_rate_alpha: float = 0.05

    def factor(self, step: int, max_iters: int) -> float:
        warm_up_end = max(int(max_iters * self.warm_up_ratio), 1)
        if step < warm_up_end:
            return step / warm_up_end
        alpha = self.learning_rate_alpha
        progress = (step - warm_up_end) / max(max_iters - warm_up_end, 1)
        return (math.cos(math.pi * progress) + 1.0) * 0.5 * (1 - alpha) + alpha


@dataclasses.dataclass(frozen=True)
class CosineRaiseSpec:
    """Cosine raise from learning_rate_alpha to 1 over the first
    saturation_ratio of training (schedules.py:123-136)."""

    saturation_ratio: float = 0.5
    learning_rate_alpha: float = 0.05

    def factor(self, step: int, max_iters: int) -> float:
        start = max(int(max_iters * self.saturation_ratio), 1)
        if step >= start:
            return 1.0
        alpha = self.learning_rate_alpha
        return (-math.cos(math.pi * step / start) + 1.0) * 0.5 * (1 - alpha) + alpha


@dataclasses.dataclass(frozen=True)
class MaskedSchedulerSpec:
    """Zero before mask_ratio of training, then the inner schedule's factor
    or learning_factor (schedules.py:139-154)."""

    mask_ratio: float = 0.5
    inner: Optional[object] = None
    learning_factor: float = 1.0

    def factor(self, step: int, max_iters: int) -> float:
        if step < self.mask_ratio * max_iters:
            return 0.0
        if self.inner is None:
            return self.learning_factor
        return self.inner.factor(step, max_iters)


@dataclasses.dataclass(frozen=True)
class CurvatureWarmupSpec:
    """Curvature-loss weight: warm-up then decay 1/growth^(level-1)."""

    warm_up_ratio: float = 0.1

    def factor(self, step: int, max_iters: int, grid) -> float:
        warm_up_end = max(int(max_iters * self.warm_up_ratio), 1)
        if step < warm_up_end:
            return step / warm_up_end
        enc = grid.encoding
        level = min(max(step // steps_per_level(max_iters, grid) + 1, grid.level_init), enc.num_levels)
        return 1.0 / enc.growth_factor ** (level - 1)
