"""The training step (JAX reference: engine/train.py), as plain functions
on tensors.

A step renders each ray microbatch through the model, backpropagates its
loss (the kernels' CUDA backwards on the card), sums the gradients and
divides by the number of microbatches, then applies one update: global-norm
clipping across both parameter groups, then AdamW per group with a
scheduled learning rate. A step whose gradient is not finite leaves the
parameters and the optimizer state, its count included, as they were.

The optimizer is written out instead of using torch.optim, to keep optax's
semantics (train.py:62-98): clipping scales by max_norm / norm only when
norm >= max_norm, with no epsilon; the learning rate reads the number of
updates applied so far; weight decay applies to every leaf; eps is added
outside the square root.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from multimodalstudio_tpu_torch.cameras.camera_optimizer import camera_opt_transform
from multimodalstudio_tpu_torch.cameras.cameras import Cameras, generate_rays
from multimodalstudio_tpu_torch.configs.config import OptimizerSpec, TrainerConfig
from multimodalstudio_tpu_torch.core.rays import RayBundle
from multimodalstudio_tpu_torch.data.device_cache import DeviceDataCache, sample_pixel_batch
from multimodalstudio_tpu_torch.data.sampler import PixelBatch
from multimodalstudio_tpu_torch.engine.losses import compute_losses
from multimodalstudio_tpu_torch.engine.schedules import (
    active_level,
    cos_anneal_ratio,
    numerical_gradients_delta,
)
from multimodalstudio_tpu_torch.models.model import MMSModel, ScheduleState
from multimodalstudio_tpu_torch.ops.math import psnr

Params = Dict[str, Dict[str, torch.Tensor]]  # {"fields": {...}, "camera_poses": {...}}


@dataclasses.dataclass
class OptState:
    """AdamW state: the number of updates applied so far and the moments
    of every leaf, keyed like the params."""

    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass
class TrainState:
    """What a step reads and updates besides the model's own parameters:
    the camera pose tangents {modality: [K, 6]}, the step and, in
    training, the optimizer state. A render reads the first two."""

    camera_poses: Dict[str, torch.Tensor]
    step: int
    opt_state: Optional[OptState] = None


def make_schedules(config: TrainerConfig, step: int) -> ScheduleState:
    grid = config.model.surface.surface_field.field.grid
    return ScheduleState(
        cos_anneal_ratio=cos_anneal_ratio(
            step, config.max_num_iterations, config.model.surface.anneal_end_ratio
        ),
        active_level=active_level(step, config.max_num_iterations, grid),
        numerical_delta=numerical_gradients_delta(step, config.max_num_iterations, grid),
    )


def train_params(model: MMSModel, camera_poses: Dict[str, torch.Tensor]) -> Params:
    """The two optimizer groups: every model parameter, and the camera pose
    tangents."""
    return {"fields": dict(model.named_parameters()), "camera_poses": dict(camera_poses)}


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax.adamw with a scheduled learning rate: spec.lr * factor(count)."""

    spec: OptimizerSpec
    max_iters: int

    def learning_rate(self, count: int) -> float:
        if self.spec.scheduler is None:
            return self.spec.lr
        return self.spec.lr * self.spec.scheduler.factor(count, self.max_iters)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """clip_by_global_norm(max_norm) over both groups, then one AdamW per
    group (train.py:62-98)."""

    groups: Tuple[Tuple[str, AdamW], ...]
    max_norm: float

    def init(self, params: Params) -> OptState:
        zeros = {g: {k: torch.zeros_like(p) for k, p in ps.items()} for g, ps in params.items()}
        return OptState(count=0, mu=zeros,
                        nu={g: {k: torch.zeros_like(p) for k, p in ps.items()} for g, ps in params.items()})

    def update(self, grads: Params, state: OptState, params: Params) -> Tuple[Params, OptState]:
        """(updates to add to the params, next state); pure."""
        leaves = [g for group in grads.values() for g in group.values()]
        g_norm = torch.sqrt(sum((g * g).sum() for g in leaves))
        clip = g_norm < self.max_norm
        count_inc = state.count + 1
        updates, mu, nu = {}, {}, {}
        for name, adam in self.groups:
            b1, b2 = adam.spec.betas
            # bias corrections in float32, as optax computes them
            bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=g_norm.device) ** count_inc
            bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=g_norm.device) ** count_inc
            lr = adam.learning_rate(state.count)
            updates[name], mu[name], nu[name] = {}, {}, {}
            for key, g in grads[name].items():
                g = torch.where(clip, g, (g / g_norm) * self.max_norm)
                m = (1 - b1) * g + b1 * state.mu[name][key]
                v = (1 - b2) * (g * g) + b2 * state.nu[name][key]
                u = (m / bc1) / (torch.sqrt(v / bc2) + adam.spec.eps)
                u = u + adam.spec.weight_decay * params[name][key].detach()
                updates[name][key] = u * (-lr)
                mu[name][key], nu[name][key] = m, v
        return updates, OptState(count=count_inc, mu=mu, nu=nu)


def make_optimizer(config: TrainerConfig) -> Optimizer:
    for group in ("fields", "camera_poses"):
        if config.optimizer_spec(group).optimizer.lower() != "adamw":
            raise NotImplementedError("only the AdamW optimizer groups are ported")
    return Optimizer(
        groups=tuple((g, AdamW(config.optimizer_spec(g), config.max_num_iterations))
                     for g in ("fields", "camera_poses")),
        max_norm=config.optimizer_spec("fields").max_norm,
    )


def init_train_state(config: TrainerConfig, model: MMSModel,
                     camera_poses: Dict[str, torch.Tensor], step: int = 0) -> TrainState:
    """A train state on the model's current parameters and the given pose
    tangents (leaves requiring grad), with zeroed optimizer moments."""
    poses = {m: p.detach().clone().requires_grad_(True) for m, p in camera_poses.items()}
    opt_state = make_optimizer(config).init(train_params(model, poses))
    return TrainState(camera_poses=poses, step=step, opt_state=opt_state)


def guarded_update(opt: Optimizer, grads: Params, params: Params, state: TrainState) -> float:
    """Apply one update in place unless a gradient is not finite
    (train.py:260-282); returns grads_finite (1.0 or 0.0). A skipped step
    leaves params and optimizer state, count included, as they were."""
    finite = bool(torch.stack([torch.isfinite(g).all() for group in grads.values()
                               for g in group.values()]).all())
    if not finite:
        return 0.0
    updates, state.opt_state = opt.update(grads, state.opt_state, params)
    with torch.no_grad():
        for name, group in updates.items():
            for key, u in group.items():
                params[name][key].add_(u)
    return 1.0


# ------------------------------------------------------------------- rays


def stack_cameras(cameras: Dict[str, Cameras], modalities) -> Tuple[Cameras, Dict[str, int]]:
    """One camera table for all modalities and each modality's index offset
    (train.py:116-150); one camera type throughout."""
    mods = list(modalities)
    if len({cameras[m].camera_type for m in mods}) > 1:
        raise ValueError("stacked ray generation requires a uniform camera type")
    any_dist = any(cameras[m].distortion_params is not None for m in mods)

    def dist(m):
        c = cameras[m]
        return c.distortion_params if c.distortion_params is not None else torch.zeros(
            (c.num_cameras, 6), device=c.device)

    offsets, off = {}, 0
    for m in mods:
        offsets[m] = off
        off += cameras[m].num_cameras
    first = cameras[mods[0]]
    stacked = Cameras(
        fx=torch.cat([cameras[m].fx for m in mods]),
        fy=torch.cat([cameras[m].fy for m in mods]),
        cx=torch.cat([cameras[m].cx for m in mods]),
        cy=torch.cat([cameras[m].cy for m in mods]),
        camera_to_worlds=torch.cat([cameras[m].camera_to_worlds for m in mods]),
        distortion_params=torch.cat([dist(m) for m in mods]) if any_dist else None,
        width=first.width, height=first.height, pixel_offset=first.pixel_offset,
        camera_type=first.camera_type,
    )
    return stacked, offsets


def build_rays(config: TrainerConfig, camera_poses: Dict[str, torch.Tensor],
               cameras: Dict[str, Cameras], batch: Dict[str, PixelBatch]
               ) -> Tuple[RayBundle, Tuple[Tuple[str, int], ...]]:
    """Rays of every modality's pixels from one generate_rays call over the
    stacked cameras, with each modality's pose correction, in float32
    (train.py:153-200)."""
    stacked, offsets = stack_cameras(cameras, config.modalities)
    mods = config.modalities
    segments = tuple((m, batch[m].pixel_coords.shape[0]) for m in mods)
    idx = torch.cat([batch[m].camera_indices.long() + offsets[m] for m in mods])
    coords = torch.cat([batch[m].pixel_coords for m in mods])
    opt_spec = config.datamanager.camera_optimizer
    opt = None
    if opt_spec.mode != "off" and camera_poses:
        opts = []
        for m in mods:
            o = camera_opt_transform(opt_spec, camera_poses, m, batch[m].camera_indices)
            if o is None:
                o = torch.eye(3, 4, device=coords.device).expand(batch[m].camera_indices.shape[0], 3, 4)
            opts.append(o)
        opt = torch.cat(opts)
    return generate_rays(stacked, idx, coords, opt), segments


def select_mosaick_channels(config: TrainerConfig, outputs, batch):
    """Raw data: keep only the mosaick channel of each pixel (train.py:203-215)."""
    if not config.datamanager.raw:
        return outputs
    out = dict(outputs)
    for m in config.modalities:
        out[m] = outputs[m].gather(-1, batch[m].mosaick_channel.long()[:, None])
    return out


# ------------------------------------------------------------------- step


def _slice(batch: Dict[str, PixelBatch], start: int, stop: int) -> Dict[str, PixelBatch]:
    return {m: PixelBatch(*(getattr(b, f.name)[start:stop] for f in dataclasses.fields(b)))
            for m, b in batch.items()}


def batch_loss_and_grads(config: TrainerConfig, model: MMSModel, cameras, camera_poses, batch,
                         step: int, schedules: ScheduleState,
                         generator: Optional[torch.Generator] = None):
    """Loss and gradients of one batch (train.py:285-349): one backward per
    microbatch of `microbatch_rays` rays per modality, gradients summed and
    divided by the number of microbatches, losses and metrics averaged
    (min_grad_norm included). Each microbatch's graph, the kernels'
    residuals with it, is freed by its backward. Returns (total, losses,
    metrics, grads) with grads keyed like train_params."""
    n = config.datamanager.num_rays_per_modality
    micro = config.datamanager.microbatch_rays
    m = 1 if micro <= 0 or micro >= n else n // micro
    if m > 1 and n % micro:
        raise ValueError(f"num_rays_per_modality {n} not divisible by microbatch {micro}")
    size = n // m
    grid = config.model.surface.surface_field.field.grid
    params = train_params(model, camera_poses)
    for group in params.values():
        for p in group.values():
            p.grad = None
    totals, losses, metrics = [], {}, {}
    for i in range(m):
        mb = _slice(batch, i * size, (i + 1) * size)
        rays, segments = build_rays(config, camera_poses, cameras, mb)
        outputs = model(rays, segments, schedules, train=True, generator=generator)
        outputs = select_mosaick_channels(config, outputs, mb)
        targets = {mod: mb[mod].pixels for mod in config.modalities}
        lo, total = compute_losses(config.loss_manager, outputs, targets, step,
                                   config.max_num_iterations, grid, generator, train=True)
        total.backward()
        totals.append(total.detach())
        for k, v in lo.items():
            losses.setdefault(k, []).append(torch.as_tensor(v).detach())
        with torch.no_grad():
            for mod in config.modalities:
                metrics.setdefault(f"psnr_{mod}", []).append(psnr(outputs[mod], targets[mod]))
            if outputs.get("gradients") is not None:
                g = outputs["gradients"]
                metrics.setdefault("min_grad_norm", []).append(torch.sqrt((g * g).sum(-1).min()))
    grads = {name: {k: (p.grad / m if p.grad is not None else torch.zeros_like(p))
                    for k, p in group.items()} for name, group in params.items()}
    mean = lambda vals: torch.stack([v.float().to(totals[0].device) for v in vals]).mean()  # noqa: E731
    return (mean(totals), {k: mean(v) for k, v in losses.items()},
            {k: mean(v) for k, v in metrics.items()}, grads)


def make_train_step(config: TrainerConfig, model: MMSModel, cameras: Dict[str, Cameras]):
    """train_step(state, batch, generator=None) -> (state, aux): one
    guarded update on a pixel batch; `generator` feeds the samplers'
    jitter (none: no jitter). Updates the model and `state` in place."""
    opt = make_optimizer(config)

    def train_step(state: TrainState, batch: Dict[str, PixelBatch],
                   generator: Optional[torch.Generator] = None):
        step = state.step
        total, losses, metrics, grads = batch_loss_and_grads(
            config, model, cameras, state.camera_poses, batch, step, make_schedules(config, step),
            generator)
        metrics["grads_finite"] = guarded_update(opt, grads, train_params(model, state.camera_poses),
                                                 state)
        state.step = step + 1
        losses["total_loss"] = total
        return state, {"losses": losses, "metrics": metrics}

    return train_step


def make_train_steps(config: TrainerConfig, model: MMSModel, cameras: Dict[str, Cameras]):
    """train_steps(state, cache, generator, k) -> (state, aux of the last
    step): k steps, each drawing its pixel batch on the device from the
    cache (train.py:352-405); the generator also feeds the samplers'
    jitter."""
    step_fn = make_train_step(config, model, cameras)

    def train_steps(state: TrainState, cache: DeviceDataCache, generator: torch.Generator, k: int):
        aux = None
        for _ in range(k):
            batch = sample_pixel_batch(cache, generator, config.datamanager.num_rays_per_modality,
                                       config.modalities)
            state, aux = step_fn(state, batch, generator)
        return state, aux

    return train_steps
