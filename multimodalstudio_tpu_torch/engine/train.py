"""The training step (JAX reference: engine/train.py), as plain functions
on tensors.

A step renders each ray microbatch through the model, backpropagates its
loss (the kernels' CUDA backwards on the card), sums the gradients and
divides by the number of microbatches, then applies one update: global-norm
clipping across both parameter groups, then AdamW, Adam or RAdam per group
with a scheduled learning rate. A step whose gradient is not finite leaves
the parameters and the optimizer state, its count included, as they were.

The optimizer is written out instead of using torch.optim, to keep optax's
semantics (train.py:62-98): clipping scales by max_norm / norm only when
norm >= max_norm, with no epsilon; the learning rate reads the number of
updates applied so far; AdamW's weight decay applies to every leaf, and
Adam and RAdam have none; eps is added outside the square root; RAdam's
rectification is optax.radam's, its length terms in float32.

Data parallel (`dp`, parallel/sharding.py): every rank holds the same
global batch and runs its own contiguous rows of each microbatch; the
summed gradients, the losses and each microbatch's per-modality MSE are
averaged over the ranks in one all-reduce before the finite check and the
clipping, and min_grad_norm is reduced with MIN, so every rank takes the
same update and logs the one-process step's metrics.
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
from multimodalstudio_tpu_torch.parallel.sharding import DataParallel, shard_batch

Params = Dict[str, Dict[str, torch.Tensor]]  # {"fields": {...}, "camera_poses": {...}}


@dataclasses.dataclass
class OptState:
    """Adam state (every group kind's): the number of updates applied so
    far and the moments of every leaf, keyed like the params."""

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


OPTIMIZERS = ("adamw", "adam", "radam")
RADAM_THRESHOLD = 5.0  # optax.scale_by_radam's variance tractability threshold


def pow_f32(base: float, n: int, device) -> torch.Tensor:
    """base ** n in float32 by repeated squaring, as XLA raises a float to
    an integer power (optax's bias corrections and RAdam's b2^t): torch's
    pow differs by an ulp, which RAdam's rho_t, a difference of two
    numbers near 2 / (1 - b2), magnifies."""
    result = torch.ones((), dtype=torch.float32, device=device)
    b = torch.tensor(base, dtype=torch.float32, device=device)
    while n:
        if n & 1:
            result = result * b
        b, n = b * b, n >> 1
    return result


@dataclasses.dataclass(frozen=True)
class AdamGroup:
    """optax.adamw, optax.adam or optax.radam (spec.optimizer) with a
    scheduled learning rate: spec.lr * factor(count) (train.py:66-83)."""

    spec: OptimizerSpec
    max_iters: int

    @property
    def kind(self) -> str:
        return self.spec.optimizer.lower()

    def learning_rate(self, count: int) -> float:
        if self.spec.scheduler is None:
            return self.spec.lr
        return self.spec.lr * self.spec.scheduler.factor(count, self.max_iters)

    def radam_scale(self, count_inc: int, device) -> Optional[torch.Tensor]:
        """RAdam's rectification r at the incremented count, as optax
        computes it in float32, or None where rho_t < 5 and the update is
        the bias-corrected first moment itself."""
        b2 = self.spec.betas[1]
        rho_inf = 2.0 / (1.0 - b2) - 1.0
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
        b2t = pow_f32(b2, count_inc, device)
        t = f32(count_inc)
        rho = f32(rho_inf) - 2 * t * b2t / (1 - b2t)
        if not bool(rho >= RADAM_THRESHOLD):
            return None
        return torch.sqrt((rho - 4.0) * (rho - 2.0) * rho_inf
                          / (f32((rho_inf - 4.0) * (rho_inf - 2.0)) * rho))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """clip_by_global_norm(max_norm) over both groups, then one AdamW, Adam
    or RAdam per group (train.py:62-98)."""

    groups: Tuple[Tuple[str, AdamGroup], ...]
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
            bc1 = 1.0 - pow_f32(b1, count_inc, g_norm.device)
            bc2 = 1.0 - pow_f32(b2, count_inc, g_norm.device)
            lr = adam.learning_rate(state.count)
            r = adam.radam_scale(count_inc, g_norm.device) if adam.kind == "radam" else None
            updates[name], mu[name], nu[name] = {}, {}, {}
            for key, g in grads[name].items():
                g = torch.where(clip, g, (g / g_norm) * self.max_norm)
                m = (1 - b1) * g + b1 * state.mu[name][key]
                v = (1 - b2) * (g * g) + b2 * state.nu[name][key]
                m_hat = m / bc1
                if adam.kind == "radam" and r is None:  # rho_t < 5: no second moment
                    u = m_hat
                else:
                    u = (m_hat if r is None else r * m_hat) / (torch.sqrt(v / bc2) + adam.spec.eps)
                if adam.kind == "adamw":
                    u = u + adam.spec.weight_decay * params[name][key].detach()
                updates[name][key] = u * (-lr)
                mu[name][key], nu[name][key] = m, v
        return updates, OptState(count=count_inc, mu=mu, nu=nu)


def make_optimizer(config: TrainerConfig) -> Optimizer:
    for group in ("fields", "camera_poses"):
        if config.optimizer_spec(group).optimizer.lower() not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {config.optimizer_spec(group).optimizer}")
    return Optimizer(
        groups=tuple((g, AdamGroup(config.optimizer_spec(g), config.max_num_iterations))
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
                         generator: Optional[torch.Generator] = None,
                         dp: Optional[DataParallel] = None):
    """Loss and gradients of one batch (train.py:285-349): one backward per
    microbatch of `microbatch_rays` rays per modality, gradients summed and
    divided by the number of microbatches, losses and metrics averaged
    (min_grad_norm included). Each microbatch's graph, the kernels'
    residuals with it, is freed by its backward. With `dp`, this rank runs
    its rows of each microbatch and the results are reduced over the ranks
    (module docstring). Returns (total, losses, metrics, grads) with grads
    keyed like train_params."""
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
    totals, losses, metrics, mses = [], {}, {}, {}
    for i in range(m):
        mb = shard_batch(_slice(batch, i * size, (i + 1) * size), dp)
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
                if dp is None:
                    metrics.setdefault(f"psnr_{mod}", []).append(psnr(outputs[mod], targets[mod]))
                else:
                    mses.setdefault(mod, []).append(((outputs[mod] - targets[mod]) ** 2).mean())
            if outputs.get("gradients") is not None:
                g = outputs["gradients"]
                metrics.setdefault("min_grad_norm", []).append(torch.sqrt((g * g).sum(-1).min()))
    grads = {name: {k: (p.grad / m if p.grad is not None else torch.zeros_like(p))
                    for k, p in group.items()} for name, group in params.items()}
    dev = totals[0].device
    stack = lambda vals: torch.stack([v.float().to(dev) for v in vals])  # noqa: E731
    if dp is not None:
        grads, totals, losses, metrics = _reduce_over_ranks(dp, grads, totals, losses, metrics,
                                                            mses, stack)
    return (stack(totals).mean(), {k: stack(v).mean() for k, v in losses.items()},
            {k: stack(v).mean() for k, v in metrics.items()}, grads)


def _reduce_over_ranks(dp: DataParallel, grads, totals, losses, metrics, mses, stack):
    """The mean over ranks of the gradients, of each microbatch's total and
    losses and of its per-modality MSE (one all-reduce), each
    microbatch's PSNR from its mean MSE, and its min_grad_norm's MIN."""
    leaves = [(name, k) for name, group in grads.items() for k in group]
    scalars = [(("total",), stack(totals))] + [(("loss", k), stack(v)) for k, v in losses.items()] \
        + [(("mse", mod), stack(v)) for mod, v in mses.items()]
    out = dp.all_reduce_mean([grads[n][k] for n, k in leaves] + [v for _, v in scalars])
    grads = {name: dict(group) for name, group in grads.items()}
    for (name, k), g in zip(leaves, out):
        grads[name][k] = g
    reduced = dict(zip([key for key, _ in scalars], out[len(leaves):]))
    totals = list(reduced[("total",)])
    losses = {k: list(reduced[("loss", k)]) for k in losses}
    metrics = {f"psnr_{mod}": list(-10.0 * torch.log10(reduced[("mse", mod)].clamp_min(1e-12)))
               for mod in mses} | {k: list(dp.all_reduce_min(stack(v))) for k, v in metrics.items()}
    return grads, totals, losses, metrics


def make_train_step(config: TrainerConfig, model: MMSModel, cameras: Dict[str, Cameras],
                    dp: Optional[DataParallel] = None):
    """train_step(state, batch, generator=None) -> (state, aux): one
    guarded update on a pixel batch (the global batch, with `dp`);
    `generator` feeds the samplers' jitter (none: no jitter). Updates the
    model and `state` in place."""
    opt = make_optimizer(config)

    def train_step(state: TrainState, batch: Dict[str, PixelBatch],
                   generator: Optional[torch.Generator] = None):
        step = state.step
        total, losses, metrics, grads = batch_loss_and_grads(
            config, model, cameras, state.camera_poses, batch, step, make_schedules(config, step),
            generator, dp)
        metrics["grads_finite"] = guarded_update(opt, grads, train_params(model, state.camera_poses),
                                                 state)
        state.step = step + 1
        losses["total_loss"] = total
        return state, {"losses": losses, "metrics": metrics}

    return train_step


def make_train_steps(config: TrainerConfig, model: MMSModel, cameras: Dict[str, Cameras],
                     dp: Optional[DataParallel] = None):
    """train_steps(state, cache, generator, k, model_generator=None) ->
    (state, aux of the last step): k steps, each drawing its pixel batch on
    the device from the cache (train.py:352-405). `generator` draws the
    batches; the samplers' jitter comes from `model_generator`, or from
    `generator` too where it is None (one process). With `dp`, every rank
    seeds `generator` alike, so all draw the same global batch, and its
    own `model_generator`, so that the shards' jitter is not correlated."""
    step_fn = make_train_step(config, model, cameras, dp)

    def train_steps(state: TrainState, cache: DeviceDataCache, generator: torch.Generator, k: int,
                    model_generator: Optional[torch.Generator] = None):
        aux = None
        for _ in range(k):
            batch = sample_pixel_batch(cache, generator, config.datamanager.num_rays_per_modality,
                                       config.modalities)
            state, aux = step_fn(state, batch, model_generator or generator)
        return state, aux

    return train_steps


def make_eval_batch_step(config: TrainerConfig, model: MMSModel, cameras: Dict[str, Cameras]):
    """eval_step(state, batch) -> {"losses", "metrics"}: the losses and each
    modality's PSNR of one pixel batch rendered in eval mode, with no
    gradient (train.py:408-430)."""
    grid = config.model.surface.surface_field.field.grid

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, PixelBatch]):
        schedules = make_schedules(config, state.step)
        rays, segments = build_rays(config, state.camera_poses, cameras, batch)
        outputs = select_mosaick_channels(config, model(rays, segments, schedules, train=False),
                                          batch)
        targets = {mod: batch[mod].pixels for mod in config.modalities}
        losses, total = compute_losses(config.loss_manager, outputs, targets, state.step,
                                       config.max_num_iterations, grid, None, train=False)
        metrics = {f"psnr_{mod}": psnr(outputs[mod], targets[mod]) for mod in config.modalities}
        losses["total_loss"] = total
        return {"losses": losses, "metrics": metrics}

    return eval_step
