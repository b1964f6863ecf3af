"""Trainer: the host loop owning training, evaluation and checkpoints
(JAX reference: engine/trainer.py).

`setup` builds the model, the train state, the samplers, the writer and
the evaluator, resumes from the newest checkpoint of the run (or
`config.load_dir`) and writes the run's config.yaml. `train` runs the
steps: with the device cache, each step draws its pixels on the card
(`make_train_steps`, one torch.Generator seeded from `config.seed`),
otherwise the host sampler feeds `make_train_step`. Between steps the host
logs, evaluates, exports and saves on the configured cadences, and aborts
on a non-finite loss naming the first bad step. Rays/s count the global
batch, num_rays_per_modality x modalities per step, over the step's wall
time.

Data parallel over processes (parallel/sharding.py; JAX trainer.py:84-107):
`n_devices` counts processes, 0 meaning the process group's world size (1
without a group). Over more than one, each rank trains a replica on its
own device (`rank_device`), every rank draws the same global batch and
runs its rows of each microbatch, and the gradients are averaged in one
all-reduce a step; the jitter comes from a generator of each rank's own.
Rank 0 alone writes the writer's output, config.yaml, checkpoints,
evaluations and exports; every rank restores the same checkpoint, and the
others wait at a barrier where rank 0 ends a run.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from multimodalstudio_tpu_torch.cameras.camera_optimizer import init_camera_poses
from multimodalstudio_tpu_torch.configs.config import TrainerConfig, config_to_string
from multimodalstudio_tpu_torch.data.dataset import MMSDataset
from multimodalstudio_tpu_torch.data.sampler import UniformPixelSampler
from multimodalstudio_tpu_torch.device import resolve_device, set_reference_precision
from multimodalstudio_tpu_torch.engine import checkpoints
from multimodalstudio_tpu_torch.engine.evaluator import Evaluator, RawEvaluator
from multimodalstudio_tpu_torch.engine.train import (
    init_train_state,
    make_eval_batch_step,
    make_train_step,
    make_train_steps,
)
from multimodalstudio_tpu_torch.models.model import MMSModel
from multimodalstudio_tpu_torch.parallel import sharding
from multimodalstudio_tpu_torch.utils.writer import (
    ITER_TRAIN_TIME,
    TEST_RAYS_PER_SEC,
    TRAIN_RAYS_PER_SEC,
    TimeWriter,
    Writer,
)


def check_step(step: int, cadence: int) -> bool:
    """Cadence test (trainer.py:43-45)."""
    return cadence > 0 and step % cadence == 0 and step > 0


def _floats(tree: Dict) -> Dict[str, float]:
    return {k: float(v) for k, v in tree.items()}


class Trainer:
    """Owns the training loop (trainer.py:48-410). `device` defaults to the
    card and raises without one."""

    def __init__(self, config: TrainerConfig, train_dataset: MMSDataset,
                 eval_dataset: MMSDataset, output_dir: Optional[str] = None, device="cuda"):
        world = sharding.world_size()
        n_dev = config.n_devices if config.n_devices > 0 else world
        if n_dev > 1 and n_dev != world:
            raise ValueError(f"n_devices={config.n_devices} but the process group has "
                             f"{world} processes (world size)")
        n_rays, micro = (config.datamanager.num_rays_per_modality,
                         config.datamanager.microbatch_rays)
        if n_dev > 1 and n_rays % n_dev:
            raise ValueError(f"num_rays_per_modality={n_rays} must divide n_devices={n_dev}")
        if n_dev > 1 and micro > 0 and micro % n_dev:
            raise ValueError(f"microbatch_rays={micro} must divide n_devices={n_dev}")
        self.dp = sharding.DataParallel.current() if n_dev > 1 else None
        self.is_main = sharding.is_main_process()
        self.device = sharding.rank_device(resolve_device(device))
        set_reference_precision()
        self.config = config
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.output_dir = output_dir
        self.step_start = 0
        self.loaded_from: Optional[str] = None
        self.last_aux = None  # the losses and metrics of the last step trained
        np.random.seed(config.seed)

    def setup(self):
        config, dev = self.config, self.device
        # the batches' draws (alike on every rank) and, with one process, the jitter
        self.generator = torch.Generator(device=dev).manual_seed(config.seed)
        self.model = MMSModel(config.model, device=dev).init(self.generator)
        self.cameras = {m: self.train_dataset.data[m].cameras for m in config.modalities}
        num_cameras = {m: self.train_dataset.num_frames(m) for m in config.modalities}
        poses = init_camera_poses(config.datamanager.camera_optimizer, config.modalities,
                                  num_cameras, device=dev)
        self.model_generator = None  # each rank's jitter
        if self.dp is not None:
            sharding.replicate(list(self.model.parameters()) + list(poses.values()))
            self.model_generator = torch.Generator(device=dev).manual_seed(
                (config.seed + 1) * 1000 + self.dp.rank)
        self.state = init_train_state(config, self.model, poses)
        self.sampler = UniformPixelSampler(self.train_dataset,
                                           config.datamanager.num_rays_per_modality,
                                           seed=config.seed)
        self.eval_sampler = UniformPixelSampler(
            self.eval_dataset, config.datamanager.num_rays_per_modality, seed=config.seed + 1
        ) if self._has_eval() else None

        self.train_step = self.train_steps = self.cache = None
        self.steps_per_call = 1
        if config.datamanager.device_cache:
            from multimodalstudio_tpu_torch.data.device_cache import build_device_cache

            self.steps_per_call = self._fused_chunk()
            self.cache = build_device_cache(self.train_dataset, config.datamanager.quantize_cache,
                                            device=dev)
            self.train_steps = make_train_steps(config, self.model, self.cameras, self.dp)
        else:
            self.train_step = make_train_step(config, self.model, self.cameras, self.dp)
        self.eval_step = make_eval_batch_step(config, self.model, self.cameras)

        evaluator_cls = RawEvaluator if config.datamanager.raw else Evaluator
        self.evaluator = evaluator_cls(config, self.model, self.train_dataset, self.eval_dataset,
                                       self.output_dir if self.is_main else None, device=dev)
        self.writer = Writer(
            log_dir=self.output_dir,
            use_tensorboard=(config.logging.vis == "tensorboard" and bool(self.output_dir)
                             and self.is_main),
            use_wandb=config.logging.vis == "wandb" and self.output_dir is not None and self.is_main,
            use_local=config.logging.local_writer and self.is_main,
            max_buffer_size=config.logging.max_buffer_size,
        )

        # resume from the newest checkpoint of the run dir (trainer.py:154-160)
        if self.output_dir is not None:
            load_dir = config.load_dir or self._ckpt_dir()
            self.state, self.step_start = checkpoints.load_checkpoint(
                load_dir, self.model, self.state, config.load_step)
            if self.step_start:
                self.loaded_from = checkpoints.checkpoint_path(load_dir, self.step_start - 1)
            if self.is_main:
                with open(os.path.join(self.output_dir, "config.yaml"), "w") as f:
                    f.write(config_to_string(config))

        self.trace_profiler = None
        if config.logging.enable_profiler and self.output_dir and self.is_main:
            from multimodalstudio_tpu_torch.utils.profiler import TorchTraceProfiler

            self.trace_profiler = TorchTraceProfiler(self.output_dir, config.logging.profiler_steps)

    def _has_eval(self) -> bool:
        return all(self.eval_dataset.num_frames(m) > 0 for m in self.config.modalities)

    def _ckpt_dir(self) -> str:
        return os.path.join(self.output_dir, "checkpoints")

    def _fused_chunk(self) -> int:
        """Steps between host syncs: the gcd of every active host cadence,
        at most 100 (trainer.py:205-228)."""
        config = self.config
        cadences = [c for c in (
            config.logging.steps_per_log, config.logging.steps_per_flush_buffer,
            config.steps_per_eval_batch, config.steps_per_eval_image,
            config.steps_per_eval_all_images, config.steps_per_save,
            config.steps_per_export_mesh if config.evaluator.export_mesh else 0,
            config.steps_per_export_poses if config.evaluator.export_poses else 0,
            config.max_num_iterations,
        ) if c and c > 0]
        k = cadences[0]
        for c in cadences[1:]:
            k = math.gcd(k, c)
        return max(min(k, 100), 1)

    def _save(self):
        if self.is_main:
            checkpoints.save_checkpoint(self._ckpt_dir(), self.model, self.state,
                                        self.config.save_only_latest_checkpoint)

    # ------------------------------------------------------------------ train
    def train(self):
        if self.state.opt_state is None:
            raise ValueError(
                f"{self.loaded_from} is a weights file (no optimizer state): it can be evaluated "
                "but not trained from; convert the checkpoint with --with-opt-state")
        if self.train_steps is not None:
            self._train_cached()
        else:
            self._train_per_step()
        if self.output_dir:
            self._save()
        self.writer.flush(self.config.max_num_iterations, self.config.max_num_iterations)
        sharding.barrier()

    def _train_cached(self):
        """Device-cached loop: chunks of steps_per_call steps, each step
        drawing its batch on the card, host work on chunk boundaries."""
        config = self.config
        k = self.steps_per_call
        n_rays_step = config.datamanager.num_rays_per_modality * len(config.modalities)
        start = self.step_start
        prev_auxes: list = []
        while start < config.max_num_iterations:
            kc = min(k - start % k, config.max_num_iterations - start)
            step = start + kc - 1
            auxes = []
            with TimeWriter(self.writer, ITER_TRAIN_TIME, step, block=self.device) as t:
                for _ in range(kc):
                    self.state, aux = self.train_steps(self.state, self.cache, self.generator, 1,
                                                       self.model_generator)
                    auxes.append(aux)
            self.writer.buffer.times[ITER_TRAIN_TIME][-1] = t.duration / kc
            self.writer.put_time(TRAIN_RAYS_PER_SEC, kc * n_rays_step / t.duration, step)
            # the chunk's steps (and the previous chunk's), for the abort's
            # first non-finite step (trainer.py:264-271)
            self._aux_window = list(zip(range(start - len(prev_auxes), start + kc),
                                        prev_auxes + auxes))
            self.last_aux = aux
            self._host_cadences(step + 1, aux)
            prev_auxes = auxes
            start += kc

    def _train_per_step(self):
        config = self.config
        n_rays_step = config.datamanager.num_rays_per_modality * len(config.modalities)
        for step in range(self.step_start, config.max_num_iterations):
            if self.trace_profiler:
                self.trace_profiler.maybe_start(step)
            batch = self.sampler.sample()
            with TimeWriter(self.writer, ITER_TRAIN_TIME, step, block=self.device) as t:
                self.state, aux = self.train_step(self.state, batch,
                                                  self.model_generator or self.generator)
            self.writer.put_time(TRAIN_RAYS_PER_SEC, n_rays_step / t.duration, step)
            if self.trace_profiler:
                self.trace_profiler.maybe_stop(step)
            self.last_aux = aux
            self._host_cadences(step + 1, aux)

    def _host_cadences(self, step: int, aux):
        config = self.config
        if check_step(step, config.logging.steps_per_log):
            losses = _floats(aux["losses"])
            self.writer.put_dict(losses, step, prefix="losses/")
            self.writer.put_dict(_floats(aux["metrics"]), step, prefix="metrics/")
            total = losses.get("total_loss", 0.0)
            if not math.isfinite(total):
                # abort rather than train on NaN; the newest checkpoint
                # predates the divergence (trainer.py:298-333)
                first_step, first_aux = step - 1, aux
                for s, a in getattr(self, "_aux_window", []):
                    if not math.isfinite(float(a["losses"]["total_loss"])):
                        first_step, first_aux = s, a
                        break
                comps = "  ".join(f"{k}={v:.6g}" for k, v in sorted(_floats(first_aux["losses"]).items()))
                mets = "  ".join(f"{k}={v:.6g}" for k, v in sorted(_floats(first_aux["metrics"]).items()))
                raise FloatingPointError(
                    f"total_loss is {total} at step {step} — aborting the run (last checkpoint "
                    f"is the newest saved step)\n  first non-finite step: {first_step}\n"
                    f"  losses: {comps}\n  metrics: {mets}")
        if self.is_main:
            self.eval_cadences(step)
        if self.output_dir and check_step(step, config.steps_per_save):
            self._save()
        if check_step(step, config.logging.steps_per_flush_buffer):
            self.writer.flush(step, config.max_num_iterations)

    # ------------------------------------------------------------------- eval
    def eval_cadences(self, step: int):
        """Cadenced eval work (trainer.py:336-390)."""
        config = self.config
        if self.eval_sampler and check_step(step, config.steps_per_eval_batch):
            aux = self.eval_step(self.state, self.eval_sampler.sample())
            self.writer.put_dict(_floats(aux["metrics"]), step, prefix="eval/")
        if self._has_eval() and check_step(step, config.steps_per_eval_image):
            # one eval view per modality; the test-rays rate over all of them
            n_rays = 0
            t0 = time.perf_counter()
            for mod in config.modalities:
                frames = self.evaluator.render_single_view(self.state, mod, 0)
                n_rays += frames[mod].shape[0] * frames[mod].shape[1]
                self.writer.put_dict(self.evaluator.view_metrics(frames, mod), step,
                                     prefix=f"eval_image/{mod}/")
                self.writer.put_image(f"eval_image/{mod}", np.clip(frames[mod][..., :3], 0, 1), step)
                if self.output_dir:
                    self.evaluator.export_view(frames, mod, 0, step)
            self.writer.put_time(TEST_RAYS_PER_SEC, n_rays / (time.perf_counter() - t0), step)
        if self._has_eval() and check_step(step, config.steps_per_eval_all_images):
            for mod, vals in self.evaluator.render_all_eval_views(self.state).items():
                self.writer.put_dict(vals, step, prefix=f"eval_all/{mod}/")
        if config.evaluator.export_mesh and check_step(step, config.steps_per_export_mesh):
            self.evaluator.export_mesh(self.state, step)
        if config.evaluator.export_poses and check_step(step, config.steps_per_export_poses):
            self.evaluator.export_poses(self.state, step)

    def eval(self, view_ids=None):
        """Full evaluation (trainer.py:392-410): every eval view, or the
        given (train or eval) view ids; then the mesh and poses when the
        config exports them. Rank 0's work: the other ranks wait for it and
        return {}."""
        if not self.is_main:
            sharding.barrier()
            return {}
        if view_ids:
            self.evaluator.render_specific_views(self.state, view_ids)
            results = {}
        else:
            results = self.evaluator.render_all_eval_views(self.state)
        if self.config.evaluator.export_mesh:
            self.evaluator.export_mesh(self.state, int(self.state.step))
        if self.config.evaluator.export_poses:
            self.evaluator.export_poses(self.state, int(self.state.step))
        sharding.barrier()
        return results
