"""Top-level configuration tree (JAX reference: configs/config.py): frozen
dataclass specs, with the transforms that opt every MLP into bf16 compute
and into the fused chain kernel."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from multimodalstudio_tpu_torch.cameras.camera_optimizer import CameraOptimizerSpec
from multimodalstudio_tpu_torch.engine.losses import LossManagerSpec
from multimodalstudio_tpu_torch.engine.schedules import MultiStepWarmupSpec
from multimodalstudio_tpu_torch.fields.mlp import MLPSpec
from multimodalstudio_tpu_torch.models.model import ModelSpec


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    optimizer: str = "adamw"  # adam | adamw | radam
    lr: float = 1e-3
    weight_decay: float = 0.01
    eps: float = 1e-15
    betas: Tuple[float, float] = (0.9, 0.999)
    scheduler: Optional[MultiStepWarmupSpec] = MultiStepWarmupSpec()
    max_norm: float = 2.0


@dataclasses.dataclass(frozen=True)
class DataManagerSpec:
    dataset_kind: str = "aligned"  # aligned | unaligned
    raw: bool = False
    num_rays_per_modality: int = 2048
    device_cache: bool = True
    quantize_cache: bool = True
    microbatch_rays: int = 0  # rays per modality per accumulation slice (0 = whole batch)
    eval_image_indices: Tuple[int, ...] = (9, 19, 29, 39, 49)
    eval_indices_per_modality: Optional[Tuple[Tuple[str, Tuple[int, ...]], ...]] = None
    skip_indices_per_modality: Optional[Tuple[Tuple[str, Tuple[int, ...]], ...]] = None
    eval_ratio: float = 0.0
    camera_optimizer: CameraOptimizerSpec = CameraOptimizerSpec()


@dataclasses.dataclass(frozen=True)
class EvaluatorSpec:
    eval_num_rays_per_chunk: int = 1024
    rendering_scale: float = 0.25
    roi_only: bool = True
    accumulation_mask_threshold: float = 0.9
    export_mesh: bool = False
    export_poses: bool = False
    mesh_resolution: int = 256
    marching_cube_threshold: float = 0.0
    gt_scale: bool = False


@dataclasses.dataclass(frozen=True)
class LoggingSpec:
    steps_per_log: int = 100
    steps_per_flush_buffer: int = 100
    max_buffer_size: int = 20
    local_writer: bool = True
    enable_profiler: bool = False
    profiler_steps: Tuple[int, ...] = (12, 17)
    vis: str = "tensorboard"  # tensorboard | wandb | none


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    method_name: str = "grid"
    max_num_iterations: int = 100000
    steps_per_eval_batch: int = 100
    steps_per_eval_image: int = 1000
    steps_per_eval_all_images: int = 25000
    steps_per_export_mesh: int = 5000
    steps_per_export_poses: int = 5000
    steps_per_save: int = 5000
    save_only_latest_checkpoint: bool = True
    mixed_precision: bool = False
    matmul_precision: str = "high"  # highest | high | default
    seed: int = 654824
    n_devices: int = 0

    modalities: Tuple[str, ...] = ("rgb",)
    datamanager: DataManagerSpec = DataManagerSpec()
    model: ModelSpec = ModelSpec()
    loss_manager: LossManagerSpec = LossManagerSpec()
    optimizers: Tuple[Tuple[str, OptimizerSpec], ...] = (
        ("fields", OptimizerSpec(lr=1e-3)),
        ("camera_poses", OptimizerSpec(lr=1e-4)),
    )
    evaluator: EvaluatorSpec = EvaluatorSpec()
    logging: LoggingSpec = LoggingSpec()

    load_dir: Optional[str] = None
    load_step: Optional[int] = None

    def optimizer_spec(self, group: str) -> OptimizerSpec:
        for name, spec in self.optimizers:
            if name == group:
                return spec
        return OptimizerSpec()


def _replace_mlps(obj, **changes):
    """Copy of a spec tree with `changes` applied to every MLPSpec in it."""
    if isinstance(obj, MLPSpec):
        return dataclasses.replace(obj, **changes)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(
            obj, **{f.name: _replace_mlps(getattr(obj, f.name), **changes)
                    for f in dataclasses.fields(obj)}
        )
    if isinstance(obj, tuple):
        return tuple(_replace_mlps(v, **changes) for v in obj)
    return obj


def apply_mixed_precision(config: TrainerConfig) -> TrainerConfig:
    """Every MLP computes in bfloat16; parameters and reductions stay f32."""
    return _replace_mlps(config, dtype="bfloat16")


def apply_fused_mlp(config: TrainerConfig) -> TrainerConfig:
    """Every eligible MLP runs as the fused chain kernel (fields/mlp.py::can_fuse)."""
    return _replace_mlps(config, fused=True)
