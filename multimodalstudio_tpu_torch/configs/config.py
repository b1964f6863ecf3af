"""Top-level configuration tree (JAX reference: configs/config.py): frozen
dataclass specs, the transforms that opt every MLP into bf16 compute and
into the fused chain kernel, `load_config` (a registered method with leaf
overrides from a YAML file or a dict), the slot-grid overrides from the
environment, the run directory and the config's printed form."""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, Optional, Tuple

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


def _apply_overrides(obj: Any, overrides: Dict[str, Any]) -> Any:
    """Recursively apply leaf overrides onto a frozen dataclass tree
    (config.py:161-187): dict values recurse into matching dataclass fields,
    a dict onto any other field becomes a tuple of pairs, a list becomes a
    tuple where the field holds one; leaves replace values."""
    if not dataclasses.is_dataclass(obj):
        return overrides
    updates = {}
    for key, value in overrides.items():
        if not hasattr(obj, key):
            raise KeyError(f"unknown config key: {key} on {type(obj).__name__}")
        current = getattr(obj, key)
        if isinstance(value, dict) and dataclasses.is_dataclass(current):
            updates[key] = _apply_overrides(current, value)
        elif isinstance(value, dict):
            updates[key] = tuple((k, tuple(v) if isinstance(v, list) else v)
                                 for k, v in value.items())
        elif isinstance(value, list):
            updates[key] = tuple(value) if isinstance(current, tuple) else value
        else:
            updates[key] = value
    return dataclasses.replace(obj, **updates)


def apply_env_grid_overrides(config: TrainerConfig, prefix: str = "BENCH_GRID_") -> TrainerConfig:
    """The slot grid's geometry from the environment (config.py:190-222):
    <prefix>FEATS (features per entry, 128 / (8 x FEATS) entries a row),
    ENTRIES (rows per level), DTYPE (the table's, bf16 or f32), LEVELS and
    MAXRES onto model.surface.surface_field.field.grid.encoding, every value
    an int but DTYPE's. With none set the config comes back as it was."""
    over = {k: os.environ[prefix + e] for k, e in (
        ("feats", "FEATS"), ("rows_per_level", "ENTRIES"), ("table_dtype", "DTYPE"),
        ("num_levels", "LEVELS"), ("max_res", "MAXRES")) if prefix + e in os.environ}
    if not over:
        return config
    over = {k: (v if k == "table_dtype" else int(v)) for k, v in over.items()}
    return _apply_overrides(config, {"model": {"surface": {"surface_field": {
        "field": {"grid": {"encoding": over}}}}}})


def load_config(conf_path: Optional[str] = None, method: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None) -> TrainerConfig:
    """A registered method's TrainerConfig with leaf overrides
    (config.py:225-251): a YAML file's `method` key selects the method
    (unless `method` is given) and its other keys override leaves, then
    `overrides` does. PyYAML is imported only when a path is given."""
    from multimodalstudio_tpu_torch.configs.methods import method_configs

    yaml_conf: Dict[str, Any] = {}
    if conf_path is not None:
        import yaml

        with open(conf_path) as f:
            yaml_conf = yaml.safe_load(f) or {}
    method = method or yaml_conf.pop("method", "grid")
    yaml_conf.pop("method", None)
    configs = method_configs()
    if method not in configs:
        raise KeyError(f"unknown method {method!r}; the registry has {sorted(configs)}")
    config = configs[method]
    if yaml_conf:
        config = _apply_overrides(config, yaml_conf)
    if overrides:
        config = _apply_overrides(config, overrides)
    return config


def make_output_dir(base: str, scene: str, method: str, conf_name: str,
                    version: Optional[str] = None) -> str:
    """<base>/<scene>/<method>/<conf_name>/<version>, made (config.py:254-262);
    the version defaults to the current time."""
    version = version or datetime.datetime.now().strftime("%Y-%m-%d_%H%M%S")
    path = os.path.join(base, scene, method, conf_name, version)
    os.makedirs(path, exist_ok=True)
    return path


def config_to_string(config: Any, indent: int = 0) -> str:
    """The config tree as a run's config.yaml prints it (config.py:265-274):
    a dataclass as its name and one indented line per field, any other
    value as its repr."""
    pad = "    " * indent
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        lines = [type(config).__name__ + ":"]
        for f in dataclasses.fields(config):
            lines.append(f"{pad}    {f.name}: {config_to_string(getattr(config, f.name), indent + 1)}")
        return "\n".join(lines)
    return repr(config)
