"""Method registry (JAX reference: configs/methods.py). The port registers
the methods it can run: the flagship `grid_raw_tpu` and `mlp_raw_tpu`."""

from __future__ import annotations

import dataclasses
from typing import Dict

from multimodalstudio_tpu_torch.cameras.camera_optimizer import CameraOptimizerSpec
from multimodalstudio_tpu_torch.configs.config import (
    DataManagerSpec,
    EvaluatorSpec,
    OptimizerSpec,
    TrainerConfig,
    apply_fused_mlp,
    apply_mixed_precision,
)
from multimodalstudio_tpu_torch.engine.losses import (
    GeometryLossSpec,
    LossManagerSpec,
    RadianceLossSpec,
)
from multimodalstudio_tpu_torch.engine.schedules import CurvatureWarmupSpec, MultiStepWarmupSpec
from multimodalstudio_tpu_torch.fields.components import FeatureGridSpec
from multimodalstudio_tpu_torch.fields.fields import (
    FieldComponentSpec,
    NeRFEncodingSpec,
    NeRFFieldSpec,
    RadianceFieldSpec,
    SDFFieldSpec,
)
from multimodalstudio_tpu_torch.fields.mlp import MLPSpec
from multimodalstudio_tpu_torch.models.model import (
    BackgroundModelSpec,
    HeadSpec,
    ModelSpec,
    RadianceModelSpec,
    SurfaceModelSpec,
)
from multimodalstudio_tpu_torch.models.samplers import NeuSSamplerSpec, SpacedSamplerSpec
from multimodalstudio_tpu_torch.ops.encodings import HashGridSpec
from multimodalstudio_tpu_torch.ops.kernels.slot_grid import SlotGridSpec

FIVE_MODALITIES = ("rgb", "infrared", "mono", "polarization", "multispectral")

MODALITY_CHANNELS = {"rgb": 3, "infrared": 1, "mono": 1, "polarization": 4, "multispectral": 9}


def _standard_heads():
    """3x64 sigmoid heads; polarization has a 3x256 linear Stokes head."""
    head = HeadSpec(
        mlp=MLPSpec(num_layers=3, hidden_dim=64, out_activation="Sigmoid", weight_norm=True)
    )
    pol = HeadSpec(
        mlp=MLPSpec(num_layers=3, hidden_dim=256, out_activation="None", weight_norm=True),
        polarization=True,
    )
    return (("rgb", head), ("infrared", head), ("mono", head), ("polarization", pol),
            ("multispectral", head))


def _grid_field(max_res: int = 1024, radius: float = 1.0) -> FeatureGridSpec:
    return FeatureGridSpec(encoding=HashGridSpec(max_res=max_res), coarse_to_fine=True,
                           radius=radius)


def _grid_config(modalities=FIVE_MODALITIES) -> TrainerConfig:
    """`grid`: hash-grid surface and radiance fields (the base of grid_raw_tpu)."""
    surface = SurfaceModelSpec(
        surface_field=SDFFieldSpec(
            field=FieldComponentSpec(
                mlp=MLPSpec(num_layers=3, hidden_dim=128, activation="Softplus",
                            activation_beta=100.0, out_activation="None",
                            geometric_init=True, weight_norm=True),
                grid=_grid_field(),
            ),
            use_position_encoding=True,
            position_encoding=NeRFEncodingSpec(6, 0.0, 5.0, True),
        ),
        use_numerical_gradients=True,
        numerical_gradient_taps=4,
        compute_hessian=True,
    )
    radiance = RadianceModelSpec(
        radiance_field=RadianceFieldSpec(
            base_field=FieldComponentSpec(
                mlp=MLPSpec(num_layers=3, hidden_dim=256, out_activation="ReLU", weight_norm=True),
                grid=_grid_field(),
            )
        ),
        use_direction_encoding=True,
        sh_degree=4,
        use_reflection_direction=True,
        use_n_dot_v=True,
        radiance_feature_dim=256,
    )
    background = BackgroundModelSpec(
        field=NeRFFieldSpec(
            base_field=FieldComponentSpec(
                mlp=MLPSpec(num_layers=4, hidden_dim=256, activation="ReLU",
                            out_activation="ReLU", weight_norm=True)
            ),
            base_output_dim=256,
            head_field=MLPSpec(num_layers=4, hidden_dim=128, out_activation="ReLU"),
            use_position_encoding=True,
            position_encoding=NeRFEncodingSpec(6, 0.0, 5.0, True),
            use_direction_encoding=True,
            direction_encoding=NeRFEncodingSpec(4, 0.0, 3.0, True),
        ),
        radiance_feature_dim=128,
        contraction_order=float("inf"),
    )
    model = ModelSpec(
        modalities=tuple((m, MODALITY_CHANNELS[m]) for m in modalities),
        heads=_standard_heads(),
        ray_sampler=NeuSSamplerSpec(num_samples=32, num_samples_importance=32),
        background_ray_sampler=SpacedSamplerSpec(num_samples=16, spacing="lin_disparity"),
        surface=surface,
        radiance=radiance,
        background=background,
        use_background=True,
    )
    losses = LossManagerSpec(
        radiance_losses=(
            ("rgb", RadianceLossSpec()),
            ("mono", RadianceLossSpec()),
            ("multispectral", RadianceLossSpec()),
            ("infrared", RadianceLossSpec()),
            ("polarization", RadianceLossSpec(saturation_threshold=0.9980)),
        ),
        geometry=GeometryLossSpec(
            eikonal_loss="MSE", eikonal_weight=0.1, curvature_loss="L1",
            curvature_weight=5e-4, curvature_scheduler=CurvatureWarmupSpec(warm_up_ratio=0.1),
        ),
    )
    scheduler = MultiStepWarmupSpec(0.1, (0.5, 0.75, 0.9), 0.4)
    return TrainerConfig(
        method_name="grid",
        max_num_iterations=100000,
        steps_per_eval_batch=100,
        steps_per_eval_image=1000,
        steps_per_eval_all_images=25000,
        steps_per_export_mesh=5000,
        steps_per_export_poses=5000,
        steps_per_save=5000,
        mixed_precision=False,
        matmul_precision="high",
        modalities=tuple(modalities),
        datamanager=DataManagerSpec(
            dataset_kind="aligned", raw=False, num_rays_per_modality=2048,
            camera_optimizer=CameraOptimizerSpec(mode="SO3xR3", shared_optimization=True),
        ),
        model=model,
        loss_manager=losses,
        optimizers=(
            ("fields", OptimizerSpec(optimizer="adamw", lr=1e-3, weight_decay=0.01, eps=1e-15,
                                     scheduler=scheduler)),
            ("camera_poses", OptimizerSpec(optimizer="adamw", lr=1e-4, weight_decay=0.01,
                                           eps=1e-15, scheduler=scheduler)),
        ),
        evaluator=EvaluatorSpec(eval_num_rays_per_chunk=1024, rendering_scale=0.25),
    )


def _mlp_config() -> TrainerConfig:
    """`mlp`: 8x256 MLP fields with a skip at layer 4, autograd SDF
    gradients, no curvature loss (the base of mlp_raw_tpu)."""
    base = _grid_config()
    surface = SurfaceModelSpec(
        surface_field=SDFFieldSpec(
            field=FieldComponentSpec(
                mlp=MLPSpec(num_layers=8, hidden_dim=256, activation="Softplus",
                            activation_beta=100.0, out_activation="None", skip_connections=(4,),
                            geometric_init=True, weight_norm=True),
                grid=None,
            ),
            use_position_encoding=True,
            position_encoding=NeRFEncodingSpec(6, 0.0, 5.0, True),
        ),
        use_numerical_gradients=False,
        compute_hessian=False,
    )
    radiance = dataclasses.replace(
        base.model.radiance,
        radiance_field=RadianceFieldSpec(
            base_field=FieldComponentSpec(
                mlp=MLPSpec(num_layers=8, hidden_dim=256, activation="ReLU", out_activation="ReLU",
                            skip_connections=(4,), weight_norm=True),
                grid=None,
            )
        ),
    )
    model = dataclasses.replace(base.model, surface=surface, radiance=radiance)
    losses = dataclasses.replace(
        base.loss_manager,
        geometry=GeometryLossSpec(eikonal_loss="MSE", eikonal_weight=0.1, curvature_loss=None),
    )
    return dataclasses.replace(base, method_name="mlp", model=model, loss_manager=losses)


def _raw(config: TrainerConfig, name: str) -> TrainerConfig:
    """Raw (mosaicked) variant."""
    return dataclasses.replace(
        config, method_name=name, datamanager=dataclasses.replace(config.datamanager, raw=True)
    )


def _grid_raw_tpu() -> TrainerConfig:
    """The flagship: grid_raw with a packed bf16 slot-hash grid (6 levels,
    4096 entries per level, F=2), analytic SDF gradients through the fused
    slot kernel, 4-level sampler queries, SoftplusQuad SDF activation, the
    radiance trunk on the geometric features (no grid of its own), bf16
    MLPs and every eligible MLP as a fused chain."""
    dc = dataclasses
    base = _raw(_grid_config(), "grid_raw_tpu")
    sf = base.model.surface.surface_field
    grid = dc.replace(
        sf.field.grid,
        encoding=SlotGridSpec(num_levels=6, min_res=16, max_res=512, rows_per_level=4096,
                              layout="cell", feats=2, table_dtype="bf16"),
    )
    surface = dc.replace(
        base.model.surface,
        use_numerical_gradients=False,
        compute_hessian=True,
        curvature_tap_stride=4,
        curvature_taps=2,
        sampler_levels=4,
        surface_field=dc.replace(
            sf, field=dc.replace(sf.field, grid=grid,
                                 mlp=dc.replace(sf.field.mlp, activation="SoftplusQuad")),
        ),
    )
    rf = base.model.radiance.radiance_field
    radiance = dc.replace(
        base.model.radiance,
        radiance_field=dc.replace(rf, base_field=dc.replace(rf.base_field, grid=None)),
    )
    model = dc.replace(base.model, surface=surface, radiance=radiance, remat=False)
    cfg = dc.replace(
        base, model=model, mixed_precision=True, matmul_precision="default",
        datamanager=dc.replace(base.datamanager, microbatch_rays=512),
    )
    return apply_fused_mlp(apply_mixed_precision(cfg))


def _mlp_raw_tpu() -> TrainerConfig:
    """mlp_raw with bf16 MLPs, 512-ray microbatches, the SoftplusQuad SDF
    activation and every eligible MLP as a fused chain: the SDF surface
    through K4 (sdf, geo and d sdf/dx), its sampler queries and the other
    MLPs through K1."""
    dc = dataclasses
    base = _raw(_mlp_config(), "mlp_raw_tpu")
    sf = base.model.surface.surface_field
    surface = dc.replace(
        base.model.surface,
        surface_field=dc.replace(
            sf, field=dc.replace(sf.field, mlp=dc.replace(sf.field.mlp, activation="SoftplusQuad"))),
    )
    cfg = dc.replace(
        base, model=dc.replace(base.model, surface=surface, remat=False), mixed_precision=True,
        matmul_precision="default", datamanager=dc.replace(base.datamanager, microbatch_rays=512),
    )
    return apply_fused_mlp(apply_mixed_precision(cfg))


def method_configs() -> Dict[str, TrainerConfig]:
    return {"grid_raw_tpu": _grid_raw_tpu(), "mlp_raw_tpu": _mlp_raw_tpu()}
