"""The port's method registry equals the JAX package's, leaf by leaf."""

import dataclasses
import os

import numpy as np
import pytest

import multimodalstudio_tpu.configs.config as jconfig
import multimodalstudio_tpu.configs.methods as jmethods
import multimodalstudio_tpu_torch.configs.config as tconfig
import multimodalstudio_tpu_torch.configs.methods as tmethods

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


REFERENCE_METHODS = ("grid", "mlp", "grid_raw", "mlp_raw", "grid_unbalanced",
                     "grid_raw_unbalanced", "grid_decimated", "grid_raw_grid_bg_unbalanced")


def test_port_registers_the_methods_it_runs():
    assert set(tmethods.method_configs()) == set(REFERENCE_METHODS) | {"grid_raw_tpu",
                                                                        "mlp_raw_tpu"}
    assert list(tmethods.method_configs()) == list(jmethods.method_configs())


@pytest.mark.parametrize("method", REFERENCE_METHODS)
def test_reference_method_equals_reference_leaf_by_leaf(method):
    j = jmethods.method_configs()[method]
    t = tmethods.method_configs()[method]
    assert t.method_name == method
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("conf", ["grid", "grid_raw", "mlp_raw"])
def test_load_config_of_the_reference_yaml_equals_jax(conf):
    """The committed confs/*.yaml of the reference methods through each
    package's load_config: hash grids at max_res 1024, the SDF MLP's
    geometric_init_bias 0.4, float32 with TF32 off (matmul_precision
    "high")."""
    path = os.path.join(REPO, "confs", f"{conf}.yaml")
    j = jconfig.load_config(path)
    t = tconfig.load_config(path)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.method_name == conf and t.matmul_precision == "high" and not t.mixed_precision
    assert t.model.surface.surface_field.field.mlp.geometric_init_bias == 0.4


def test_grid_raw_tpu_equals_reference_leaf_by_leaf():
    j = jmethods.method_configs()["grid_raw_tpu"]
    t = tmethods.method_configs()["grid_raw_tpu"]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_mlp_raw_tpu_equals_reference_leaf_by_leaf():
    j = jmethods.method_configs()["mlp_raw_tpu"]
    t = tmethods.method_configs()["mlp_raw_tpu"]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_mlp_base_config_equals_reference():
    # the 8x256 MLP base that mlp_raw_tpu is derived from
    assert dataclasses.asdict(tmethods._mlp_config()) == dataclasses.asdict(jmethods._mlp_config())


def test_grid_base_config_equals_reference():
    # the hash-grid base that grid_raw_tpu is derived from
    assert dataclasses.asdict(tmethods._grid_config()) == dataclasses.asdict(jmethods._grid_config())


def test_flagship_slot_grid_geometry_matches():
    j = jmethods.method_configs()["grid_raw_tpu"].model.surface.surface_field.field.grid.encoding
    t = tmethods.method_configs()["grid_raw_tpu"].model.surface.surface_field.field.grid.encoding
    for name in ("resolutions", "level_entries", "level_rows", "level_offsets"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    for name in ("total_rows", "entries_per_row", "out_dim", "growth_factor", "resolved_gather"):
        assert getattr(t, name) == getattr(j, name), name


@pytest.mark.parametrize("method", list(jmethods.method_configs()))
def test_launcher_and_trainer_take_every_method(method):
    """launcher.build_datasets and Trainer.setup on the CPU at full width for
    every registered method: raw methods get mosaicked frames and
    RawEvaluator, the others demosaicked frames and Evaluator."""
    from multimodalstudio_tpu_torch import launcher
    from multimodalstudio_tpu_torch.engine.evaluator import Evaluator, RawEvaluator
    from multimodalstudio_tpu_torch.engine.trainer import Trainer

    cfg = tmethods.method_configs()[method]
    train, evald = launcher.build_datasets(cfg, "synthetic:views=5,size=4", device="cpu")
    cfg = launcher.resolve_model_channels(cfg, train)
    assert train.num_frames("rgb") == 4 and evald.num_frames("rgb") == 1
    trainer = Trainer(cfg, train, evald, device="cpu")
    trainer.setup()
    assert type(trainer.evaluator) is (RawEvaluator if cfg.datamanager.raw else Evaluator)
    assert trainer.state.opt_state.count == 0 and trainer.model.device.type == "cpu"
