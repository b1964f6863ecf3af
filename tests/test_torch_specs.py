"""The port's method registry equals the JAX package's, leaf by leaf."""

import dataclasses

import numpy as np

import multimodalstudio_tpu.configs.methods as jmethods
import multimodalstudio_tpu_torch.configs.methods as tmethods

import torch

torch.set_num_threads(1)


def test_port_registers_the_methods_it_runs():
    assert set(tmethods.method_configs()) == {"grid_raw_tpu", "mlp_raw_tpu"}


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
