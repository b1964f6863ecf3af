"""grid_raw_tpu without its position encoding on a vertex-layout slot table,
the slice as a whole, against the JAX package: load_config's overrides,
the routes the model takes, and the losses and every gradient group of one
training batch (tests/test_torch_vertex_eval.py holds its eval forward and
sdf_gradients; the two files run in parallel).

The configuration comes through each package's own load_config with
model.surface.surface_field.use_position_encoding = False and the grid's
encoding {layout: vertex, feats: 16, table_dtype: f32, rows_per_level:
2048}, the table the repo's quality harness ran the vertex layout on
(configs/methods.py:356-359). The JAX fused slot kernels refuse the vertex
layout, so without the position encoding every query takes the lookup
(K6v in the port) and the K1 head or the K5 adjoint. It is cut to CPU size
by tests/test_torch_train.py's tiny() (hidden widths 128, 8+8 NeuS and 4
background samples with no stratified jitter, 3 modalities, 4 rays per
modality in 2 microbatches), then the grid to 3 levels of 64 rows (level
0 dense, levels 1-2 hashed), as tests/test_torch_slot_vertex.py holds the
lookup. The parameters and the batch (seed 5) come from
tests/test_torch_mlp_raw.py's carry() and batch_run(). JAX runs its Pallas
kernels in interpret mode (the vertex lookup's scalar copy loop, whose
compilation takes most of this file's time), the port the plain versions
of K1, K5 and K6v.

The lookup is exact f32 on both sides; the MLPs round to bf16 at the same
points and differ by f32 summation order. Tolerances as the no-PE cell
slice is held (tests/test_torch_slot_composition.py): losses and metrics
rel 1e-2, each gradient group within max(3e-2, twice the port's distance
to itself with its parameters moved by 1e-6, three draws). Measured (init
seed 0, batch seed 5; JAX against the port, its noise in brackets):
losses within rel 2.6e-3, metrics 1.9e-3; the table 4.9e-3 (3.6e-3), the
SDF head 5.3e-3 (3.1e-3), the variance 3.3e-3 (2.7e-3), the background
base MLP 3.7e-2 (5.9e-2), every other field group within 2.2e-2; the
poses 1.9e-2 (2.0e-2, polarization), 3.9e-2 (5.4e-2, mono) and 2.6e-1
(3.9e-1, rgb: a small sum of large cancelling terms, as on the cell
slices).
"""

import dataclasses

import pytest
import torch

import multimodalstudio_tpu.configs.config as jconfig
import multimodalstudio_tpu.models.samplers as jsamplers
import multimodalstudio_tpu.ops.pallas.slot_grid as jslot

import multimodalstudio_tpu_torch.configs.config as tconfig
import multimodalstudio_tpu_torch.models.model as tmodel
import multimodalstudio_tpu_torch.models.samplers as tsamplers
import multimodalstudio_tpu_torch.ops.kernels.slot_grid as tslot

from test_torch_mlp_raw import assert_gradients_match, batch_run, carry
from test_torch_slot_vertex import vertex_table
from test_torch_train import MODS, tiny

torch.set_num_threads(1)

VERTEX = {"model": {"surface": {"surface_field": {
    "use_position_encoding": False,
    "field": {"grid": {"encoding": {"layout": "vertex", "feats": 16, "table_dtype": "f32",
                                    "rows_per_level": 2048}}}}}}}
PLAINS = ("slot_lookup_vertex_plain", "slot_lookup_vertex_bwd_plain", "slot_lookup_plain",
          "slot_lookup_bwd_plain")


class _Registry:
    """tiny()'s `methods` argument: the loaded config as grid_raw_tpu."""

    def __init__(self, cfg):
        self.cfg = cfg

    def method_configs(self):
        return {"grid_raw_tpu": self.cfg}


def tiny_vertex(config_module, samplers, slot):
    """grid_raw_tpu through load_config with VERTEX, cut by tiny(), its grid
    then the loaded vertex encoding on 3 levels of 64 rows."""
    full = config_module.load_config(method="grid_raw_tpu", overrides=VERTEX)
    enc = dataclasses.replace(full.model.surface.surface_field.field.grid.encoding, num_levels=3,
                              min_res=4, max_res=16, rows_per_level=64)
    return vertex_table(tiny(_Registry(full), samplers, slot), enc)


JCFG = tiny_vertex(jconfig, jsamplers, jslot)
TCFG = tiny_vertex(tconfig, tsamplers, tslot)


def test_load_config_override_matches_jax():
    j = jconfig.load_config(method="grid_raw_tpu", overrides=VERTEX)
    t = tconfig.load_config(method="grid_raw_tpu", overrides=VERTEX)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    enc = t.model.surface.surface_field.field.grid.encoding
    assert (enc.layout, enc.feats, enc.table_dtype, enc.resolved_gather) == (
        "vertex", 16, "f32", "copy")
    # 6 levels of 2048 rows: level 0's 9^3 = 729 groups dense, levels 1-5 hashed
    assert list(enc.level_entries) == [729] + [2048] * 5 and enc.total_rows == 10976
    for cfg in (JCFG, TCFG):
        small = cfg.model.surface.surface_field.field.grid.encoding
        assert (small.layout, small.feats, small.table_dtype, small.num_levels) == (
            "vertex", 16, "f32", 3)
        assert not cfg.model.surface.surface_field.use_position_encoding


def test_model_takes_the_lookup_routes():
    """No fused slot kernel: the sampler and taps through the SDF field, the
    render samples through the composition; the full-width head takes
    xyz and 6 levels x F = 16."""
    model = tmodel.MMSModel(TCFG.model, device="cpu")
    assert not model._slot_value_ok() and model._fused_slot()
    full = tmodel.MMSModel(tconfig.load_config(method="grid_raw_tpu", overrides=VERTEX).model,
                           device="cpu")
    assert [tuple(l.kernel.shape) for l in full.surface_field.field.grid_mlp.mlp_head.layers()] == [
        (99, 128), (128, 128), (128, 257)]
    table = full.surface_field.field.grid_mlp.feature_grid.encoding.table
    assert tuple(table.shape) == (10976, 128) and table.dtype == torch.float32


@pytest.fixture(scope="module")
def carried():
    return carry(JCFG, TCFG)


@pytest.fixture(scope="module")
def slice_run(carried):
    """One batch (seed 5) through both packages and the port's moved runs,
    the port's lookup plain versions counted."""
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for name in PLAINS:
            real = getattr(tslot, name)
            mp.setattr(tslot, name, lambda *a, real=real, name=name, **k:
                       calls.append(name) or real(*a, **k))
        run = batch_run(carried, 5)
    return dict(run, calls=calls)


def test_slice_takes_the_vertex_plain_versions(slice_run):
    """Per microbatch, the lookup forward for each of the sampler's 2
    queries, the taps and the render samples, and the backward for the
    taps and the render samples; never the cell layout's; in the port's
    run and each of its three moved runs."""
    dm = TCFG.datamanager
    runs = 4 * (dm.num_rays_per_modality // dm.microbatch_rays)
    steps = TCFG.model.ray_sampler.num_upsample_steps
    assert sorted(slice_run["calls"]) == sorted(
        ["slot_lookup_vertex_plain"] * (steps + 2) * runs
        + ["slot_lookup_vertex_bwd_plain"] * 2 * runs)


def test_slice_losses_match_jax(slice_run):
    jtotal, jlo, jmet, _ = slice_run["j"]
    ttotal, tlo, tmet, _ = slice_run["t"]
    assert set(tlo) == set(jlo)
    assert {"eikonal_loss", "curvature_loss"} <= set(tlo)
    for k in jlo:
        ref = float(jlo[k])
        assert abs(float(tlo[k]) - ref) <= 1e-2 * abs(ref), k
    assert abs(float(ttotal) - float(jtotal)) <= 1e-2 * abs(float(jtotal))
    assert set(tmet) == set(jmet)
    for k in jmet:
        assert abs(float(tmet[k]) - float(jmet[k])) <= 1e-2 * abs(float(jmet[k])), k


def test_slice_gradients_match_jax(slice_run):
    """Each group within max(3e-2, twice the port's distance to itself with
    its parameters moved by 1e-6); the table gradient is f32 like the
    table."""
    groups = assert_gradients_match(slice_run["j"][3], slice_run["t"][3], slice_run["moved"], MODS)
    assert {"table", "variance", "surface_field.field.grid_mlp.mlp_head",
            "radiance_field.base_field.mlp", "heads.polarization.field",
            "background_field.base_field.mlp"} <= set(groups)
    table = [v for k, v in slice_run["t"][3]["fields"].items() if k.endswith("table")]
    assert len(table) == 1 and table[0].dtype == torch.float32
    assert float(table[0].abs().max()) > 0
