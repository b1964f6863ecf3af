"""grid_raw_tpu with an f32 slot table, the slice as a whole: the losses and
every gradient group of one tiny training batch through both packages'
loss-and-gradient functions, with the merged backward and (under
MMS_SLOT_BWD_SPLIT=1, each package reading the variable for its own calls)
the split backward, so that the curvature taps' K2f and the render
samples' K3f run forward and backward in both.

The configuration is tests/test_torch_train.py's tiny() grid_raw_tpu (its
3-level slot grid, hidden widths 128, 3 modalities, 4 rays per modality in
2 microbatches) with the grid's table f32 and F = 16 features per entry,
the table type and entry width of the committed capacity_base6 and
rehearsal_grid_dense checkpoints; the parameters and the batch (seed 5)
come from tests/test_torch_mlp_raw.py's carry() and batch_run(): the
port's init moved by numpy noise, carried to JAX through
convert.params_from_jax. JAX runs its Pallas kernels in interpret mode
(its f32 table through the bf16 hi+lo split), the port the plain versions
of K2f/K3f. Tolerances as the bf16 slice is held (tests/test_torch_train.py,
tests/test_torch_split_slice.py): losses rel 1e-2; each gradient group
within max(3e-2, twice the port's distance to itself with its parameters
moved by 1e-6, three draws). Measured, merged and split alike: losses
within rel 1.2e-3, metrics 6.5e-4; the table 1.5e-2 (its noise 6.6e-3), the
SDF head 1.0e-2 (3.6e-3), every field group within 2.7e-2; the poses 7.1e-3
to 6.9e-2 (rgb, against a noise of 6.0e-2). The f32 groups sit farther from
JAX than the bf16 slice's (table 9.8e-4): JAX's hi+lo split is about 2^-16
from the port's f32 read, and the port itself moved by 1.5 (the table
group) to 3e-2 when its table moved by a relative 2^-16 (three draws):
the importance sampler and SoftplusQuad's act'' edges turn such moves
into steps.
"""

import dataclasses

import pytest
import torch

import multimodalstudio_tpu.configs.methods as jmethods
import multimodalstudio_tpu.models.samplers as jsamplers
import multimodalstudio_tpu.ops.pallas.slot_grid as jslot

import multimodalstudio_tpu_torch.configs.methods as tmethods
import multimodalstudio_tpu_torch.models.samplers as tsamplers
import multimodalstudio_tpu_torch.ops.kernels.slot_fused as tsf
import multimodalstudio_tpu_torch.ops.kernels.slot_grid as tslot

from test_torch_mlp_raw import assert_gradients_match, batch_run, carry
from test_torch_train import MODS, tiny

torch.set_num_threads(1)

MERGED_PLAINS = ("slot_sdf_value_bwd_plain", "slot_sdf_chain_bwd_plain")
SPLIT_PLAINS = ("slot_sdf_value_bwd_split_plain", "slot_sdf_chain_bwd_split_plain")


def f32_table(cfg):
    """cfg with its slot grid's table f32 and 16 features per entry."""
    rp = dataclasses.replace
    m = cfg.model
    sf = m.surface.surface_field
    grid = rp(sf.field.grid, encoding=rp(sf.field.grid.encoding, feats=16, table_dtype="f32"))
    surface = rp(m.surface, surface_field=rp(sf, field=rp(sf.field, grid=grid)))
    return rp(cfg, model=rp(m, surface=surface))


JCFG = f32_table(tiny(jmethods, jsamplers, jslot))
TCFG = f32_table(tiny(tmethods, tsamplers, tslot))


@pytest.fixture(scope="module")
def carried():
    return carry(JCFG, TCFG)


@pytest.fixture(scope="module", params=[False, True], ids=["merged", "split"])
def f32_run(request, carried):
    """One batch (seed 5) through both packages, merged or split, and the
    port's moved runs, its backward plains counted with their table type."""
    split = request.param
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        if split:
            mp.setenv("MMS_SLOT_BWD_SPLIT", "1")
        else:
            mp.delenv("MMS_SLOT_BWD_SPLIT", raising=False)
        for name in SPLIT_PLAINS + MERGED_PLAINS:
            real = getattr(tsf, name)
            mp.setattr(tsf, name, lambda *a, real=real, name=name, **k:
                       calls.append((name, a[4].table_dtype)) or real(*a, **k))
        run = batch_run(carried, 5)
    return dict(run, calls=calls, split=split)


def test_f32_slice_config_is_the_checkpoints_grid():
    for cfg in (JCFG, TCFG):
        enc = cfg.model.surface.surface_field.field.grid.encoding
        assert (enc.layout, enc.feats, enc.table_dtype, enc.num_levels) == ("cell", 16, "f32", 3)


def test_f32_slice_takes_the_f32_backwards(f32_run):
    """Per microbatch one K2f backward (the curvature taps) and one K3f
    backward (the render samples), merged or split as the variable says,
    each with the f32 table, in the port's run and each of its three moved
    runs."""
    microbatches = TCFG.datamanager.num_rays_per_modality // TCFG.datamanager.microbatch_rays
    plains = SPLIT_PLAINS if f32_run["split"] else MERGED_PLAINS
    assert sorted(f32_run["calls"]) == sorted([(p, "f32") for p in plains] * microbatches * 4)


def test_f32_slice_losses_match_jax(f32_run):
    jtotal, jlo, jmet, _ = f32_run["j"]
    ttotal, tlo, tmet, _ = f32_run["t"]
    assert set(tlo) == set(jlo)
    assert {"eikonal_loss", "curvature_loss"} <= set(tlo)
    for k in jlo:
        ref = float(jlo[k])
        assert abs(float(tlo[k]) - ref) <= 1e-2 * abs(ref), k
    assert abs(float(ttotal) - float(jtotal)) <= 1e-2 * abs(float(jtotal))
    assert set(tmet) == set(jmet)
    for k in jmet:
        assert abs(float(tmet[k]) - float(jmet[k])) <= 1e-2 * abs(float(jmet[k])), k


def test_f32_slice_gradients_match_jax(f32_run):
    """Each group within max(3e-2, twice the port's distance to itself with
    its parameters moved by 1e-6); the table gradient is f32 like the
    table."""
    groups = assert_gradients_match(f32_run["j"][3], f32_run["t"][3], f32_run["moved"], MODS)
    assert {"table", "variance", "surface_field.field.grid_mlp.mlp_head",
            "radiance_field.base_field.mlp", "heads.polarization.field",
            "background_field.base_field.mlp"} <= set(groups)
    table = [v for k, v in f32_run["t"][3]["fields"].items() if k.endswith("table")]
    assert len(table) == 1 and table[0].dtype == torch.float32
    assert tuple(table[0].shape) == (TCFG.model.surface.surface_field.field.grid.encoding
                                     .total_rows, 128)
