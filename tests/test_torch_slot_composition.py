"""The port's slot-grid surface without a position encoding against the JAX
package: load_config's overrides, the eval forward, the two-kernel
composition of sdf_gradients, and the losses and every gradient group of a
training batch.

The configuration is grid_raw_tpu with one leaf overridden through each
package's own load_config: model.surface.surface_field.use_position_encoding
= False. The SDF head then takes [xyz, grid features]; its sampler and tap
queries run the SDF field (the slot-grid lookup K6, then the K1 head) and
its render samples the composition K6 (with tangents) -> K5
(fused_chain_adjoint) -> d sdf/dx = <adj, tangents> outside the kernels.
It is cut to CPU size by tests/test_torch_train.py's tiny() (a 3-level slot
grid, hidden widths 128, 8+8 NeuS and 4 background samples with no
stratified jitter, 3 modalities, 4 rays per modality in 2 microbatches).
The port initialises the parameters, that file's noise moves them (and
scales the table up), and both packages take the result, the port through
convert.params_from_jax. JAX runs its Pallas kernels in interpret mode,
the port the plain versions of K1, K5 and K6.

Both round to bf16 at the same points and differ by f32 summation order,
which now and then flips the bf16 rounding of an activation. Tolerances,
as tests/test_torch_train.py holds grid_raw_tpu: eval outputs and the SDF
route rel-L2 <= 1e-2, losses and metrics rel 1e-2. Measured (init seed 0,
batch seed 5): eval outputs within 1.7e-3, the SDF route within 8.7e-8,
losses within rel 1.1e-3, metrics 3.0e-3.

Some gradient groups of this batch jump when a single bf16 rounding flips:
the port against itself (init 1, batch 7) with its background field's
parameters moved by 1e-8 (relative) agrees to 1e-8, moved by 1e-7 it
differs by 2.4e-2 on the polarization poses, and more rays per modality
(16 to 256) do not bring that down. So each group
is held to max(3e-2, 2 * noise), noise being the port's distance to itself
with its parameters moved by 1e-6 in three draws, computed in the test
(tests/test_torch_mlp_raw.py's assert_gradients_match).
Readings, JAX against the port (the noise), worst groups, over every
(init, batch) seed pair tried:
  0/5: rgb heads 5.0e-2 (5.0e-2), background rgb heads 4.3e-2 (4.3e-2),
       pose rgb 3.5e-2 (6.9e-2); the table 2.0e-3 (4.6e-3), the SDF head
       5.9e-4 (1.8e-3), every other group within 2.2e-2;
  1/7: every group within 8.6e-3, the table 2.6e-3 (3.3e-3);
  2/3: every group within 1.2e-2, heads.mono 9.4e-3 (1.3e-3);
  3/11: every group within 1.6e-2, the table 3.6e-4 (4.7e-3).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multimodalstudio_tpu.configs.config as jconfig
import multimodalstudio_tpu.engine.train as jtrain
import multimodalstudio_tpu.models.model as jmodel
import multimodalstudio_tpu.models.samplers as jsamplers
import multimodalstudio_tpu.ops.pallas.slot_grid as jslot
from multimodalstudio_tpu.cameras.cameras import generate_rays as jgenerate_rays
from multimodalstudio_tpu.data.sampler import PixelBatch as JPixelBatch
from multimodalstudio_tpu.data.synthetic import make_synthetic_dataset as jmake_dataset

import multimodalstudio_tpu_torch.configs.config as tconfig
import multimodalstudio_tpu_torch.engine.train as ttrain
import multimodalstudio_tpu_torch.models.model as tmodel
import multimodalstudio_tpu_torch.models.samplers as tsamplers
import multimodalstudio_tpu_torch.ops.kernels.slot_grid as tslot
from multimodalstudio_tpu_torch.cameras.camera_optimizer import init_camera_poses
from multimodalstudio_tpu_torch.convert import params_from_jax
from multimodalstudio_tpu_torch.core.rays import RayBundle
from multimodalstudio_tpu_torch.data.synthetic import make_synthetic_dataset as tmake_dataset
from multimodalstudio_tpu_torch.ops.kernels import build

from test_torch_mlp_raw import _unflatten, assert_gradients_match, moved_runs
from test_torch_train import DATA, MODS, STEP, _perturbed, numpy_batch, rel_l2, tiny

torch.set_num_threads(1)

NO_PE = {"model": {"surface": {"surface_field": {"use_position_encoding": False}}}}


class _Registry:
    """tiny()'s `methods` argument: grid_raw_tpu through a package's
    load_config with the override."""

    def __init__(self, config_module):
        self.config_module = config_module

    def method_configs(self):
        return {"grid_raw_tpu": self.config_module.load_config(method="grid_raw_tpu",
                                                               overrides=NO_PE)}


JCFG = tiny(_Registry(jconfig), jsamplers, jslot)
TCFG = tiny(_Registry(tconfig), tsamplers, tslot)


def test_load_config_override_matches_jax():
    j = jconfig.load_config(method="grid_raw_tpu", overrides=NO_PE)
    t = tconfig.load_config(method="grid_raw_tpu", overrides=NO_PE)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert not t.model.surface.surface_field.use_position_encoding
    # a list onto a tuple field stays a tuple; an unknown key and method raise
    over = {"modalities": ["rgb", "mono"], "datamanager": {"num_rays_per_modality": 64}}
    t = tconfig.load_config(method="grid_raw_tpu", overrides=over)
    assert dataclasses.asdict(t) == dataclasses.asdict(
        jconfig.load_config(method="grid_raw_tpu", overrides=over))
    assert t.modalities == ("rgb", "mono") and t.datamanager.num_rays_per_modality == 64
    with pytest.raises(KeyError, match="unknown config key"):
        tconfig.load_config(method="grid_raw_tpu", overrides={"model": {"nope": 1}})
    with pytest.raises(KeyError, match="unknown method"):
        tconfig.load_config(method="grid_raw_nope")


def test_model_takes_the_composition_route():
    model = tmodel.MMSModel(TCFG.model, device="cpu")
    assert not model._slot_value_ok() and model._fused_slot()
    head = model.surface_field.field.grid_mlp.mlp_head
    assert tuple(head.layer_0.kernel.shape) == (3 + 3 * 2, 128)
    full = tmodel.MMSModel(tconfig.load_config(method="grid_raw_tpu", overrides=NO_PE).model,
                           device="cpu")
    # the full-width head: xyz and 6 levels x F = 2 into 128 -> 128 -> 257
    assert [tuple(l.kernel.shape) for l in full.surface_field.field.grid_mlp.mlp_head.layers()] == [
        (15, 128), (128, 128), (128, 257)]


@pytest.fixture(scope="module")
def carried():
    """Both packages on the same parameters: the port's init as a JAX params
    tree (its dotted state-dict keys are the flax paths), moved by
    test_torch_train.py's noise and loaded back through params_from_jax."""
    jds = jmake_dataset(MODS, **DATA)
    model = tmodel.MMSModel(TCFG.model, device="cpu").init(torch.Generator().manual_seed(0))
    tree = _unflatten({k: v.numpy() for k, v in model.state_dict().items()})
    num_cameras = {m: jds.data[m].cameras.camera_to_worlds.shape[0] for m in MODS}
    poses = {m: p.detach().numpy() for m, p in init_camera_poses(
        TCFG.datamanager.camera_optimizer, MODS, num_cameras, device="cpu").items()}
    params = _perturbed({"model": tree, "camera_poses": poses})
    state = params_from_jax(jax.tree.map(np.asarray, params), model)
    model.load_state_dict(state["model"])
    return dict(jm=jmodel.MMSModel(JCFG.model), params=params, jds=jds, model=model, state=state)


def _rays(jds, n, seed):
    cams = jds.data[MODS[0]].cameras
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 3, size=n).astype(np.int32)
    coords = rng.uniform(0, 8, size=(n, 2)).astype(np.float32)
    jrays = jgenerate_rays(cams, jnp.asarray(idx), jnp.asarray(coords))
    trays = RayBundle(**{
        f.name: None if getattr(jrays, f.name) is None
        else torch.tensor(np.asarray(getattr(jrays, f.name)))
        for f in dataclasses.fields(RayBundle)
    })
    return jrays, trays


def test_eval_forward_matches_jax(carried):
    n = 12
    jrays, trays = _rays(carried["jds"], n, 1)
    jm, params = carried["jm"], carried["params"]["model"]
    segments = ((MODS[0], n),)
    jout = jax.jit(lambda p, r: jm.forward(
        p, r, segments, jtrain.make_schedules(JCFG, jnp.asarray(STEP)), None, train=False,
        aligned=True))(params, jrays)
    build.reset_launch_counts()
    tout = carried["model"].forward(trays, segments, ttrain.make_schedules(TCFG, STEP),
                                    aligned=True)
    assert all(info.launches == 0 for info in build.KERNELS.values())  # plain versions only
    assert set(tout) == set(jout)
    for key in jout:
        assert tout[key].shape == jout[key].shape, key
        assert rel_l2(tout[key].numpy(), jout[key]) <= 1e-2, (key, rel_l2(tout[key].numpy(),
                                                                          jout[key]))


def test_sdf_gradients_take_the_composition_and_match_jax(carried):
    rng = np.random.default_rng(2)
    pos = rng.uniform(-0.9, 0.9, size=(2, 12, 3)).astype(np.float32)
    jm, params = carried["jm"], carried["params"]["model"]
    sched = jtrain.make_schedules(JCFG, jnp.asarray(STEP))
    ref = jax.jit(lambda p, x: jm.sdf_gradients(p, x, sched, False))(params, jnp.asarray(pos))
    got = carried["model"].sdf_gradients(torch.from_numpy(pos), ttrain.make_schedules(TCFG, STEP))
    assert ref[3] is None and got[3] is None
    assert got[1].dtype == torch.float32  # geo leaves the composition in f32 (model.py:649-651)
    for name, a, b in zip(("sdf", "geo", "grad"), got[:3], ref[:3]):
        assert tuple(a.shape) == tuple(b.shape), name
        assert rel_l2(a.detach().numpy(), np.asarray(b, np.float32)) <= 1e-2, name


@pytest.fixture(scope="module")
def slice_run(carried):
    """One batch through both packages' loss-and-gradient functions."""
    jds, jm, model = carried["jds"], carried["jm"], carried["model"]
    tds = tmake_dataset(MODS, **DATA, device="cpu")
    state = ttrain.init_train_state(TCFG, model, carried["state"]["camera_poses"], step=STEP)
    tbatch = numpy_batch(tds, TCFG.datamanager.num_rays_per_modality, 5)
    jbatch = {m: JPixelBatch(
        camera_indices=jnp.asarray(b.camera_indices.numpy().astype(np.int32)),
        pixel_coords=jnp.asarray(b.pixel_coords.numpy()), pixels=jnp.asarray(b.pixels.numpy()),
        mosaick_channel=jnp.asarray(b.mosaick_channel.numpy())) for m, b in tbatch.items()}
    jcams = {m: jds.data[m].cameras for m in MODS}
    grid = JCFG.model.surface.surface_field.field.grid
    step = jnp.asarray(STEP)
    j = jtrain._batch_loss_and_grads(
        JCFG, jm, jcams, grid, carried["params"], jbatch, step, jtrain.make_schedules(JCFG, step),
        jax.random.key(1), jax.random.key(2))
    tcams = {m: tds.data[m].cameras for m in MODS}

    def port():
        return ttrain.batch_loss_and_grads(TCFG, model, tcams, state.camera_poses, tbatch, STEP,
                                           ttrain.make_schedules(TCFG, STEP))

    return dict(j=j, t=port(), moved=moved_runs(model, port))


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
    its parameters moved by 1e-6)."""
    groups = assert_gradients_match(slice_run["j"][3], slice_run["t"][3], slice_run["moved"], MODS)
    assert {"table", "variance", "surface_field.field.grid_mlp.mlp_head",
            "radiance_field.base_field.mlp", "heads.polarization.field",
            "background_field.base_field.mlp"} <= set(groups)
