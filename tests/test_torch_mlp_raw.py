"""The port's mlp_raw_tpu slice against the JAX package: the eval forward,
the K4 route of sdf_gradients, and the losses and every gradient group of a
training batch.

mlp_raw_tpu is cut to CPU size from each package's own classes: the SDF
MLP and the radiance trunk 4 layers of width 128 with the skip at layer 2
(the full method has 8 x 256 with the skip at 4), geometric features 128
wide, the other MLPs at width 128, 8+8 NeuS samples in 2 upsample rounds
and 4 background samples with no stratified jitter, 3 modalities, 4 rays
per modality in 2 microbatches. The port initialises the parameters (its
module tree is the JAX params tree, checked against the JAX init's shapes),
seeded numpy noise moves every leaf (the geometric init zeroes the SDF
chain's weights on the encoded columns), and both packages take the result,
the port through convert.params_from_jax. JAX runs its Pallas kernels in interpret mode, the
port the plain versions of K1 and K4.

Both round to bf16 at the same points; they differ by f32 summation order,
which now and then flips the bf16 rounding of an activation, and down the
chains and their backward such flips add up. Tolerances: eval outputs and
the SDF route rel-L2 <= 1e-2, losses rel 1e-2.

Some gradient groups of a 12-ray batch jump when a single bf16 rounding
flips: the camera-pose gradient sums per-sample position cotangents that
carry the eikonal loss's second derivatives, and SoftplusQuad's act''
jumps from 0 to beta / 4 at |z| = 2 / beta, so a pre-activation that
crosses that edge moves it in a step (on the batch drawn with seed 5 a
relative move of 1e-5 of every parameter moved the rgb camera-pose
gradient of the port by 18 % to 108 %). So each group is held to
max(3e-2, 2 * noise), noise being the port's distance to itself with its
parameters moved by 1e-6 in three draws, computed in the test
(`assert_gradients_match`, which tests/test_torch_mlp_contraction.py and
tests/test_torch_slot_composition.py share). Readings, JAX against the
port (the noise), worst groups, over every batch seed tried:
  5: the rgb poses 1.6e-1 (2.8e-1), the background density head 1.7e-2
     (2.3e-2), every other group within 1.5e-2; losses within rel 4.5e-4;
  7: every group within 9.4e-3 (the variance; its noise 1.9e-2), the rgb
     poses 6.6e-3 (4.2e-1); losses within rel 2.3e-3.
The batch is drawn with seed 5, the seed this test first took.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multimodalstudio_tpu.configs.methods as jmethods
import multimodalstudio_tpu.engine.train as jtrain
import multimodalstudio_tpu.models.model as jmodel
import multimodalstudio_tpu.models.samplers as jsamplers
from multimodalstudio_tpu.cameras.cameras import generate_rays as jgenerate_rays
from multimodalstudio_tpu.data.sampler import PixelBatch as JPixelBatch
from multimodalstudio_tpu.data.synthetic import make_synthetic_dataset as jmake_dataset

from multimodalstudio_tpu_torch.cameras.camera_optimizer import init_camera_poses
import multimodalstudio_tpu_torch.configs.methods as tmethods
import multimodalstudio_tpu_torch.engine.train as ttrain
import multimodalstudio_tpu_torch.models.model as tmodel
import multimodalstudio_tpu_torch.models.samplers as tsamplers
from multimodalstudio_tpu_torch.convert import params_from_jax
from multimodalstudio_tpu_torch.core.rays import RayBundle
from multimodalstudio_tpu_torch.data.sampler import UniformPixelSampler
from multimodalstudio_tpu_torch.data.synthetic import make_synthetic_dataset as tmake_dataset

from test_torch_train import _groups

torch.set_num_threads(1)

MODS = ("rgb", "polarization", "mono")
STEP = 2000  # cos_anneal_ratio 0.4
DATA = dict(num_views=3, height=8, width=8, raw=True)


def rel_l2(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def tiny(methods, samplers):
    """mlp_raw_tpu cut to CPU size, from one package's own classes."""
    cfg = methods.method_configs()["mlp_raw_tpu"]
    rp = dataclasses.replace
    m = cfg.model

    def narrow(mlp):
        if mlp.num_layers == 8:  # the SDF MLP and the radiance trunk
            return rp(mlp, num_layers=4, hidden_dim=128, skip_connections=(2,))
        return rp(mlp, hidden_dim=128) if mlp.hidden_dim == 256 else mlp

    sf = m.surface.surface_field
    surface = rp(m.surface, surface_field=rp(
        sf, geo_feature_dim=128, field=rp(sf.field, mlp=narrow(sf.field.mlp))))
    rf = m.radiance.radiance_field
    radiance = rp(m.radiance, radiance_feature_dim=128, radiance_field=rp(
        rf, base_field=rp(rf.base_field, mlp=narrow(rf.base_field.mlp))))
    bf = m.background.field
    background = rp(m.background, field=rp(
        bf, base_output_dim=128, base_field=rp(bf.base_field, mlp=narrow(bf.base_field.mlp))))
    heads = tuple((k, rp(h, mlp=narrow(h.mlp))) for k, h in m.heads)
    model = rp(
        m, modalities=tuple((k, c) for k, c in m.modalities if k in MODS), heads=heads,
        surface=surface, radiance=radiance, background=background,
        ray_sampler=samplers.NeuSSamplerSpec(num_samples=8, num_samples_importance=8,
                                             num_upsample_steps=2, train_stratified=False),
        background_ray_sampler=samplers.SpacedSamplerSpec(num_samples=4, spacing="lin_disparity",
                                                          train_stratified=False),
    )
    dm = rp(cfg.datamanager, num_rays_per_modality=4, microbatch_rays=2)
    return rp(cfg, model=model, modalities=MODS, datamanager=dm)


JCFG = tiny(jmethods, jsamplers)
TCFG = tiny(tmethods, tsamplers)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree if isinstance(tree, jax.ShapeDtypeStruct) else np.asarray(tree)}


def _perturbed(params, seed=0):
    """Every leaf moved by seeded numpy noise."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        if path[-1] == "kernel":
            a = a + (0.2 / np.sqrt(a.shape[0]) * rng.normal(size=a.shape)).astype(np.float32)
        elif path[-1] in ("bias", "g"):
            a = a + (0.05 * rng.normal(size=a.shape)).astype(np.float32)
        elif path[0] == "camera_poses":
            a = a + (0.01 * rng.normal(size=a.shape)).astype(np.float32)
        return jnp.asarray(a)

    return walk(params, ())


def _unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def carry(jcfg, tcfg):
    """Both packages on the same parameters: the port's init as a JAX
    params tree (the dotted state-dict keys are the flax paths), moved by
    numpy noise, and loaded back through convert.params_from_jax."""
    jds = jmake_dataset(MODS, **DATA)
    model = tmodel.MMSModel(tcfg.model, device="cpu").init(torch.Generator().manual_seed(0))
    tree = _unflatten({k: v.numpy() for k, v in model.state_dict().items()})
    num_cameras = {m: jds.data[m].cameras.camera_to_worlds.shape[0] for m in MODS}
    poses = {m: p.detach().numpy() for m, p in init_camera_poses(
        tcfg.datamanager.camera_optimizer, MODS, num_cameras, device="cpu").items()}
    params = _perturbed({"model": tree, "camera_poses": poses})
    state = params_from_jax(jax.tree.map(np.asarray, params), model)
    model.load_state_dict(state["model"])
    return dict(jm=jmodel.MMSModel(jcfg.model), params=params, jds=jds, model=model,
                state=state, jcfg=jcfg, tcfg=tcfg)


@pytest.fixture(scope="module")
def carried():
    return carry(JCFG, TCFG)


def test_convert_maps_the_deep_mlps(carried):
    """Weight norm and layer_dims give the JAX tree's keys and shapes (the
    JAX init traced, not run), so convert.params_from_jax maps every leaf,
    the surface_field.field.mlp.layer_* ones included; the skip layer's
    kernel is widened by the encoded input."""
    shapes = _flatten(jax.eval_shape(carried["jm"].init, jax.random.key(0)))
    ours = {k: tuple(v.shape) for k, v in carried["model"].state_dict().items()}
    assert ours == {k: tuple(v.shape) for k, v in shapes.items()}
    assert {k for k in ours if k.startswith("surface_field.field.mlp.")} == {
        f"surface_field.field.mlp.layer_{l}.{p}" for l in range(4) for p in ("kernel", "bias", "g")}
    assert ours["surface_field.field.mlp.layer_2.kernel"] == (128 + 39, 128)


def test_geometric_init_zeroes_the_encoded_columns():
    """The 8-layer surface MLP of mlp_raw_tpu at full width: layer 0 and the
    skip layer 4 see only raw xyz at init (fields/mlp.py:170-203)."""
    cfg = tmethods.method_configs()["mlp_raw_tpu"]
    model = tmodel.MMSModel(cfg.model, device="cpu").init(torch.Generator().manual_seed(0))
    mlp = model.surface_field.field.mlp.requires_grad_(False)
    assert len(mlp.layers()) == 8
    assert float(mlp.layer_0.kernel[3:].abs().max()) == 0.0
    assert float(mlp.layer_0.kernel[:3].abs().max()) > 0.0
    assert tuple(mlp.layer_4.kernel.shape) == (256 + 39, 256)
    assert float(mlp.layer_4.kernel[-36:].abs().max()) == 0.0
    assert float(mlp.layer_4.kernel[:-36].abs().max()) > 0.0


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
    n = 24
    jrays, trays = _rays(carried["jds"], n, 1)
    jm, params = carried["jm"], carried["params"]["model"]
    segments = ((MODS[0], n),)
    jout = jax.jit(lambda p, r: jm.forward(
        p, r, segments, jtrain.make_schedules(JCFG, jnp.asarray(STEP)), None, train=False,
        aligned=True))(params, jrays)
    tout = carried["model"].forward(trays, segments, ttrain.make_schedules(TCFG, STEP),
                                    aligned=True)
    assert set(tout) == set(jout)
    for key in jout:
        assert tout[key].shape == jout[key].shape, key
        assert rel_l2(tout[key].numpy(), jout[key]) <= 1e-2, (key, rel_l2(tout[key].numpy(),
                                                                          jout[key]))


def test_sdf_gradients_take_k4_and_match_jax(carried):
    rng = np.random.default_rng(2)
    pos = rng.uniform(-0.9, 0.9, size=(2, 20, 3)).astype(np.float32)
    jm, params = carried["jm"], carried["params"]["model"]
    jsched = jtrain.make_schedules(JCFG, jnp.asarray(STEP))
    ref = jm.sdf_gradients(params, jnp.asarray(pos), jsched, True)
    got = carried["model"].sdf_gradients(torch.from_numpy(pos),
                                         ttrain.make_schedules(TCFG, STEP), train=True)
    assert ref[3] is None and got[3] is None
    assert got[1].dtype == torch.bfloat16
    for name, a, b in zip(("sdf", "geo", "grad"), got[:3], ref[:3]):
        assert tuple(a.shape) == tuple(b.shape), name
        assert rel_l2(a.detach().float().numpy(), np.asarray(b, np.float32)) <= 1e-2, name


BATCH_SEED = 5  # the batch of the training tests (readings above)


def batch_run(carried, seed):
    """One batch, drawn with `seed`, through both packages' loss-and-gradient
    functions, and the port's moved_runs."""
    jds, jm, model = carried["jds"], carried["jm"], carried["model"]
    jcfg, tcfg = carried["jcfg"], carried["tcfg"]
    tds = tmake_dataset(MODS, **DATA, device="cpu")
    state = ttrain.init_train_state(tcfg, model, carried["state"]["camera_poses"], step=STEP)
    tbatch = UniformPixelSampler(tds, tcfg.datamanager.num_rays_per_modality, seed=seed).sample()
    jbatch = {m: JPixelBatch(
        camera_indices=jnp.asarray(b.camera_indices.numpy().astype(np.int32)),
        pixel_coords=jnp.asarray(b.pixel_coords.numpy()), pixels=jnp.asarray(b.pixels.numpy()),
        mosaick_channel=jnp.asarray(b.mosaick_channel.numpy())) for m, b in tbatch.items()}
    jcams = {m: jds.data[m].cameras for m in MODS}
    step = jnp.asarray(STEP)
    j = jtrain._batch_loss_and_grads(
        jcfg, jm, jcams, jcfg.model.surface.surface_field.field.grid, carried["params"], jbatch,
        step, jtrain.make_schedules(jcfg, step), jax.random.key(1), jax.random.key(2))
    tcams = {m: tds.data[m].cameras for m in MODS}

    def port():
        return ttrain.batch_loss_and_grads(tcfg, model, tcams, state.camera_poses, tbatch, STEP,
                                           ttrain.make_schedules(tcfg, STEP))

    return dict(j=j, t=port(), moved=moved_runs(model, port))


@pytest.fixture(scope="module")
def slice_run(carried):
    return batch_run(carried, BATCH_SEED)


def moved_runs(model, port, draws=3):
    """The gradients of `port()` with every parameter of `model` moved by
    1e-6 (relative), about as far as another f32 summation order moves a
    bf16 rounding, in `draws` seeded draws; the parameters are restored."""
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    moved = []
    for draw in range(draws):
        noise = torch.Generator().manual_seed(100 + draw)
        model.load_state_dict({k: v * (1 + 1e-6 * torch.randn(v.shape, generator=noise))
                               for k, v in saved.items()})
        moved.append(port()[3])
    model.load_state_dict(saved)
    return moved


def assert_gradients_match(jgrads, tgrads, moved, mods):
    """Each gradient group of the fields and each modality's camera-pose
    gradient within max(3e-2, twice the port's largest distance to itself
    over the `moved` runs) of JAX's; returns the groups."""
    jflat = _flatten(jgrads["model"])
    assert set(jflat) == set(tgrads["fields"])

    def check(name, got, ref, others):
        assert np.linalg.norm(ref) > 0, name
        noise = max(rel_l2(o, got) for o in others)
        assert rel_l2(got, ref) <= max(3e-2, 2 * noise), (name, rel_l2(got, ref), noise)

    def cat(fields, keys):
        return np.concatenate([fields[k].numpy().ravel() for k in keys])

    groups = _groups(jflat)
    for name, keys in groups.items():
        check(name, cat(tgrads["fields"], keys), np.concatenate([jflat[k].ravel() for k in keys]),
              [cat(m["fields"], keys) for m in moved])
    for mod in mods:
        check(mod, tgrads["camera_poses"][mod].numpy(), np.asarray(jgrads["camera_poses"][mod]),
              [m["camera_poses"][mod].numpy() for m in moved])
    return groups


def test_slice_losses_match_jax(slice_run):
    jtotal, jlo, jmet, _ = slice_run["j"]
    ttotal, tlo, tmet, _ = slice_run["t"]
    assert set(tlo) == set(jlo)
    assert "eikonal_loss" in tlo and "curvature_loss" not in tlo
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
    assert {"variance", "surface_field.field.mlp", "radiance_field.base_field.mlp",
            "heads.polarization.field", "background_field.base_field.mlp"} <= set(groups)
