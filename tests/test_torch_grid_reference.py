"""The port's reference grid method grid_raw against the JAX package: hash
grids on surface and radiance, 4-tap numerical SDF gradients and their
hessian (and the 6 taps), the eval forward, and one training batch's losses
and every gradient group. tests/test_torch_grid_variants.py holds grid (on
demosaicked frames) and grid_raw_grid_bg_unbalanced (a hash-grid
background field) with this file's helpers.

Each configuration comes from its package's own load_config of
confs/grid_raw.yaml or confs/grid.yaml, or from the registry, and is cut to
CPU size as tests/test_integration.py cuts the grid methods: 4 grid levels,
max_res 64, 2^10 entries per level; MLP widths, geometric features and the
radiance features 32 wide; 8+8 NeuS samples in 2 upsample rounds and 4
background samples with no stratified jitter; 3 modalities, 4 rays per
modality in 2 microbatches. The port initialises the parameters (its
module tree is the JAX params tree), seeded numpy noise moves every leaf
and scales the hash tables up from +-1e-3 to +-1, and both packages take
the result, the port through convert.params_from_jax. The step is 25000,
where the coarse-to-fine mask keeps 3 of the 4 surface levels and the
numerical delta is 1 / (16 * growth^2) * 2.

Everything runs in float32 on both sides, with no kernel: the two differ
by summation order only. Tolerances: eval outputs rel-L2 <= 1e-3 (the
NeuS sampler's inverse CDF moves the samples of a ray where a bin edge
flips: readings 3e-7 to 3e-5 on 6 of 6 views of grid_raw and 5 of 6 of
the background variant, 1.7e-4 on one, where a single ray differs by
3.5e-4 in accumulation and every other ray by under 3e-6); SDF
values, gradients and hessians rel-L2 <= 1e-4; losses and metrics rel
1e-4; each gradient group rel-L2 <= max(1e-3, twice the port's distance
to itself with its parameters moved by 1e-6 in three draws), the noise
estimate of tests/test_torch_mlp_raw.py's assert_gradients_match, whose
floor there (3e-2) is the bf16 methods'.
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
from multimodalstudio_tpu.cameras.cameras import generate_rays as jgenerate_rays
from multimodalstudio_tpu.data.sampler import PixelBatch as JPixelBatch
from multimodalstudio_tpu.data.synthetic import make_synthetic_dataset as jmake_dataset

from multimodalstudio_tpu_torch.cameras.camera_optimizer import init_camera_poses
import multimodalstudio_tpu_torch.configs.config as tconfig
import multimodalstudio_tpu_torch.engine.train as ttrain
import multimodalstudio_tpu_torch.models.model as tmodel
import multimodalstudio_tpu_torch.models.samplers as tsamplers
from multimodalstudio_tpu_torch.convert import params_from_jax
from multimodalstudio_tpu_torch.core.rays import RayBundle
from multimodalstudio_tpu_torch.data.synthetic import make_synthetic_dataset as tmake_dataset

from test_torch_mlp_raw import _flatten, _unflatten, moved_runs, rel_l2
from test_torch_train import _groups, numpy_batch

torch.set_num_threads(1)

MODS = ("rgb", "polarization", "mono")
STEP = 25000
TOL = 1e-4  # f32 on both sides
EVAL_TOL = 1e-3  # the importance sampler can move one ray's samples
GRAD_FLOOR = 1e-3


def cut(cfg, samplers, width=32):
    """A reference config cut to CPU size (module docstring); an 8-layer
    MLP (the mlp methods') becomes 4 layers with the skip at layer 2."""
    rp = dataclasses.replace

    def grid(g):
        if g is None:
            return g
        return rp(g, encoding=rp(g.encoding, num_levels=4, max_res=64, log2_hashmap_size=10))

    def narrow(mlp):
        if mlp.num_layers == 8:  # the mlp methods' SDF MLP and radiance trunk
            mlp = rp(mlp, num_layers=4, skip_connections=(2,))
        return rp(mlp, hidden_dim=width) if mlp.hidden_dim > width else mlp

    def component(c):
        return rp(c, mlp=narrow(c.mlp), grid=grid(c.grid))

    m = cfg.model
    sf = m.surface.surface_field
    surface = rp(m.surface, surface_field=rp(sf, geo_feature_dim=width,
                                              field=component(sf.field)))
    rf = m.radiance.radiance_field
    radiance = rp(m.radiance, radiance_feature_dim=width,
                  radiance_field=rp(rf, base_field=component(rf.base_field)))
    bf = m.background.field
    background = rp(m.background, radiance_feature_dim=width, field=rp(
        bf, base_output_dim=width, base_field=component(bf.base_field),
        head_field=narrow(bf.head_field)))
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


def configs(conf=None, method=None, width=32):
    """(JAX config, port config), each through its package's load_config."""
    return (cut(jconfig.load_config(conf, method=method), jsamplers, width),
            cut(tconfig.load_config(conf, method=method), tsamplers, width))


def perturbed(params, seed=0):
    """Every leaf moved by seeded numpy noise; the hash tables scaled up
    1e3, so that the grid features matter."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        if path[-1] == "table":
            a = a * 1e3
        elif path[-1] == "kernel":
            a = a + (0.2 / np.sqrt(a.shape[0]) * rng.normal(size=a.shape)).astype(np.float32)
        elif path[-1] in ("bias", "g"):
            a = a + (0.05 * rng.normal(size=a.shape)).astype(np.float32)
        elif path[0] == "camera_poses":
            a = a + (0.01 * rng.normal(size=a.shape)).astype(np.float32)
        return jnp.asarray(a)

    return walk(params, ())


def carry(jcfg, tcfg, raw=True):
    """Both packages on the same parameters: the port's init as a JAX
    params tree, moved by `perturbed`, loaded back through
    convert.params_from_jax."""
    data = dict(num_views=3, height=8, width=8, raw=raw)
    jds = jmake_dataset(MODS, **data)
    model = tmodel.MMSModel(tcfg.model, device="cpu").init(torch.Generator().manual_seed(0))
    tree = _unflatten({k: v.numpy() for k, v in model.state_dict().items()})
    num_cameras = {m: jds.data[m].cameras.camera_to_worlds.shape[0] for m in MODS}
    poses = {m: p.detach().numpy() for m, p in init_camera_poses(
        tcfg.datamanager.camera_optimizer, MODS, num_cameras, device="cpu").items()}
    params = perturbed({"model": tree, "camera_poses": poses})
    state = params_from_jax(jax.tree.map(np.asarray, params), model)
    model.load_state_dict(state["model"])
    return dict(jm=jmodel.MMSModel(jcfg.model), params=params, jds=jds, model=model,
                state=state, jcfg=jcfg, tcfg=tcfg, data=data)


def rays(jds, n, seed):
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


def eval_forward(c, n=16, seed=1):
    jrays, trays = rays(c["jds"], n, seed)
    jm, params = c["jm"], c["params"]["model"]
    segments = ((MODS[0], n),)
    jout = jax.jit(lambda p, r: jm.forward(
        p, r, segments, jtrain.make_schedules(c["jcfg"], jnp.asarray(STEP)), None, train=False,
        aligned=True))(params, jrays)
    tout = c["model"].forward(trays, segments, ttrain.make_schedules(c["tcfg"], STEP),
                              aligned=True)
    return jout, tout


def assert_outputs_match(jout, tout):
    assert set(tout) == set(jout)
    for key in jout:
        assert tout[key].shape == jout[key].shape, key
        err = rel_l2(tout[key].numpy(), jout[key])
        assert err <= EVAL_TOL, (key, err)


def batch_run(c, seed):
    """One batch through both packages' loss-and-gradient functions, and
    the port's moved_runs."""
    jds, jm, model = c["jds"], c["jm"], c["model"]
    jcfg, tcfg = c["jcfg"], c["tcfg"]
    tds = tmake_dataset(MODS, **c["data"], device="cpu")
    state = ttrain.init_train_state(tcfg, model, c["state"]["camera_poses"], step=STEP)
    tbatch = numpy_batch(tds, tcfg.datamanager.num_rays_per_modality, seed)
    jbatch = {m: JPixelBatch(
        camera_indices=jnp.asarray(b.camera_indices.numpy().astype(np.int32)),
        pixel_coords=jnp.asarray(b.pixel_coords.numpy()), pixels=jnp.asarray(b.pixels.numpy()),
        mosaick_channel=jnp.asarray(b.mosaick_channel.numpy())) for m, b in tbatch.items()}
    jcams = {m: jds.data[m].cameras for m in MODS}
    step = jnp.asarray(STEP)
    j = jtrain._batch_loss_and_grads(
        jcfg, jm, jcams, jcfg.model.surface.surface_field.field.grid, c["params"], jbatch,
        step, jtrain.make_schedules(jcfg, step), jax.random.key(1), jax.random.key(2))
    tcams = {m: tds.data[m].cameras for m in MODS}

    def port():
        return ttrain.batch_loss_and_grads(tcfg, model, tcams, state.camera_poses, tbatch, STEP,
                                           ttrain.make_schedules(tcfg, STEP))

    return dict(j=j, t=port(), moved=moved_runs(model, port))


def assert_losses_match(run):
    jtotal, jlo, jmet, _ = run["j"]
    ttotal, tlo, tmet, _ = run["t"]
    assert set(tlo) == set(jlo)
    for k in jlo:
        ref = float(jlo[k])
        assert abs(float(tlo[k]) - ref) <= TOL * abs(ref), (k, float(tlo[k]), ref)
    assert abs(float(ttotal) - float(jtotal)) <= TOL * abs(float(jtotal))
    assert set(tmet) == set(jmet)
    for k in jmet:
        assert abs(float(tmet[k]) - float(jmet[k])) <= TOL * abs(float(jmet[k])), k


def assert_gradients_match(jgrads, tgrads, moved):
    """Each gradient group of the fields and each modality's camera-pose
    gradient within max(GRAD_FLOOR, twice the port's distance to itself
    over the moved runs) of JAX's; returns the groups."""
    jflat = _flatten(jgrads["model"])
    assert set(jflat) == set(tgrads["fields"])

    def check(name, got, ref, others):
        assert np.linalg.norm(ref) > 0, name
        noise = max(rel_l2(o, got) for o in others)
        err = rel_l2(got, ref)
        assert err <= max(GRAD_FLOOR, 2 * noise), (name, err, noise)

    def cat(fields, keys):
        return np.concatenate([fields[k].numpy().ravel() for k in keys])

    groups = {}
    for k in jflat:  # each hash table a group of its own
        parts = k.split(".")
        g = ".".join(parts[:-1]) if parts[-1] == "table" else next(iter(_groups([k])))
        groups.setdefault(g, []).append(k)
    for name, keys in groups.items():
        check(name, cat(tgrads["fields"], keys), np.concatenate([jflat[k].ravel() for k in keys]),
              [cat(m["fields"], keys) for m in moved])
    for mod in MODS:
        check(mod, tgrads["camera_poses"][mod].numpy(), np.asarray(jgrads["camera_poses"][mod]),
              [m["camera_poses"][mod].numpy() for m in moved])
    return groups


# ------------------------------------------------------------------ grid_raw

@pytest.fixture(scope="module")
def grid_raw():
    return carry(*configs("confs/grid_raw.yaml"))


def test_grid_raw_takes_hash_grids_and_numerical_taps(grid_raw):
    cfg = grid_raw["tcfg"]
    surface = cfg.model.surface
    assert surface.use_numerical_gradients and surface.numerical_gradient_taps == 4
    assert surface.compute_hessian and cfg.model.remat
    keys = set(grid_raw["model"].state_dict())
    assert {"surface_field.field.grid_mlp.feature_grid.encoding.table",
            "radiance_field.base_field.grid_mlp.feature_grid.encoding.table"} <= keys
    table = grid_raw["model"].surface_field.field.grid_mlp.feature_grid.encoding.table
    assert tuple(table.shape) == (4 * 2**10, 2)


def test_grid_raw_eval_forward_matches_jax(grid_raw):
    assert_outputs_match(*eval_forward(grid_raw))


@pytest.mark.parametrize("taps", [4, 6])
def test_numerical_sdf_gradients_match_jax(grid_raw, taps):
    """sdf, geo, d sdf/dx and the hessian diagonal of the 4 and 6 taps."""
    rng = np.random.default_rng(2)
    pos = rng.uniform(-0.9, 0.9, size=(2, 20, 3)).astype(np.float32)
    jcfg, tcfg = grid_raw["jcfg"], grid_raw["tcfg"]
    jm = jmodel.MMSModel(dataclasses.replace(jcfg.model, surface=dataclasses.replace(
        jcfg.model.surface, numerical_gradient_taps=taps)))
    tm = tmodel.MMSModel(dataclasses.replace(tcfg.model, surface=dataclasses.replace(
        tcfg.model.surface, numerical_gradient_taps=taps)), device="cpu")
    tm.load_state_dict(grid_raw["model"].state_dict())
    jsched = jtrain.make_schedules(jcfg, jnp.asarray(STEP))
    tsched = ttrain.make_schedules(tcfg, STEP)
    assert tsched.active_level == 3
    for train in (False, True):
        ref = jax.jit(lambda p, x: jm.sdf_gradients(p, x, jsched, train))(
            grid_raw["params"]["model"], jnp.asarray(pos))
        got = tm.sdf_gradients(torch.from_numpy(pos), tsched, train=train)
        assert (got[3] is None) == (ref[3] is None) == (not train)
        for name, a, b in zip(("sdf", "geo", "grad", "hessian"), got, ref):
            if b is None:
                continue
            assert tuple(a.shape) == tuple(b.shape), name
            err = rel_l2(a.detach().numpy(), np.asarray(b))
            assert err <= TOL, (taps, train, name, err)


@pytest.fixture(scope="module")
def grid_raw_batch(grid_raw):
    return batch_run(grid_raw, 5)


def test_grid_raw_batch_losses_match_jax(grid_raw_batch):
    assert {"eikonal_loss", "curvature_loss"} <= set(grid_raw_batch["t"][1])
    assert_losses_match(grid_raw_batch)


def test_grid_raw_batch_gradients_match_jax(grid_raw_batch):
    groups = assert_gradients_match(grid_raw_batch["j"][3], grid_raw_batch["t"][3],
                                    grid_raw_batch["moved"])
    assert {"surface_field.field.grid_mlp.feature_grid.encoding",
            "radiance_field.base_field.grid_mlp.feature_grid.encoding",
            "surface_field.field.grid_mlp.mlp_head", "variance"} <= set(groups)
