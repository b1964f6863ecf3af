"""The port's training step against the JAX package: losses, the optimizer
and one grid_raw_tpu step on a tiny model.

Losses run on the same numpy inputs through both packages and agree to
f32 rounding (rel 1e-6). The optimizer (clipping, AdamW, the scheduled
learning rate, the skip on a non-finite gradient) gets the same gradients
as JAX's _guarded_update over optax for four steps and must hold the same
parameters and moments to 1e-6 relative.

The slice as a whole: a tiny grid_raw_tpu (the small slot grid and light
samplers of tests/test_torch_model.py, no stratified jitter on either side
so neither draws) starts from the JAX package's init_train_state, carried
across with convert.params_from_jax, and takes the same host-sampled batch
in two microbatches. The losses and the gradients of every parameter group
are held against JAX's _batch_loss_and_grads (Pallas kernels in interpret
mode). Both sides round to bf16 at the same points, but in other f32
summation orders: a flipped bf16 rounding of an activation moves a value
by one bf16 ulp there, and down the chains and their backward such flips
add up. Measured: radiance losses within rel 4e-3 (means over 4 rays),
geometry losses within 1e-5, gradient groups within rel-L2 1.1e-2 (the
table 5e-4). Tolerances: losses and metrics rel 1e-2, each gradient group
rel-L2 <= 3e-2.
"""

import dataclasses
import functools

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multimodalstudio_tpu.configs.methods as jmethods
import multimodalstudio_tpu.engine.losses as jlosses
import multimodalstudio_tpu.engine.train as jtrain
import multimodalstudio_tpu.models.model as jmodel
import multimodalstudio_tpu.models.samplers as jsamplers
import multimodalstudio_tpu.ops.pallas.slot_grid as jslot
from multimodalstudio_tpu.data.sampler import PixelBatch as JPixelBatch
from multimodalstudio_tpu.data.synthetic import make_synthetic_dataset as jmake_dataset

import multimodalstudio_tpu_torch.configs.methods as tmethods
import multimodalstudio_tpu_torch.engine.losses as tlosses
import multimodalstudio_tpu_torch.engine.train as ttrain
import multimodalstudio_tpu_torch.models.model as tmodel
import multimodalstudio_tpu_torch.models.samplers as tsamplers
import multimodalstudio_tpu_torch.ops.kernels.slot_grid as tslot
from multimodalstudio_tpu_torch.convert import params_from_jax
from multimodalstudio_tpu_torch.data.device_cache import build_device_cache, sample_pixel_batch
from multimodalstudio_tpu_torch.data import native
from multimodalstudio_tpu_torch.data.sampler import UniformPixelSampler
from multimodalstudio_tpu_torch.data.synthetic import make_synthetic_dataset as tmake_dataset

from test_torch_model import compiled_init

torch.set_num_threads(1)

MODS = ("rgb", "polarization", "mono")


def rel_l2(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("loss,threshold", [("L1", None), ("MSE", None), ("L1", 0.9)])
def test_radiance_loss_matches_jax(loss, threshold):
    rng = np.random.default_rng(0)
    pred = rng.uniform(0, 1, size=(37, 4)).astype(np.float32)
    target = rng.uniform(0.5, 1, size=(37, 4)).astype(np.float32)  # some saturated
    jspec = jlosses.RadianceLossSpec(loss=loss, saturation_threshold=threshold)
    tspec = tlosses.RadianceLossSpec(loss=loss, saturation_threshold=threshold)
    ref = float(jlosses.radiance_loss(jspec, jnp.asarray(pred), jnp.asarray(target)))
    got = float(tlosses.radiance_loss(tspec, torch.from_numpy(pred), torch.from_numpy(target)))
    assert abs(got - ref) <= 1e-6 * abs(ref)
    if threshold is not None:
        # saturated residuals are zeroed but stay in the mean's denominator
        err = np.abs(pred - target)
        assert np.isclose(got, np.where(target > threshold, 0.0, err).mean(), rtol=1e-6)


def test_eikonal_and_curvature_losses_match_jax():
    rng = np.random.default_rng(1)
    grads = rng.normal(size=(5, 7, 3)).astype(np.float32)
    grads[2, 3] = 0.0  # an all-zero SDF gradient: the safe norm keeps its gradient finite
    hess = rng.normal(size=(5, 2, 3)).astype(np.float32)
    gspec = jlosses.GeometryLossSpec(curvature_loss="L1")
    tspec = tlosses.GeometryLossSpec(curvature_loss="L1")
    jg = jax.grad(lambda g: jlosses.eikonal_loss(gspec, g))(jnp.asarray(grads))
    tg = torch.from_numpy(grads).requires_grad_(True)
    loss = tlosses.eikonal_loss(tspec, tg)
    loss.backward()
    ref = float(jlosses.eikonal_loss(gspec, jnp.asarray(grads)))
    assert abs(float(loss.detach()) - ref) <= 1e-6 * abs(ref)
    assert torch.isfinite(tg.grad).all() and float(tg.grad[2, 3].abs().max()) == 0.0
    assert rel_l2(tg.grad.numpy(), jg) <= 1e-6
    ref = float(jlosses.curvature_loss(gspec, jnp.asarray(hess)))
    got = float(tlosses.curvature_loss(tspec, torch.from_numpy(hess)))
    assert abs(got - ref) <= 1e-6 * abs(ref)


def test_compute_losses_curvature_weight_matches_jax():
    jcfg, tcfg = JCFG, TCFG
    rng = np.random.default_rng(2)
    outs = {m: rng.uniform(0, 1, size=(6, 1)).astype(np.float32) for m in MODS}
    outs["gradients"] = rng.normal(size=(6, 4, 3)).astype(np.float32)
    outs["hessians"] = rng.normal(size=(6, 1, 3)).astype(np.float32)
    targets = {m: rng.uniform(0, 1, size=(6, 1)).astype(np.float32) for m in MODS}
    grid_j = jcfg.model.surface.surface_field.field.grid
    grid_t = tcfg.model.surface.surface_field.field.grid
    for step in (0, 5000, 15000, 35000):
        jl, jt = jlosses.compute_losses(
            jcfg.loss_manager, {k: jnp.asarray(v) for k, v in outs.items()},
            {k: jnp.asarray(v) for k, v in targets.items()}, jnp.asarray(step),
            jcfg.max_num_iterations, grid_j)
        tl, tt = tlosses.compute_losses(
            tcfg.loss_manager, {k: torch.from_numpy(v) for k, v in outs.items()},
            {k: torch.from_numpy(v) for k, v in targets.items()}, step,
            tcfg.max_num_iterations, grid_t)
        assert set(tl) == set(jl)
        for k in jl:
            assert abs(float(tl[k]) - float(jl[k])) <= 1e-6 * max(1.0, abs(float(jl[k]))), (step, k)
        assert abs(float(tt) - float(jt)) <= 1e-6 * abs(float(jt))


def test_channel_decimation_draws_from_the_generator():
    """With a generator, one channel per pixel is drawn from the
    configured distribution; a one-hot distribution picks that channel."""
    rng = np.random.default_rng(4)
    pred = torch.from_numpy(rng.uniform(0, 1, size=(50, 3)).astype(np.float32))
    target = torch.from_numpy(rng.uniform(0, 1, size=(50, 3)).astype(np.float32))
    spec = tlosses.RadianceLossSpec(per_channel_probability=(0.0, 1.0, 0.0))
    got = tlosses.radiance_loss(spec, pred, target, torch.Generator().manual_seed(0))
    assert torch.allclose(got, (pred[:, 1] - target[:, 1]).abs().mean())
    # without a generator every channel is supervised, as the reference does without an rng
    assert torch.allclose(tlosses.radiance_loss(spec, pred, target), (pred - target).abs().mean())


def test_schedules_match_jax_at_the_tested_steps():
    """The learning-rate and curvature warm-up factors at the steps these
    tests and chip_smoke.py use (max 20 and 100000 iterations)."""
    jgrid = JCFG.model.surface.surface_field.field.grid
    tgrid = TCFG.model.surface.surface_field.field.grid
    jlr = JCFG.optimizer_spec("fields").scheduler
    tlr = TCFG.optimizer_spec("fields").scheduler
    jcurv = JCFG.loss_manager.geometry.curvature_scheduler
    tcurv = TCFG.loss_manager.geometry.curvature_scheduler
    for max_iters, steps in ((20, range(5)), (100000, (0, 1, 6, 7, 9999, 10000, 15000, 35000,
                                                       50001, 80000, 95000))):
        for step in steps:
            ref = float(jlr.factor(jnp.asarray(step), max_iters))
            assert abs(tlr.factor(step, max_iters) - ref) <= 1e-6 * max(ref, 1e-6), (max_iters, step)
            ref = float(jcurv.factor(jnp.asarray(step), max_iters, jgrid))
            got = tcurv.factor(step, max_iters, tgrid)
            assert abs(got - ref) <= 1e-6 * max(ref, 1e-6), (max_iters, step)


# --------------------------------------------------------------- optimizer


def test_optimizer_matches_optax_with_clipping_and_a_skipped_step():
    """Four steps of the same gradients: step 1 is not finite (skipped:
    params and state, count included, stay), step 2 clips (norm > 2)."""
    cfg = dataclasses.replace(TCFG, max_num_iterations=20)  # warm-up over 2 updates
    jcfg = dataclasses.replace(JCFG, max_num_iterations=20)
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 3), "b": (5,)}
    params = {"model": {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()},
              "camera_poses": {"rgb": (0.01 * rng.normal(size=(1, 6))).astype(np.float32)}}
    scales = [0.1, 1.0, 3.0, 0.2]
    grads = []
    for i, sc in enumerate(scales):
        g = jax.tree.map(lambda p: (sc * rng.normal(size=p.shape)).astype(np.float32), params)
        if i == 1:
            g["model"]["b"][2] = np.nan
        grads.append(g)
    tx = jtrain.make_optimizer(jcfg)
    jstate = jtrain.TrainState(params=jax.tree.map(jnp.asarray, params),
                               opt_state=tx.init(jax.tree.map(jnp.asarray, params)),
                               step=jnp.asarray(0))
    tparams = {"fields": {k: torch.tensor(v) for k, v in params["model"].items()},
               "camera_poses": {k: torch.tensor(v) for k, v in params["camera_poses"].items()}}
    opt = ttrain.make_optimizer(cfg)
    tstate = ttrain.TrainState(camera_poses=tparams["camera_poses"], step=0,
                               opt_state=opt.init(tparams))
    for i, g in enumerate(grads):
        metrics = {}
        new_params, new_opt = jtrain._guarded_update(tx, jax.tree.map(jnp.asarray, g), jstate,
                                                     metrics)
        jstate = jtrain.TrainState(params=new_params, opt_state=new_opt, step=jstate.step + 1)
        tg = {"fields": {k: torch.tensor(v) for k, v in g["model"].items()},
              "camera_poses": {k: torch.tensor(v) for k, v in g["camera_poses"].items()}}
        finite = ttrain.guarded_update(opt, tg, tparams, tstate)
        assert finite == float(metrics["grads_finite"]) == (0.0 if i == 1 else 1.0)
        inner = {name: st.inner_state for name, st in jstate.opt_state[1].inner_states.items()}
        for jg, tg_ in (("model", "fields"), ("camera_poses", "camera_poses")):
            jadam, _, jsched = inner[tg_]
            assert int(jadam.count) == int(jsched.count) == tstate.opt_state.count, i
            for k, p in tparams[tg_].items():
                # per leaf: the global norm sums in another order and small
                # moment entries cancel, so compare each leaf in rel-L2
                assert rel_l2(p.numpy(), jstate.params[jg][k]) <= 1e-6, (i, k)
                assert rel_l2(tstate.opt_state.mu[tg_][k].numpy(), jadam.mu[jg][k]) <= 1e-6
                assert rel_l2(tstate.opt_state.nu[tg_][k].numpy(), jadam.nu[jg][k]) <= 1e-6
    assert tstate.opt_state.count == 3


# ------------------------------------------------------------- the slice


def _narrow(mlp):
    return dataclasses.replace(mlp, hidden_dim=128) if mlp.hidden_dim == 256 else mlp


def tiny(methods, samplers, slot):
    """grid_raw_tpu cut to CPU size, from one package's own classes: a
    3-level slot grid, hidden widths 128, 8+8 NeuS and 4 background
    samples with no stratified jitter, 4 rays per modality in 2
    microbatches."""
    cfg = methods.method_configs()["grid_raw_tpu"]
    rp = dataclasses.replace
    m = cfg.model
    sf = m.surface.surface_field
    grid = rp(sf.field.grid, encoding=slot.SlotGridSpec(
        num_levels=3, min_res=4, max_res=16, rows_per_level=64, layout="cell", feats=2,
        table_dtype="bf16"))
    surface = rp(m.surface, sampler_levels=2,
                 surface_field=rp(sf, geo_feature_dim=64, field=rp(sf.field, grid=grid)))
    rf = m.radiance.radiance_field
    radiance = rp(m.radiance, radiance_feature_dim=128, radiance_field=rp(
        rf, base_field=rp(rf.base_field, mlp=_narrow(rf.base_field.mlp))))
    bf = m.background.field
    background = rp(m.background, field=rp(
        bf, base_output_dim=128, base_field=rp(bf.base_field, mlp=_narrow(bf.base_field.mlp))))
    heads = tuple((k, rp(h, mlp=_narrow(h.mlp))) for k, h in m.heads)
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


JCFG = tiny(jmethods, jsamplers, jslot)
TCFG = tiny(tmethods, tsamplers, tslot)
STEP = 15000  # active level 2 of 3 and a nonzero curvature weight
DATA = dict(num_views=3, height=8, width=8, raw=True)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _groups(keys):
    """Parameter keys grouped by module: the table, the variance, and every
    MLP (the parent path of its layer_* parameters)."""
    out = {}
    for k in keys:
        parts = k.split(".")
        if parts[-1] == "table":
            g = "table"
        elif parts[0] == "variance":
            g = "variance"
        else:
            g = ".".join(p for p in parts[:-1] if not p.startswith("layer_"))
        out.setdefault(g, []).append(k)
    return out


def _perturbed(params, seed=0):
    """The init moved by seeded numpy noise, so that every parameter
    matters: the geometric init zeroes the SDF chain's weights on the grid
    features (which would leave the table without gradient), and the table
    starts at +-1e-4 (scaled up 1e4)."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        if path[-1] == "table":
            return jnp.asarray(a * 1e4)
        if path[-1] == "kernel":
            a = a + (0.2 / np.sqrt(a.shape[0]) * rng.normal(size=a.shape)).astype(np.float32)
        elif path[-1] in ("bias", "g"):
            a = a + (0.05 * rng.normal(size=a.shape)).astype(np.float32)
        elif path[0] == "camera_poses":
            a = a + (0.01 * rng.normal(size=a.shape)).astype(np.float32)
        return jnp.asarray(a)

    return walk(params, ())


def numpy_batch(dataset, num_rays, seed):
    """UniformPixelSampler(dataset, num_rays, seed=seed).sample() with its draws made by the
    sampler's plain version (data/native.py's numpy branch): the batches the comparisons
    with JAX in these files were written on."""
    plain = functools.partial(native.sample_pixels, plain=True)
    with mock.patch.object(native, "sample_pixels", plain):
        return UniformPixelSampler(dataset, num_rays, seed=seed).sample()


@pytest.fixture(scope="module")
def slice_run():
    """One batch through both packages' loss-and-gradient functions."""
    return run_slice()


def run_slice(sample=numpy_batch, seed=5):
    """The batch `sample(dataset, rays, seed)` draws through both packages'
    loss-and-gradient functions."""
    jds = jmake_dataset(MODS, **DATA)
    tds = tmake_dataset(MODS, **DATA, device="cpu")
    num_cameras = {m: jds.data[m].cameras.camera_to_worlds.shape[0] for m in MODS}
    jm = jmodel.MMSModel(JCFG.model)
    with mock.patch.object(jm, "init", functools.partial(compiled_init, jm.init)):
        jstate = jtrain.init_train_state(JCFG, jm, jax.random.key(0), num_cameras)
    jstate = jstate.replace(params=_perturbed(jstate.params))
    model = tmodel.MMSModel(TCFG.model, device="cpu")
    carried = params_from_jax(jax.tree.map(np.asarray, jstate.params), model)
    model.load_state_dict(carried["model"])
    state = ttrain.init_train_state(TCFG, model, carried["camera_poses"], step=STEP)

    tbatch = sample(tds, TCFG.datamanager.num_rays_per_modality, seed)
    jbatch = {m: JPixelBatch(
        camera_indices=jnp.asarray(b.camera_indices.numpy().astype(np.int32)),
        pixel_coords=jnp.asarray(b.pixel_coords.numpy()), pixels=jnp.asarray(b.pixels.numpy()),
        mosaick_channel=jnp.asarray(b.mosaick_channel.numpy())) for m, b in tbatch.items()}
    jcams = {m: jds.data[m].cameras for m in MODS}
    grid = JCFG.model.surface.surface_field.field.grid
    step = jnp.asarray(STEP)
    jtotal, jlo, jmet, jgrads = jtrain._batch_loss_and_grads(
        JCFG, jm, jcams, grid, jstate.params, jbatch, step, jtrain.make_schedules(JCFG, step),
        jax.random.key(1), jax.random.key(2))
    tcams = {m: tds.data[m].cameras for m in MODS}
    ttotal, tlo, tmet, tgrads = ttrain.batch_loss_and_grads(
        TCFG, model, tcams, state.camera_poses, tbatch, STEP, ttrain.make_schedules(TCFG, STEP))
    return dict(j=(jtotal, jlo, jmet, jgrads), t=(ttotal, tlo, tmet, tgrads), model=model,
                state=state, tbatch=tbatch, tcams=tcams, tds=tds)


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
    _, _, _, jgrads = slice_run["j"]
    _, _, _, tgrads = slice_run["t"]
    jflat = _flatten(jgrads["model"])
    assert set(jflat) == set(tgrads["fields"])
    groups = _groups(jflat)
    assert {"table", "variance", "surface_field.field.grid_mlp.mlp_head",
            "radiance_field.base_field.mlp", "heads.polarization.field",
            "background_field.base_field.mlp"} <= set(groups)
    for name, keys in groups.items():
        ref = np.concatenate([jflat[k].ravel() for k in keys])
        got = np.concatenate([tgrads["fields"][k].numpy().ravel() for k in keys])
        assert np.linalg.norm(ref) > 0, name
        assert rel_l2(got, ref) <= 3e-2, (name, rel_l2(got, ref))
    for mod in MODS:
        ref = np.asarray(jgrads["camera_poses"][mod])
        got = tgrads["camera_poses"][mod].numpy()
        assert rel_l2(got, ref) <= 3e-2, (mod, rel_l2(got, ref))


def test_train_step_matches_jax_loss(slice_run):
    """A full step through make_train_step: the same loss as the gradient
    run above and one applied update. Its learning rate reads the update
    count before the increment, 0, where the warm-up factor is 0, so the
    parameters stay (weight decay is scaled by the learning rate too) while
    the moments take the gradient, as optax does."""
    model, state = slice_run["model"], slice_run["state"]
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    step_fn = ttrain.make_train_step(TCFG, model, slice_run["tcams"])
    state, aux = step_fn(state, slice_run["tbatch"])
    jtotal = float(slice_run["j"][0])
    assert abs(float(aux["losses"]["total_loss"]) - jtotal) <= 1e-2 * abs(jtotal)
    assert aux["metrics"]["grads_finite"] == 1.0
    assert state.step == STEP + 1 and state.opt_state.count == 1
    assert all(torch.equal(p, before[k]) for k, p in model.named_parameters())
    mu = state.opt_state.mu["fields"]
    assert all(float(mu[k].abs().max()) > 0 for k in mu)


def test_device_cache_sampling_quantises_and_draws_in_range():
    tds = tmake_dataset(MODS, **DATA, device="cpu")
    cache = build_device_cache(tds, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = sample_pixel_batch(cache, gen, 64, MODS)
    for m in MODS:
        b, d = batch[m], tds.data[m]
        f = b.camera_indices
        y = (b.pixel_coords[:, 0] - d.cameras.pixel_offset).long()
        x = (b.pixel_coords[:, 1] - d.cameras.pixel_offset).long()
        assert int(f.max()) < d.images.shape[0] and int(y.max()) < 8 and int(x.max()) < 8
        ref = d.images[f.numpy(), y.numpy(), x.numpy()]
        # uint16 quantisation: within half a step of 1/65535
        assert np.abs(b.pixels.numpy() - ref).max() <= 0.5 / 65535 + 1e-7
        np.testing.assert_array_equal(b.mosaick_channel.numpy(),
                                      d.mosaick_mask[y.numpy(), x.numpy()])


def test_stratified_sampling_jitters_within_bins():
    """With a generator and train_stratified, bins move inside their
    half-bin neighbourhoods and stay sorted; without one they do not move."""
    gen = torch.Generator().manual_seed(0)
    bins = tsamplers.linspace(0.0, 1.0, 9, torch.zeros(1))[None].expand(5, 9)
    jit = tsamplers.stratify_bins(bins, gen, single_jitter=False)
    assert (jit[:, 1:] >= jit[:, :-1]).all()
    half = 0.5 / 8
    assert ((jit - bins).abs() <= half + 1e-6).all() and not torch.equal(jit, bins)
    spec = tsamplers.SpacedSamplerSpec(num_samples=8)
    from multimodalstudio_tpu_torch.core.rays import RayBundle

    rays = RayBundle(origins=torch.zeros(5, 3), directions=torch.ones(5, 3) / 3**0.5,
                     up_directions=torch.zeros(5, 3), pixel_area=torch.ones(5, 1),
                     camera_indices=torch.zeros(5, dtype=torch.long),
                     directions_norm=torch.ones(5, 1), nears=torch.full((5, 1), 0.5),
                     fars=torch.full((5, 1), 2.0))
    fixed = tsamplers.spaced_sampling(rays, spec, train=True)
    drawn = tsamplers.spaced_sampling(rays, spec, generator=gen, train=True)
    assert torch.equal(fixed.spacing_starts, bins[:, :-1])
    assert not torch.equal(drawn.spacing_starts, fixed.spacing_starts)


def test_train_steps_sample_on_the_device_and_step(slice_run):
    """make_train_steps on a CPU cache: two steps with pixel draws and the
    samplers' stratified jitter from one generator, finite losses, both
    updates applied (count 2) and the step advanced."""
    rp = dataclasses.replace
    cfg = rp(TCFG, model=rp(TCFG.model,
                            ray_sampler=rp(TCFG.model.ray_sampler, train_stratified=True),
                            background_ray_sampler=rp(TCFG.model.background_ray_sampler,
                                                      train_stratified=True)))
    model = tmodel.MMSModel(cfg.model, device="cpu")
    model.load_state_dict(slice_run["model"].state_dict())
    state = ttrain.init_train_state(cfg, model, slice_run["state"].camera_poses, step=STEP)
    cache = build_device_cache(slice_run["tds"], device="cpu")
    steps = ttrain.make_train_steps(cfg, model, slice_run["tcams"])
    state, aux = steps(state, cache, torch.Generator().manual_seed(1), 2)
    assert state.step == STEP + 2 and state.opt_state.count == 2
    assert aux["metrics"]["grads_finite"] == 1.0
    assert all(torch.isfinite(torch.as_tensor(v)).all() for v in aux["losses"].values())
