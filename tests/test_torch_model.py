"""The port's grid_raw_tpu eval forward and RawEvaluator against the JAX
package, through convert.params_from_jax.

A tiny grid_raw_tpu (the small slot grid and light sampler of
__graft_entry__.py, hidden widths 128) is initialised by the JAX package,
perturbed from a numpy seed so that every parameter matters (the table
scaled up 1e4, the geometric init's zero rows filled in), carried across,
and rendered by both on the same rays, with the Pallas kernels in interpret
mode on the JAX side. Both sides round to bf16 at the same points; they
differ by f32 summation order, which now and then flips the bf16 rounding
of an activation; down a chain of bf16 layers those flips grow to rel-L2
~1e-3 in the radiance (~1e-5 in geometry). Tolerance: rel-L2 <= 1e-2 per
output.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multimodalstudio_tpu.configs.methods as jmethods
import multimodalstudio_tpu.models.model as jmodel
import multimodalstudio_tpu.models.samplers as jsamplers
import multimodalstudio_tpu.ops.pallas.slot_grid as jslot
from multimodalstudio_tpu.cameras.cameras import generate_rays as jgenerate_rays
from multimodalstudio_tpu.data.synthetic import make_synthetic_dataset as jmake_dataset
from multimodalstudio_tpu.engine import evaluator as jevaluator
from multimodalstudio_tpu.engine.train import TrainState as JTrainState
from multimodalstudio_tpu.engine.train import make_schedules as jmake_schedules

import multimodalstudio_tpu_torch.configs.methods as tmethods
import multimodalstudio_tpu_torch.models.model as tmodel
import multimodalstudio_tpu_torch.models.samplers as tsamplers
import multimodalstudio_tpu_torch.ops.kernels.slot_grid as tslot
from multimodalstudio_tpu_torch.convert import params_from_jax
from multimodalstudio_tpu_torch.core.rays import RayBundle
from multimodalstudio_tpu_torch.data.synthetic import make_synthetic_dataset as tmake_dataset
from multimodalstudio_tpu_torch.engine import evaluator as tevaluator
from multimodalstudio_tpu_torch.engine.train import TrainState, make_schedules

torch.set_num_threads(1)

REL = 1e-2
MODS = ("rgb", "polarization", "mono")


def rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _narrow(mlp):
    return dataclasses.replace(mlp, hidden_dim=128) if mlp.hidden_dim == 256 else mlp


def tiny(methods, model_mod, samplers, slot):
    """grid_raw_tpu cut to CPU size, built from one package's own classes."""
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
                                             num_upsample_steps=2),
        background_ray_sampler=samplers.SpacedSamplerSpec(num_samples=4, spacing="lin_disparity"),
    )
    ev = rp(cfg.evaluator, eval_num_rays_per_chunk=96)
    return rp(cfg, model=model, modalities=MODS, evaluator=ev)


JCFG = tiny(jmethods, jmodel, jsamplers, jslot)
TCFG = tiny(tmethods, tmodel, tsamplers, tslot)


def perturbed_params(seed=0):
    """JAX init, then every leaf moved by seeded numpy noise."""
    rng = np.random.default_rng(seed)
    params = jmodel.MMSModel(JCFG.model).init(jax.random.key(seed))

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        if path[-1] == "table":
            return a * 1e4
        if path[-1] == "kernel":
            return a + (0.2 / np.sqrt(a.shape[0]) * rng.normal(size=a.shape)).astype(np.float32)
        if path[-1] in ("bias", "g"):
            return a + (0.05 * rng.normal(size=a.shape)).astype(np.float32)
        return a

    model = walk(dict(params), ())
    poses = {m: (0.01 * rng.normal(size=(1, 6))).astype(np.float32) for m in MODS}
    return {"model": model, "camera_poses": poses}


@pytest.fixture(scope="module")
def carried():
    tree = perturbed_params()
    model = tmodel.MMSModel(TCFG.model, device="cpu")
    state = params_from_jax(tree, model)
    model.load_state_dict(state["model"])
    return tree, model, state


def test_convert_rejects_missing_and_extra_keys(carried):
    tree, model, _ = carried
    broken = {"model": dict(tree["model"]), "camera_poses": tree["camera_poses"]}
    broken["model"].pop("variance")
    with pytest.raises(KeyError, match="missing"):
        params_from_jax(broken, model)
    broken["model"]["variance"] = tree["model"]["variance"]
    broken["model"]["stray"] = np.zeros(3)
    with pytest.raises(KeyError, match="extra"):
        params_from_jax(broken, model)


def test_eval_forward_matches_jax(carried):
    tree, model, _ = carried
    jds = jmake_dataset(MODS[:1], num_views=4, height=12, width=12)
    cams = jds.data[MODS[0]].cameras
    rng = np.random.default_rng(1)
    n = 48
    idx = rng.integers(0, 4, size=n).astype(np.int32)
    coords = (rng.uniform(0, 12, size=(n, 2))).astype(np.float32)
    jrays = jgenerate_rays(cams, jnp.asarray(idx), jnp.asarray(coords))
    step = 15000  # active level 2 of 3: the coarse-to-fine mask is live
    jm = jmodel.MMSModel(JCFG.model)
    jout = jax.jit(
        lambda p, r: jm.forward(p, r, ((MODS[0], n),), jmake_schedules(JCFG, jnp.asarray(step)), None,
                                train=False, aligned=True)
    )(tree["model"], jrays)
    trays = RayBundle(**{
        f.name: None if getattr(jrays, f.name) is None
        else torch.tensor(np.asarray(getattr(jrays, f.name)))
        for f in dataclasses.fields(RayBundle)
    })
    tout = model.forward(trays, ((MODS[0], n),), make_schedules(TCFG, step), aligned=True)
    assert set(tout) == set(jout)
    for key in jout:
        assert tout[key].shape == jout[key].shape, key
        assert rel_l2(tout[key].numpy(), jout[key]) <= REL, key


def test_raw_evaluator_matches_jax(carried):
    tree, model, state = carried
    kw = dict(num_views=3, height=8, width=8, raw=True)
    jds = jmake_dataset(MODS, **kw)
    tds = tmake_dataset(MODS, **kw, device="cpu")
    jm = jmodel.MMSModel(JCFG.model)
    jev = jevaluator.RawEvaluator(JCFG, jm, jds, jds)
    tev = tevaluator.RawEvaluator(TCFG, model, tds, tds, device="cpu")
    step = JCFG.max_num_iterations
    jstate = JTrainState(params={"model": tree["model"], "camera_poses": tree["camera_poses"]},
                         opt_state=None, step=jnp.asarray(step))
    tstate = TrainState(camera_poses=state["camera_poses"], step=step)
    for mod in ("polarization", "rgb"):
        jframes = jev.render_view(jstate, jds, mod, 1)
        tframes = tev.render_view(tstate, tds, mod, 1)
        assert set(tframes) == set(jframes)
        for key in jframes:
            assert tframes[key].shape == jframes[key].shape, key
            assert rel_l2(tframes[key], jframes[key]) <= REL, (mod, key)
        jm_ = jev.view_metrics(jframes, mod)
        tm_ = tev.view_metrics(tframes, mod)
        assert set(tm_) == set(jm_)
        for key in jm_:
            assert abs(tm_[key] - jm_[key]) <= 1e-3 * max(1.0, abs(jm_[key])), (mod, key)


@pytest.mark.parametrize("max_views", [None, "2"])
def test_eval_max_views_matches_jax(carried, monkeypatch, max_views):
    """MMS_EVAL_MAX_VIEWS = K scores the first K eval views of each modality
    in both evaluators (unset: every view). render_view and view_metrics are
    stubbed to record the views scored, so the test holds the evaluators'
    view loops, not the renders (test_raw_evaluator_matches_jax holds those)."""
    _, model, state = carried
    if max_views is None:
        monkeypatch.delenv("MMS_EVAL_MAX_VIEWS", raising=False)
    else:
        monkeypatch.setenv("MMS_EVAL_MAX_VIEWS", max_views)
    kw = dict(num_views=4, height=8, width=8, raw=True)
    jds = jmake_dataset(MODS, **kw)
    tds = tmake_dataset(MODS, **kw, device="cpu")
    scored = {}
    for name, ev in (("jax", jevaluator.RawEvaluator(JCFG, jmodel.MMSModel(JCFG.model), jds, jds)),
                     ("port", tevaluator.RawEvaluator(TCFG, model, tds, tds, device="cpu"))):
        seen = scored.setdefault(name, [])
        monkeypatch.setattr(ev, "render_view",
                            lambda st, ds, mod, fi, seen=seen: seen.append((mod, fi)) or (mod, fi))
        monkeypatch.setattr(ev, "view_metrics",
                            lambda frames, mod: {"psnr": float(frames[1]), "ssim": 1.0})
        scored[name + " results"] = ev.render_all_eval_views(state)
    views = jds.num_frames(MODS[0]) if max_views is None else int(max_views)
    assert scored["port"] == scored["jax"] == [(m, fi) for m in MODS for fi in range(views)]
    assert scored["port results"] == scored["jax results"]
