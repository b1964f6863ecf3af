"""The spec options no registered method sets, in the port against the JAX
package: the near_far and box colliders, VolSDF (the Laplace density and
exponential-transmittance weights), random background colours, and the
adam and radam optimizer groups with optax's state carried.

The model is tests/test_torch_grid_reference.py's cut of grid_raw (4 hash
levels, MLPs 32 wide, 8+8 NeuS samples without jitter, 3 modalities), its
parameters carried through convert.params_from_jax, with the options set
on both packages' ModelSpec. JAX's random colours come from its own
stream, which torch cannot reproduce, so they are injected: in eval the
port is fed JAX's draw (jax.random.uniform of key(0), the key JAX's eval
uses), in training both packages take the same seeded numpy colours.

Tolerances: colliders and the density functions rel 1e-6 (float32 on
both sides, the same operations; the densities with an absolute floor
of 1e-6 of their largest value, where 0.5 + 0.5 expm1(-x) cancels); eval
outputs rel-L2 <= 1e-3 and a batch's losses rel 1e-4, each gradient group
max(1e-3, twice the port's 1e-6 noise), as the reference methods' tests
state them; the VolSDF/box training batch holds its losses and every field
group so, and each modality's camera-pose gradient within 1.64e-1, twice
8.2e-2: JAX's microbatch loop is a lax.scan, whose body XLA compiles, and
on this batch compiled JAX parts from eager JAX by 8.2e-2 on the rgb
camera-pose gradient (jit against eager moves one mono ray's position
gradient by 1e-2), while the port agrees with eager JAX's two
microbatches summed to 9.4e-6, and with eager JAX's cotangents of the
batch's ray origins and directions through the forward to 9.4e-6 and
5.3e-6 (readings taken while writing this test; eager JAX takes 73-110 s
here, too slow for this file); against compiled JAX the port reads
3.8e-3 (mono), 4.9e-2 (polarization) and 5.9e-2 (rgb). Optimizer
updates
and moments rel-L2 <= 1e-5 per leaf over 8 updates (optax computes the
learning rate in float32, the port in float64); optax's moments carried
bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multimodalstudio_tpu.configs.config as jconfig
import multimodalstudio_tpu.core.rays as jrays
import multimodalstudio_tpu.engine.train as jtrain
import multimodalstudio_tpu.models.colliders as jcolliders
import multimodalstudio_tpu.models.model as jmodel
import multimodalstudio_tpu.models.volume_rendering as jvr
from multimodalstudio_tpu.core.rays import RayBundle as JRayBundle

import multimodalstudio_tpu_torch.configs.config as tconfig
import multimodalstudio_tpu_torch.core.rays as trays
import multimodalstudio_tpu_torch.engine.train as ttrain
import multimodalstudio_tpu_torch.models.colliders as tcolliders
import multimodalstudio_tpu_torch.models.model as tmodel
import multimodalstudio_tpu_torch.models.volume_rendering as tvr
from multimodalstudio_tpu_torch.convert import opt_state_from_jax
from multimodalstudio_tpu_torch.core.rays import RayBundle as TRayBundle

from test_torch_grid_reference import (
    GRAD_FLOOR,
    STEP,
    assert_losses_match,
    assert_outputs_match,
    batch_run,
    carry,
    configs,
    eval_forward,
    rays,
)
from test_torch_mlp_raw import _flatten, rel_l2
from test_torch_train import _groups

torch.set_num_threads(1)

BOX = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
NEAR_FAR = (0.05, 4.0)
# the VolSDF/box batch's camera-pose gradients against compiled JAX: twice the 8.2e-2 by which
# compiled JAX parts from eager JAX on that batch (module docstring)
POSE_LIMIT = 1.64e-1


# ------------------------------------------------------------- colliders

def random_rays(n=256, seed=0):
    """Rays from origins in [-3, 3]^3, a quarter of them axis-parallel
    (two direction components zero, or a tiny negative one that the box
    collider turns into +1e-9)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    axis = rng.integers(0, 3, size=n // 4)
    d[: n // 4] = 0.0
    d[np.arange(n // 4), axis] = rng.choice([-1.0, 1.0], size=n // 4)
    d[: n // 8, (axis[: n // 8] + 1) % 3] = -1e-12
    d = d.astype(np.float32)
    z = np.zeros((n, 1), np.float32)
    fields = dict(origins=o, directions=d, up_directions=d, pixel_area=z + 1,
                  camera_indices=np.zeros(n, np.int32), directions_norm=z + 1)
    return (JRayBundle(**{k: jnp.asarray(v) for k, v in fields.items()}),
            TRayBundle(**{k: torch.from_numpy(v) for k, v in fields.items()}))


@pytest.mark.parametrize("collider", ["near_far", "box"])
def test_colliders_match_jax(collider):
    jr, tr = random_rays()
    if collider == "near_far":
        jout, jmask = jcolliders.near_far_collide(jr, *NEAR_FAR)
        tout, tmask = tcolliders.near_far_collide(tr, *NEAR_FAR)
    else:
        jout, jmask = jcolliders.box_collide(jr, BOX)
        tout, tmask = tcolliders.box_collide(tr, BOX)
    assert np.array_equal(tmask.numpy(), np.asarray(jmask))
    if collider == "box":
        assert 0 < float(tmask.sum()) < len(tmask)
    for name in ("nears", "fars"):
        np.testing.assert_allclose(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                                   rtol=1e-6, err_msg=name)


def test_density_functions_match_jax():
    rng = np.random.default_rng(1)
    sdf = rng.normal(scale=0.3, size=(16, 24)).astype(np.float32)
    sdf.setflags(write=True)
    sdf[0, :4] = 0.0
    deltas = rng.uniform(0.0, 0.1, size=(16, 24)).astype(np.float32)
    beta, inv_s = np.float32(0.05), np.float32(20.0)
    dens = np.asarray(jvr.laplace_density(jnp.asarray(sdf), jnp.asarray(beta), 1e-4))
    pairs = [
        (tvr.laplace_density(torch.from_numpy(sdf), torch.tensor(beta), 1e-4), dens),
        (tvr.neus_s_density(torch.from_numpy(sdf), torch.tensor(inv_s)),
         jvr.neus_s_density(jnp.asarray(sdf), jnp.asarray(inv_s))),
        (trays.weights_from_densities(torch.from_numpy(deltas), torch.from_numpy(dens)),
         jrays.weights_from_densities(jnp.asarray(deltas), jnp.asarray(dens))),
        (trays.alphas_from_densities(torch.from_numpy(deltas), torch.from_numpy(dens)),
         jrays.alphas_from_densities(jnp.asarray(deltas), jnp.asarray(dens))),
    ]
    for i, (got, ref) in enumerate(pairs):
        # absolute floor 1e-6 of the largest value: 0.5 + 0.5 * expm1(-x) cancels in float32
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max(),
                                   err_msg=str(i))


# ---------------------------------------------------------------- the model

@pytest.fixture(scope="module")
def base():
    return carry(*configs(method="grid_raw"))


def with_options(c, rendering="neus", **options):
    """c with the surface's `rendering` and `options` set on both
    packages' ModelSpec (the same parameters)."""

    def spec(m):
        return dataclasses.replace(
            m, surface=dataclasses.replace(m.surface, rendering=rendering), **options)

    jcfg = dataclasses.replace(c["jcfg"], model=spec(c["jcfg"].model))
    tcfg = dataclasses.replace(c["tcfg"], model=spec(c["tcfg"].model))
    model = tmodel.MMSModel(tcfg.model, device="cpu")
    params = c["params"]
    if not tcfg.model.use_background:  # the background field's parameters go with it
        params = dict(params, model={k: v for k, v in params["model"].items()
                                     if not k.startswith("background_")})
    model.load_state_dict({k: v for k, v in c["model"].state_dict().items()
                           if k.split(".")[0] in params["model"]})
    return dict(c, jcfg=jcfg, tcfg=tcfg, jm=jmodel.MMSModel(jcfg.model), model=model,
                params=params)


@pytest.mark.parametrize("collider", ["sphere", "near_far", "box"])
def test_volsdf_eval_render_matches_jax(base, collider):
    c = with_options(base, "volsdf", collider_type=collider, near_far=NEAR_FAR, aabb=BOX)
    jout, tout = eval_forward(c)
    assert_outputs_match(jout, tout)
    if collider != "sphere":
        assert float(tout["mask"].sum()) > 0


def test_random_background_eval_matches_jax_on_its_draw(base):
    """JAX draws the eval colours from key(0), one draw of each
    modality's shape; the port, fed that draw, renders what JAX does."""
    c = with_options(base, background_color="random")
    fed = []

    def jax_draw(mod, like, generator):
        fed.append(mod)
        return torch.from_numpy(np.asarray(jax.random.uniform(jax.random.key(0), like.shape)))

    c["model"].random_background_color = jax_draw
    jout, tout = eval_forward(c)
    assert fed == [m for m, _ in c["tcfg"].model.modalities]
    assert_outputs_match(jout, tout)


def test_random_background_draws_from_the_generator(base):
    """Eval colours come from a generator seeded 0 (every render the
    same), training's from the step's generator; uniform in [0, 1)."""
    c = with_options(base, background_color="random")
    model, like = c["model"], torch.zeros(6, 3)
    seen = []
    orig = model.random_background_color
    model.random_background_color = lambda mod, x, g: seen.append(orig(mod, x, g)) or seen[-1]
    _, trays = rays(c["jds"], 16, 1)
    render = lambda: model(trays, (("rgb", 16),), ttrain.make_schedules(c["tcfg"], STEP),  # noqa: E731
                           aligned=True)
    first = render()
    n_eval = len(seen)
    again = render()
    assert all(torch.equal(a, b) for a, b in zip(seen[:n_eval], seen[n_eval:]))
    assert all(torch.equal(first[k], again[k]) for k in first)
    gen = torch.Generator().manual_seed(3)
    a = orig("rgb", like, gen)
    b = orig("rgb", like, gen)
    assert not torch.equal(a, b) and float(a.min()) >= 0.0 and float(a.max()) < 1.0


def injected_colours(mod, shape):
    seed = sum(map(ord, mod)) + 7 * int(np.prod(shape))
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def label_batch(base):
    """One training batch of the card's label: VolSDF, the box collider,
    random background colours (injected on both sides), which take the
    background field's place, so the label has none: its parameters
    would have no gradient."""
    c = with_options(base, "volsdf", collider_type="box", aabb=BOX, background_color="random",
                     use_background=False)
    c["model"].random_background_color = lambda mod, like, generator: torch.from_numpy(
        injected_colours(mod, tuple(like.shape)))
    orig = jmodel.MMSModel._background_color

    def jax_colours(self, mod, background, shape, rng=None):
        if self.spec.background_color == "random":
            return jnp.asarray(injected_colours(mod, tuple(shape)))
        return orig(self, mod, background, shape, rng)

    jmodel.MMSModel._background_color = jax_colours
    try:
        return batch_run(c, 5)
    finally:
        jmodel.MMSModel._background_color = orig


def test_volsdf_box_random_batch_losses_match_jax(label_batch):
    assert_losses_match(label_batch)


def test_volsdf_box_random_batch_field_gradients_match_jax(label_batch):
    """Every field group (each hash table its own) within max(1e-3, twice
    the port's noise) of JAX's."""
    jflat = _flatten(label_batch["j"][3]["model"])
    tgrads = label_batch["t"][3]["fields"]
    assert set(jflat) == set(tgrads)
    groups = {}
    for k in jflat:
        parts = k.split(".")
        groups.setdefault(".".join(parts[:-1]) if parts[-1] == "table" else
                          next(iter(_groups([k]))), []).append(k)
    assert "variance" in groups
    for name, keys in groups.items():
        def cat(fields):
            return np.concatenate([fields[k].numpy().ravel() for k in keys])
        ref = np.concatenate([jflat[k].ravel() for k in keys])
        got = cat(tgrads)
        assert np.linalg.norm(ref) > 0, name
        noise = max(rel_l2(cat(m["fields"]), got) for m in label_batch["moved"])
        assert rel_l2(got, ref) <= max(GRAD_FLOOR, 2 * noise), (name, rel_l2(got, ref), noise)


def test_volsdf_box_random_batch_pose_gradients_match_compiled_jax(label_batch):
    """Each modality's camera-pose gradient within POSE_LIMIT of compiled
    JAX's (module docstring: compiled JAX parts from eager JAX by 8.2e-2
    on rgb's, the port agrees with eager JAX to 9.4e-6)."""
    jposes, tposes = label_batch["j"][3]["camera_poses"], label_batch["t"][3]["camera_poses"]
    assert set(jposes) == set(tposes)
    for mod in jposes:
        ref = np.asarray(jposes[mod])
        assert np.linalg.norm(ref) > 0, mod
        err = rel_l2(tposes[mod].numpy(), ref)
        assert err <= POSE_LIMIT, (mod, err)


# ------------------------------------------------------------ the optimizer

def optimizer_configs(fields, poses, max_iters=12):
    """Both packages' configs with the fields group on `fields` and the
    camera poses on `poses`; the multistep warm-up schedule ends its
    warm-up at step 1 and drops at steps past 6."""
    out = []
    for cmod in (jconfig, tconfig):
        cfg = cmod.load_config(method="grid_raw")
        spec = dict(cfg.optimizers)
        opts = (("fields", dataclasses.replace(spec["fields"], optimizer=fields, lr=1e-2)),
                ("camera_poses", dataclasses.replace(spec["camera_poses"], optimizer=poses,
                                                     lr=3e-3)))
        out.append(dataclasses.replace(cfg, optimizers=opts, max_num_iterations=max_iters))
    return out


@pytest.mark.parametrize("fields,poses", [("adam", "adam"), ("radam", "radam"),
                                          ("radam", "adam"), ("adamw", "radam")])
def test_optimizer_groups_match_optax_over_eight_updates(fields, poses):
    jcfg, tcfg = optimizer_configs(fields, poses)
    rng = np.random.default_rng(11)
    shapes = {"fields": {"a.kernel": (5, 4), "a.bias": (4,), "b": (7,)},
              "camera_poses": {"rgb": (3, 6), "mono": (2, 6)}}
    init = {g: {k: rng.normal(size=s).astype(np.float32) for k, s in leaves.items()}
            for g, leaves in shapes.items()}

    def jtree(flat):
        return {"model": {"a": {"kernel": jnp.asarray(flat["fields"]["a.kernel"]),
                                "bias": jnp.asarray(flat["fields"]["a.bias"])},
                          "b": jnp.asarray(flat["fields"]["b"])},
                "camera_poses": {m: jnp.asarray(v) for m, v in flat["camera_poses"].items()}}

    def jflat(tree):
        m = tree["model"]
        return {"fields": {"a.kernel": m["a"]["kernel"], "a.bias": m["a"]["bias"], "b": m["b"]},
                "camera_poses": tree["camera_poses"]}

    tx = jtrain.make_optimizer(jcfg)
    jparams = jtree(init)
    jstate = tx.init(jparams)
    opt = ttrain.make_optimizer(tcfg)
    tparams = {g: {k: torch.from_numpy(v.copy()) for k, v in leaves.items()}
               for g, leaves in init.items()}
    tstate = opt.init(tparams)
    for step in range(8):
        scale = 3.0 if step in (2, 5) else 0.3  # steps 2 and 5 clip
        grads = {g: {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in leaves.items()}
                 for g, leaves in shapes.items()}
        jup, jstate = tx.update(jtree(grads), jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, jup)
        tup, tstate = opt.update({g: {k: torch.from_numpy(v) for k, v in leaves.items()}
                                  for g, leaves in grads.items()}, tstate, tparams)
        for g in shapes:
            for k in shapes[g]:
                ref = np.asarray(jflat(jup)[g][k])
                assert rel_l2(tup[g][k].numpy(), ref) <= 1e-5, (step, g, k)
                tparams[g][k] = tparams[g][k] + tup[g][k]
        inner = {g: s.inner_state[0] for g, s in jstate[1].inner_states.items()}
        for g, jg in (("fields", "model"), ("camera_poses", "camera_poses")):
            for name in ("mu", "nu"):
                ref = jflat({"model": getattr(inner["fields"], name)["model"],
                             "camera_poses": getattr(inner["camera_poses"], name)["camera_poses"]})
                for k in shapes[g]:
                    got = getattr(tstate, name)[g][k].numpy()
                    assert rel_l2(got, np.asarray(ref[g][k])) <= 1e-5, (step, name, g, k)
    assert tstate.count == 8
    radam = [group for name, group in opt.groups if group.kind == "radam"]
    for group in radam:  # the rectified step takes over at update 6 (b2 = 0.999)
        assert [group.radam_scale(t, "cpu") is None for t in range(1, 9)] == [True] * 5 + [False] * 3


def test_opt_state_from_jax_takes_adam_and_radam_chains(base):
    jcfg, _ = optimizer_configs("adam", "radam")
    tx = jtrain.make_optimizer(jcfg)
    params = base["params"]
    for group in ("fields", "camera_poses"):  # no add_decayed_weights entry
        assert len(tx.init(params)[1].inner_states[group].inner_state) == 2

    opt_state = tx.init(params)
    rng = np.random.default_rng(3)
    update = jax.jit(tx.update)  # eager, its first call compiles every primitive (15 s)
    for _ in range(2):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)),
                             params)
        updates, opt_state = update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
    state = jtrain.TrainState(params=params, opt_state=opt_state, step=jnp.asarray(2))
    opt = opt_state_from_jax(jax.tree.map(np.asarray, state.opt_state), base["model"])
    assert opt["count"] == 2
    inner = {g: s.inner_state[0] for g, s in state.opt_state[1].inner_states.items()}
    for name in ("mu", "nu"):
        flat = _flatten(getattr(inner["fields"], name)["model"])
        assert set(flat) == set(opt[name]["fields"])
        for k, v in flat.items():
            assert np.array_equal(opt[name]["fields"][k].numpy(), v), (name, k)
        for m, v in getattr(inner["camera_poses"], name)["camera_poses"].items():
            assert np.array_equal(opt[name]["camera_poses"][m].numpy(), np.asarray(v)), (name, m)
