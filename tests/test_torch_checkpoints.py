"""The port's torch checkpoints (engine/checkpoints.py) and the carrying of
the JAX package's optax state (convert.opt_state_from_jax).

On the tiny grid_raw_tpu of tests/test_torch_train.py: save, the newest
step, load into a fresh model and state (every tensor equal, the next
step), the pruning of older steps, a weights file (no optimizer state)
that loads for evaluation and that Trainer.train() refuses by name.

Then a small JAX TrainState, moved by two optax updates, saved with JAX's
save_checkpoint under tmp_path and restored with its load_checkpoint: the
port's optimizer state from the restored numpy tree equals it leaf for leaf,
bit for bit, and one update of the port's optimizer from it matches
optax's update on the same numpy gradients to 1e-6 relative per leaf (the
limit tests/test_torch_train.py holds the optimizer to).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multimodalstudio_tpu.engine.checkpoints as jckpt
import multimodalstudio_tpu.engine.train as jtrain

import multimodalstudio_tpu_torch.engine.checkpoints as tckpt
import multimodalstudio_tpu_torch.engine.train as ttrain
from multimodalstudio_tpu_torch.cameras.camera_optimizer import init_camera_poses
from multimodalstudio_tpu_torch.convert import opt_state_from_jax, params_from_jax
from multimodalstudio_tpu_torch.data.synthetic import make_synthetic_dataset
from multimodalstudio_tpu_torch.engine.trainer import Trainer
from multimodalstudio_tpu_torch.models.model import MMSModel

from test_torch_train import DATA, JCFG, MODS, TCFG, rel_l2

torch.set_num_threads(1)


def port_state(seed=0, step=7):
    """A tiny model with drawn parameters and a train state whose pose
    tangents and moments are nonzero."""
    gen = torch.Generator().manual_seed(seed)
    model = MMSModel(TCFG.model, device="cpu").init(gen)
    poses = init_camera_poses(TCFG.datamanager.camera_optimizer, MODS, {m: 3 for m in MODS},
                              device="cpu")
    state = ttrain.init_train_state(TCFG, model, poses, step=step)
    with torch.no_grad():
        for p in state.camera_poses.values():
            p.copy_(torch.randn(p.shape, generator=gen))
        for moments in (state.opt_state.mu, state.opt_state.nu):
            for group in moments.values():
                for v in group.values():
                    v.copy_(torch.rand(v.shape, generator=gen))
    state.opt_state.count = step
    return model, state


def test_save_load_round_trip_and_latest_step(tmp_path):
    model, state = port_state()
    path = tckpt.save_checkpoint(str(tmp_path), model, state)
    assert os.path.basename(path) == "step-000000007.pt"
    assert tckpt.latest_checkpoint_step(str(tmp_path)) == 7
    assert tckpt.latest_checkpoint_step(str(tmp_path / "none")) is None
    # plain tensors and ints only
    raw = torch.load(path, weights_only=True)
    assert set(raw) == {"params", "opt_state", "step"} and raw["step"] == 7

    fresh, blank = port_state(seed=1, step=0)
    loaded, next_step = tckpt.load_checkpoint(str(tmp_path), fresh, blank)
    assert next_step == 8 and loaded.step == 7
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    for m, p in state.camera_poses.items():
        assert torch.equal(loaded.camera_poses[m], p.detach()) and loaded.camera_poses[m].requires_grad
    assert loaded.opt_state.count == 7
    for name in ("mu", "nu"):
        for g, group in getattr(state.opt_state, name).items():
            for k, v in group.items():
                assert torch.equal(getattr(loaded.opt_state, name)[g][k], v), (name, g, k)
    # nothing to load: the state comes back as it was, at step 0
    same, start = tckpt.load_checkpoint(str(tmp_path / "none"), fresh, blank)
    assert same is blank and start == 0


def test_save_prunes_older_steps_unless_asked_to_keep(tmp_path):
    model, state = port_state()
    tckpt.save_checkpoint(str(tmp_path), model, state)
    state.step = 9
    tckpt.save_checkpoint(str(tmp_path), model, state, keep_only_latest=False)
    assert sorted(os.listdir(tmp_path)) == ["step-000000007.pt", "step-000000009.pt"]
    state.step = 12
    tckpt.save_checkpoint(str(tmp_path), model, state)
    assert sorted(os.listdir(tmp_path)) == ["step-000000012.pt"]
    # an explicit step loads that step
    state.step = 15
    tckpt.save_checkpoint(str(tmp_path), model, state, keep_only_latest=False)
    fresh, blank = port_state(seed=1, step=0)
    assert tckpt.load_checkpoint(str(tmp_path), fresh, blank, step=12)[1] == 13
    assert tckpt.load_checkpoint(str(tmp_path), fresh, blank)[1] == 16


def test_weights_file_evaluates_but_does_not_train(tmp_path):
    model, state = port_state(step=5)
    ckpt_dir = tmp_path / "run" / "checkpoints"
    os.makedirs(ckpt_dir)
    state.opt_state = None
    weights = tckpt.checkpoint_dict(model, state)
    assert set(weights) == {"params", "step"}
    torch.save(weights, tckpt.checkpoint_path(str(ckpt_dir), 5))
    fresh, blank = port_state(seed=1, step=0)
    loaded, next_step = tckpt.load_checkpoint(str(ckpt_dir), fresh, blank)
    assert loaded.opt_state is None and loaded.step == 5 and next_step == 6
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k

    ds = make_synthetic_dataset(MODS, **DATA, device="cpu")
    cfg = dataclasses.replace(TCFG, max_num_iterations=8)
    trainer = Trainer(cfg, ds, ds, str(tmp_path / "run"), device="cpu")
    trainer.setup()
    assert trainer.state.opt_state is None and trainer.step_start == 6
    with pytest.raises(ValueError, match="step-000000005.pt is a weights file"):
        trainer.train()


# ------------------------------------------------------------- optax state


def _jax_grads(params, rng, scale):
    return jax.tree.map(lambda p: jnp.asarray((scale * rng.normal(size=p.shape)).astype(np.float32)),
                        params)


def unflatten(flat):
    """A nested dict from dotted keys: the params tree of a port state dict."""
    tree = {}
    for key, value in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A tiny JAX TrainState after two optax updates, saved and restored
    through the JAX package's checkpoints, and the port's model carrying its
    params. The parameters are drawn from a unit normal (as
    tests/test_torch_train.py's optimizer test draws them, so an update is
    compared on parameters of unit scale), in the tree of the port's state
    dict, which is the JAX model's params tree (convert.py)."""
    rng = np.random.default_rng(4)
    model = MMSModel(TCFG.model, device="cpu")
    params = {
        "model": unflatten({k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
                            for k, v in model.state_dict().items()}),
        "camera_poses": {m: jnp.asarray(rng.normal(size=(1, 6)).astype(np.float32)) for m in MODS},
    }
    tx = jtrain.make_optimizer(JCFG)
    update = jax.jit(lambda g, s: jtrain._guarded_update(tx, g, s, {}))
    # committed to the device, as the orbax restore's leaves are, so the update the tests
    # make from the restored state reuses this compile (uncommitted, it compiled again: 12 s)
    state = jax.device_put(jtrain.TrainState(params=params, opt_state=tx.init(params),
                                             step=jnp.asarray(0)), jax.devices()[0])
    for scale in (0.3, 3.0):  # the second clips
        params, opt = update(_jax_grads(state.params, rng, scale), state)
        state = jtrain.TrainState(params=params, opt_state=opt, step=state.step + 1)
    ckpt_dir = str(tmp_path_factory.mktemp("jax_ckpt"))
    jckpt.save_checkpoint(ckpt_dir, state)
    restored, next_step = jckpt.load_checkpoint(ckpt_dir, jax.tree.map(jnp.zeros_like, state))
    assert next_step == 3
    carried = params_from_jax(jax.tree.map(np.asarray, restored.params), model)
    model.load_state_dict(carried["model"])
    return dict(state=restored, update=update, model=model, poses=carried["camera_poses"],
                rng=rng)


def test_opt_state_from_jax_carries_every_leaf_bit_for_bit(jax_run):
    state, model = jax_run["state"], jax_run["model"]
    opt = opt_state_from_jax(jax.tree.map(np.asarray, state.opt_state), model)
    inner = {g: s.inner_state for g, s in state.opt_state[1].inner_states.items()}
    assert opt["count"] == int(inner["fields"][0].count) == 2
    for name in ("mu", "nu"):
        jfields = getattr(inner["fields"][0], name)["model"]
        flat = {}

        def walk(node, prefix=""):
            for k, v in node.items():
                if hasattr(v, "items"):
                    walk(v, f"{prefix}{k}.")
                else:
                    flat[prefix + k] = np.asarray(v)

        walk(jfields)
        assert set(flat) == set(opt[name]["fields"]) == set(dict(model.named_parameters()))
        for k, v in flat.items():
            assert np.array_equal(opt[name]["fields"][k].numpy(), v), (name, k)
        jposes = getattr(inner["camera_poses"][0], name)["camera_poses"]
        assert set(jposes) == set(opt[name]["camera_poses"]) == set(MODS)
        for m, v in jposes.items():
            assert np.array_equal(opt[name]["camera_poses"][m].numpy(), np.asarray(v)), (name, m)


def test_opt_state_from_jax_refuses_counts_that_differ(jax_run):
    tree = jax.tree.map(np.asarray, jax_run["state"].opt_state)
    inner = tree[1].inner_states
    cam = inner["camera_poses"]
    bumped = cam.inner_state[0]._replace(count=np.asarray(5, np.int32))
    inner["camera_poses"] = cam._replace(inner_state=(bumped, *cam.inner_state[1:]))
    with pytest.raises(ValueError, match="counts differ"):
        opt_state_from_jax(tree, jax_run["model"])


def test_one_update_from_the_carried_state_matches_optax(jax_run):
    state, model = jax_run["state"], jax_run["model"]
    grads = _jax_grads(state.params, jax_run["rng"], 1.0)
    new_params, new_opt = jax_run["update"](grads, state)

    carried = opt_state_from_jax(jax.tree.map(np.asarray, state.opt_state), model)
    tstate = ttrain.TrainState(
        camera_poses={m: p.clone().requires_grad_(True) for m, p in jax_run["poses"].items()},
        step=int(state.step),
        opt_state=ttrain.OptState(count=carried["count"], mu=carried["mu"], nu=carried["nu"]))
    params = ttrain.train_params(model, tstate.camera_poses)
    flat_g = params_from_jax(jax.tree.map(np.asarray, grads), model)
    tgrads = {"fields": flat_g["model"], "camera_poses": flat_g["camera_poses"]}
    assert ttrain.guarded_update(ttrain.make_optimizer(TCFG), tgrads, params, tstate) == 1.0
    assert tstate.opt_state.count == 3
    want = params_from_jax(jax.tree.map(np.asarray, new_params), model)
    for k, p in params["fields"].items():
        assert rel_l2(p.detach().numpy(), want["model"][k].numpy()) <= 1e-6, k
    for m, p in params["camera_poses"].items():
        assert rel_l2(p.detach().numpy(), want["camera_poses"][m].numpy()) <= 1e-6, m
    jopt = opt_state_from_jax(jax.tree.map(np.asarray, new_opt), model)
    for name in ("mu", "nu"):
        for g in ("fields", "camera_poses"):
            for k, v in jopt[name][g].items():
                got = getattr(tstate.opt_state, name)[g][k]
                assert rel_l2(got.numpy(), v.numpy()) <= 1e-6, (name, g, k)
