"""convert.py carries the hash tables of the reference grid methods: the
surface's, the radiance trunk's and the background's hash grid
(grid_raw_grid_bg_unbalanced, cut as tests/test_torch_grid_reference.py
cuts it). params_from_jax takes the parameters after two optax updates,
every leaf bit for bit; opt_state_from_jax takes optax's moments, the
tables' too, bit for bit; a missing, extra or misshapen table raises in
both."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multimodalstudio_tpu.engine.train as jtrain
from multimodalstudio_tpu_torch.convert import opt_state_from_jax, params_from_jax
from multimodalstudio_tpu_torch.models.model import MMSModel

from test_torch_grid_reference import MODS, configs
from test_torch_mlp_raw import _unflatten

torch.set_num_threads(1)

TABLES = tuple(f"{p}.grid_mlp.feature_grid.encoding.table" for p in (
    "surface_field.field", "radiance_field.base_field", "background_field.base_field"))


@pytest.fixture(scope="module")
def run():
    """The cut grid_raw_grid_bg_unbalanced: the port's init as a JAX params
    tree (the state-dict keys are the flax paths; tests/test_torch_mlp_raw.py
    holds that tree against the JAX init's shapes), two optax updates of it
    by the JAX package's optimizer, and a port model of that config."""
    jcfg, tcfg = configs(method="grid_raw_grid_bg_unbalanced")
    model = MMSModel(tcfg.model, device="cpu").init(torch.Generator().manual_seed(0))
    params = {"model": jax.tree.map(jnp.asarray, _unflatten(
        {k: v.numpy() for k, v in model.state_dict().items()})),
        "camera_poses": {m: jnp.zeros((3, 6)) for m in MODS}}
    tx = jtrain.make_optimizer(jcfg)
    state = jtrain.TrainState(params=params, opt_state=tx.init(params), step=jnp.asarray(0))
    update = jax.jit(lambda g, s: jtrain._guarded_update(tx, g, s, {}))
    rng = np.random.default_rng(1)
    for _ in range(2):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)),
                             state.params)
        params, opt = update(grads, state)
        state = jtrain.TrainState(params=params, opt_state=opt, step=state.step + 1)
    return dict(state=jax.tree.map(np.asarray, state), model=MMSModel(tcfg.model, device="cpu"))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_params_from_jax_carries_the_hash_tables(run):
    state, model = run["state"], run["model"]
    carried = params_from_jax(state.params, model)
    flat = _flat(state.params["model"])
    assert set(TABLES) <= set(flat) and set(carried["model"]) == set(flat)
    for k in TABLES:
        assert flat[k].shape == (4 * 2**10, 2), k
    for k, v in flat.items():
        assert np.array_equal(carried["model"][k].numpy(), v), k
    model.load_state_dict(carried["model"])


def test_opt_state_from_jax_carries_the_hash_tables(run):
    state, model = run["state"], run["model"]
    opt = opt_state_from_jax(state.opt_state, model)
    assert opt["count"] == 2
    inner = state.opt_state[1].inner_states["fields"].inner_state[0]
    for name in ("mu", "nu"):
        flat = _flat(getattr(inner, name)["model"])
        for k in TABLES:
            assert np.abs(flat[k]).max() > 0, (name, k)
            assert np.array_equal(opt[name]["fields"][k].numpy(), flat[k]), (name, k)


def _without(tree, key):
    """A copy of the nested dict `tree` without the leaf at dotted `key`."""
    head, _, rest = key.partition(".")
    return {k: (_without(v, rest) if k == head and rest else v)
            for k, v in tree.items() if not (k == head and not rest)}


def _replaced(tree, key, value):
    head, _, rest = key.partition(".")
    return {k: (_replaced(v, rest, value) if k == head and rest else value if k == head else v)
            for k, v in tree.items()}


@pytest.mark.parametrize("table", TABLES)
def test_a_missing_extra_or_misshapen_table_raises(run, table):
    params, model = run["state"].params, run["model"]
    tree = {"model": _without(params["model"], table), "camera_poses": params["camera_poses"]}
    with pytest.raises(KeyError, match="missing"):
        params_from_jax(tree, model)
    extra = table.replace("table", "table_extra")
    tree = {"model": _replaced(params["model"], table.rsplit(".", 1)[0],
                               {"table": _flat(params["model"])[table], "table_extra": 0.0}),
            "camera_poses": params["camera_poses"]}
    assert extra in _flat(tree["model"])
    with pytest.raises(KeyError, match="extra"):
        params_from_jax(tree, model)
    short = _flat(params["model"])[table][:-1]
    tree = {"model": _replaced(params["model"], table, short),
            "camera_poses": params["camera_poses"]}
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, model)


def test_opt_state_with_a_misshapen_table_raises(run):
    opt, model = run["state"].opt_state, run["model"]
    group = opt[1].inner_states["fields"]
    adam = group.inner_state[0]
    mu = adam.mu
    short = _flat(mu["model"])[TABLES[0]][:-1]
    bad = adam._replace(mu={**mu, "model": _replaced(mu["model"], TABLES[0], short)})
    inner = dict(opt[1].inner_states)
    inner["fields"] = group._replace(inner_state=(bad, *group.inner_state[1:]))
    tree = (opt[0], opt[1]._replace(inner_states=inner), *opt[2:])
    with pytest.raises(ValueError, match="shape"):
        opt_state_from_jax(tree, model)
    missing = adam._replace(mu={**mu, "model": _without(mu["model"], TABLES[0])})
    inner["fields"] = group._replace(inner_state=(missing, *group.inner_state[1:]))
    tree = (opt[0], opt[1]._replace(inner_states=inner), *opt[2:])
    with pytest.raises(KeyError, match="missing"):
        opt_state_from_jax(tree, model)
