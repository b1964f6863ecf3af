"""The port's reference mlp method mlp_raw against the JAX package: the
surface MLP is float32 and unfused, so its SDF gradients take the
autograd route, vmap(jacfwd) through the SDF field (and, with
compute_hessian in training, the nested jacfwd whose hessian rows are
summed), and in training the three field regions are recomputed in the
backward (remat).

mlp_raw comes from each package's load_config of confs/mlp_raw.yaml and is
cut by tests/test_torch_grid_reference.py's cut at width 64: the 8-layer
SDF MLP and radiance trunk become 4 x 64 with the skip at layer 2, every
other MLP, the geometric features and the radiance features 64 wide, light
samplers without jitter, 3 modalities, 4 rays per modality in 2
microbatches, step 25000. Parameters are carried as in that file.

Both sides run float32 with no kernel. Tolerances as there: the SDF
route (sdf, geo, d sdf/dx and H @ 1) rel-L2 <= 1e-4, eval outputs 1e-3,
losses and metrics rel 1e-4, each gradient group max(1e-3, twice the
port's noise).
tests/test_torch_mlp_second_order.py holds the eikonal and curvature
losses' parameter gradients through the jacfwd route and the remat
property, with this file's fixture.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multimodalstudio_tpu.engine.train as jtrain
import multimodalstudio_tpu.models.model as jmodel
import multimodalstudio_tpu_torch.engine.train as ttrain
import multimodalstudio_tpu_torch.models.model as tmodel

from test_torch_grid_reference import (
    STEP,
    TOL,
    assert_gradients_match,
    assert_losses_match,
    assert_outputs_match,
    batch_run,
    carry,
    configs,
    eval_forward,
    rel_l2,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mlp_raw():
    return carry(*configs("confs/mlp_raw.yaml", width=64))


def with_hessian(c):
    """The JAX model and a port model on c's parameters with
    compute_hessian on."""
    jcfg, tcfg = c["jcfg"], c["tcfg"]
    jm = jmodel.MMSModel(dataclasses.replace(jcfg.model, surface=dataclasses.replace(
        jcfg.model.surface, compute_hessian=True)))
    tm = tmodel.MMSModel(dataclasses.replace(tcfg.model, surface=dataclasses.replace(
        tcfg.model.surface, compute_hessian=True)), device="cpu")
    tm.load_state_dict(c["model"].state_dict())
    return jm, tm


def positions():
    return np.random.default_rng(2).uniform(-0.9, 0.9, size=(2, 20, 3)).astype(np.float32)


def test_mlp_raw_is_float32_unfused_with_remat(mlp_raw):
    cfg = mlp_raw["tcfg"]
    mlp = cfg.model.surface.surface_field.field.mlp
    assert (mlp.dtype, mlp.fused, mlp.activation, mlp.skip_connections) == (
        "float32", False, "Softplus", (2,))
    assert mlp.geometric_init and mlp.geometric_init_bias == 0.4
    assert not cfg.model.surface.use_numerical_gradients and cfg.model.remat
    assert cfg.matmul_precision == "high" and not torch.backends.cuda.matmul.allow_tf32


def test_mlp_raw_eval_forward_matches_jax(mlp_raw):
    assert_outputs_match(*eval_forward(mlp_raw))


@pytest.mark.parametrize("hessian", [False, True])
def test_jacfwd_sdf_gradients_match_jax(mlp_raw, hessian):
    """sdf, geo and d sdf/dx from vmap(jacfwd), and with compute_hessian
    in training the hessian's rows summed (H @ 1)."""
    pos = positions()
    if hessian:
        jm, tm = with_hessian(mlp_raw)
    else:
        jm, tm = mlp_raw["jm"], mlp_raw["model"]
    jsched = jtrain.make_schedules(mlp_raw["jcfg"], jnp.asarray(STEP))
    ref = jax.jit(lambda p, x: jm.sdf_gradients(p, x, jsched, True))(
        mlp_raw["params"]["model"], jnp.asarray(pos))
    got = tm.sdf_gradients(torch.from_numpy(pos), ttrain.make_schedules(mlp_raw["tcfg"], STEP),
                           train=True)
    assert (got[3] is None) == (ref[3] is None) == (not hessian)
    for name, a, b in zip(("sdf", "geo", "grad", "hessian"), got, ref):
        if b is None:
            continue
        assert tuple(a.shape) == tuple(b.shape), name
        err = rel_l2(a.detach().numpy(), np.asarray(b))
        assert err <= TOL, (name, err)


@pytest.fixture(scope="module")
def mlp_raw_batch(mlp_raw):
    return batch_run(mlp_raw, 5)


def test_mlp_raw_batch_losses_match_jax(mlp_raw_batch):
    assert "eikonal_loss" in mlp_raw_batch["t"][1]
    assert "curvature_loss" not in mlp_raw_batch["t"][1]
    assert_losses_match(mlp_raw_batch)


def test_mlp_raw_batch_gradients_match_jax(mlp_raw_batch):
    groups = assert_gradients_match(mlp_raw_batch["j"][3], mlp_raw_batch["t"][3],
                                    mlp_raw_batch["moved"])
    assert {"surface_field.field.mlp", "radiance_field.base_field.mlp",
            "background_field.base_field.mlp", "variance"} <= set(groups)
