"""The port's mlp_raw_tpu with a scene contraction on its surface against the
JAX package: load_config's override, the generic route of sdf_gradients
(the encoding's tangents outside the kernels, then K1 with tangents, K1t),
the eval forward, and the losses and every gradient group of a training
batch.

The configuration is mlp_raw_tpu with one leaf overridden through each
package's own load_config: model.surface.contraction_order = inf (the
MipNeRF-360 L-inf contraction). Its render samples then leave the K4
route for the generic one; its sampler queries contract and run the SDF
field. It is cut to CPU size by tests/test_torch_mlp_raw.py's tiny() and
carry() (4 layers of width 128, 8+8 NeuS and 4 background samples, 3
modalities, 4 rays per modality in 2 microbatches; the port's init moved
by numpy noise and loaded into both packages). JAX runs its Pallas kernels
in interpret mode, the port the plain versions of K1 and K1t.

Tolerances, as tests/test_torch_mlp_raw.py holds mlp_raw_tpu: eval outputs
and the SDF route rel-L2 <= 1e-2 (the position gradient of the eikonal
loss through the route 2e-2), losses rel 1e-2, and each gradient group
within max(3e-2, 2 * the port's distance to itself with its parameters
moved by 1e-6) (assert_gradients_match). Readings, JAX against the port
(the noise), worst groups, over every batch seed tried:
  5: the rgb poses 1.6e-1 (2.7e-1), the background density head 1.7e-2
     (2.3e-2), every other group within 1.5e-2; losses within rel 4.5e-4.
The batch is drawn with seed 5, as in tests/test_torch_mlp_raw.py; the
readings are close to that file's because most of this scene's samples
lie inside the unit cube, where the contraction is the identity. Also
tried, to cut JAX's compile time, the rgb modality alone (seed 5): the
variance group read 2.1e-1 against a 3-draw noise of 1.8e-2, but over 12
draws the port's own variance gradient moves by 0.06 % to 32 % and JAX's
value lies inside that spread (the K4 route on that batch: 3.3e-1 against
1.9e-1), so 3 draws under-read that group's noise there; this file keeps
the 3 modalities.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multimodalstudio_tpu.configs.config as jconfig
import multimodalstudio_tpu.engine.train as jtrain
import multimodalstudio_tpu.models.samplers as jsamplers

import multimodalstudio_tpu_torch.configs.config as tconfig
import multimodalstudio_tpu_torch.engine.train as ttrain
import multimodalstudio_tpu_torch.models.model as tmodel
import multimodalstudio_tpu_torch.models.samplers as tsamplers

from test_torch_mlp_raw import (
    BATCH_SEED,
    MODS,
    STEP,
    _rays,
    assert_gradients_match,
    batch_run,
    carry,
    rel_l2,
    tiny,
)

torch.set_num_threads(1)

CONTRACTION = {"model": {"surface": {"contraction_order": float("inf")}}}
NO_INPUT = {"model": {"surface": {"surface_field": {"position_encoding": {"include_input": False}}}}}


class _Registry:
    """tiny()'s `methods` argument: mlp_raw_tpu through a package's
    load_config with an override."""

    def __init__(self, config_module, overrides):
        self.config_module, self.overrides = config_module, overrides

    def method_configs(self):
        return {"mlp_raw_tpu": self.config_module.load_config(method="mlp_raw_tpu",
                                                              overrides=self.overrides)}


def _configs(overrides):
    return (tiny(_Registry(jconfig, overrides), jsamplers),
            tiny(_Registry(tconfig, overrides), tsamplers))


JCFG, TCFG = _configs(CONTRACTION)


def test_load_config_override_matches_jax():
    j = jconfig.load_config(method="mlp_raw_tpu", overrides=CONTRACTION)
    t = tconfig.load_config(method="mlp_raw_tpu", overrides=CONTRACTION)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.model.surface.contraction_order == float("inf")


@pytest.fixture(scope="module")
def carried():
    return carry(JCFG, TCFG)


def _route_calls(monkeypatch):
    """Record whether each fused_chain call of models/model.py has tangents."""
    calls, original = [], tmodel.fused_chain

    def recording(*args, **kw):
        calls.append(kw.get("tangents") is not None)
        return original(*args, **kw)

    monkeypatch.setattr(tmodel, "fused_chain", recording)
    return calls


# inside the unit cube the contraction is the identity; outside it bends,
# with points on the cube's diagonals (ties of the L-inf norm's argmax)
INSIDE = np.random.default_rng(2).uniform(-0.9, 0.9, size=(2, 12, 3)).astype(np.float32)
OUTSIDE = np.concatenate([
    np.random.default_rng(3).uniform(-1.6, 1.6, size=(20, 3)),
    [[1.2, 1.2, -0.5], [1.3, -1.3, 1.3], [-1.5, 0.2, 1.5], [0.0, 0.0, 0.0]],
]).astype(np.float32).reshape(2, 12, 3)


def _eikonal(sdf, grad, xp):
    norm = xp.sqrt((grad * grad).sum(-1))
    return ((norm - 1.0) ** 2).sum() + (sdf * sdf).sum()


@pytest.fixture(scope="module")
def jax_sdf(carried):
    """JAX's sdf_gradients in training and the gradient of an eikonal-style
    loss through it with respect to the positions, one jit for both
    position sets."""
    jm, params = carried["jm"], carried["params"]["model"]
    sched = jtrain.make_schedules(JCFG, jnp.asarray(STEP))

    def loss(x):
        sdf, geo, grad, _ = jm.sdf_gradients(params, x, sched, True)
        return _eikonal(sdf, grad, jnp), (sdf, geo, grad)

    return jax.jit(jax.grad(loss, has_aux=True))


@pytest.mark.parametrize("where", ["inside", "outside"])
def test_sdf_gradients_take_the_tangent_route_and_match_jax(carried, jax_sdf, monkeypatch, where):
    """sdf, geo (f32) and d sdf/dx through K1t; and the gradient of an
    eikonal-style loss with respect to the positions, which runs K1t's
    backward and the second derivatives of the contraction and the
    encoding (finite on the unselected branch of the contraction)."""
    pos = INSIDE if where == "inside" else OUTSIDE
    ref_dpos, ref = jax_sdf(jnp.asarray(pos))
    calls = _route_calls(monkeypatch)
    tpos = torch.tensor(pos, requires_grad=True)
    got = carried["model"].sdf_gradients(tpos, ttrain.make_schedules(TCFG, STEP), train=True)
    assert calls == [True] and got[3] is None
    assert got[1].dtype == torch.float32  # geo leaves the generic route in f32 (model.py:499-503)
    for name, a, b in zip(("sdf", "geo", "grad"), got[:3], ref[:3]):
        assert tuple(a.shape) == tuple(b.shape), name
        assert rel_l2(a.detach().numpy(), np.asarray(b, np.float32)) <= 1e-2, name
    _eikonal(got[0], got[2], torch).backward()
    assert torch.isfinite(tpos.grad).all()
    assert rel_l2(tpos.grad.numpy(), ref_dpos) <= 2e-2


def test_encoding_without_the_input_takes_the_tangent_route(monkeypatch):
    """mlp_raw_tpu whose position encoding leaves the raw input out, with no
    contraction, takes the same route (model.py:455-458)."""
    jcfg, tcfg = _configs(NO_INPUT)
    run = carry(jcfg, tcfg)
    sched = jtrain.make_schedules(jcfg, jnp.asarray(STEP))
    ref = run["jm"].sdf_gradients(run["params"]["model"], jnp.asarray(INSIDE), sched, False)
    calls = _route_calls(monkeypatch)
    got = run["model"].sdf_gradients(torch.from_numpy(INSIDE), ttrain.make_schedules(tcfg, STEP))
    assert calls == [True]
    for name, a, b in zip(("sdf", "geo", "grad"), got[:3], ref[:3]):
        assert rel_l2(a.detach().numpy(), np.asarray(b, np.float32)) <= 1e-2, name


def test_eval_forward_matches_jax(carried):
    n = 12
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


@pytest.fixture(scope="module")
def slice_run(carried):
    return batch_run(carried, BATCH_SEED)


def test_slice_losses_match_jax(slice_run):
    jtotal, jlo, _, _ = slice_run["j"]
    ttotal, tlo, _, _ = slice_run["t"]
    assert set(tlo) == set(jlo) and "eikonal_loss" in tlo
    for k in jlo:
        assert abs(float(tlo[k]) - float(jlo[k])) <= 1e-2 * abs(float(jlo[k])), k
    assert abs(float(ttotal) - float(jtotal)) <= 1e-2 * abs(float(jtotal))


def test_slice_gradients_match_jax(slice_run):
    """Each group within max(3e-2, twice the port's distance to itself with
    its parameters moved by 1e-6)."""
    groups = assert_gradients_match(slice_run["j"][3], slice_run["t"][3], slice_run["moved"], MODS)
    assert {"surface_field.field.mlp", "radiance_field.base_field.mlp"} <= set(groups)
