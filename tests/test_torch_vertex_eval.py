"""grid_raw_tpu without its position encoding on a vertex-layout slot table
(tests/test_torch_vertex_slice.py's configuration and parameters): the
eval forward and sdf_gradients against the JAX package. The render
samples take the composition K6v with tangents -> K5 -> d sdf/dx =
<adj, tangents>; the curvature taps of sdf_gradients(train=True) and the
sampler's queries take sdf_only -> sdf_geo -> FeatureGrid -> the lookup
without tangents -> the K1 head. JAX runs its Pallas kernels in interpret
mode, the port the plain versions.

Tolerances as the no-PE cell slice is held
(tests/test_torch_slot_composition.py): eval outputs and the SDF route
rel-L2 <= 1e-2. Measured (init seed 0): eval outputs within 1.1e-3; sdf
0, geo 4.8e-5, grad 1.7e-7, the taps' hessian 2.8e-8.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multimodalstudio_tpu.engine.train as jtrain

import multimodalstudio_tpu_torch.engine.train as ttrain
import multimodalstudio_tpu_torch.ops.kernels.slot_grid as tslot
from multimodalstudio_tpu_torch.ops.kernels import build

from test_torch_mlp_raw import carry
from test_torch_slot_composition import _rays
from test_torch_train import MODS, STEP, rel_l2
from test_torch_vertex_slice import JCFG, TCFG

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def carried():
    return carry(JCFG, TCFG)


def test_eval_forward_matches_jax(carried, monkeypatch):
    """Through the lookup's plain forward only: the sampler's 2 queries and
    the render samples."""
    n = 12
    jrays, trays = _rays(carried["jds"], n, 1)
    jm, params = carried["jm"], carried["params"]["model"]
    segments = ((MODS[0], n),)
    jout = jax.jit(lambda p, r: jm.forward(
        p, r, segments, jtrain.make_schedules(JCFG, jnp.asarray(STEP)), None, train=False,
        aligned=True))(params, jrays)
    calls = []
    for name in ("slot_lookup_vertex_plain", "slot_lookup_plain"):
        real = getattr(tslot, name)
        monkeypatch.setattr(tslot, name, lambda *a, real=real, name=name, **k:
                            calls.append(name) or real(*a, **k))
    build.reset_launch_counts()
    tout = carried["model"].forward(trays, segments, ttrain.make_schedules(TCFG, STEP),
                                    aligned=True)
    assert all(info.launches == 0 for info in build.KERNELS.values())  # plain versions only
    assert calls == ["slot_lookup_vertex_plain"] * (TCFG.model.ray_sampler.num_upsample_steps + 1)
    assert set(tout) == set(jout)
    for key in jout:
        assert tout[key].shape == jout[key].shape, key
        assert rel_l2(tout[key].numpy(), jout[key]) <= 1e-2, (key, rel_l2(tout[key].numpy(),
                                                                          jout[key]))


def test_sdf_gradients_match_jax(carried):
    """train=True: the render samples' composition and the curvature taps'
    SDF queries (sdf_only -> sdf_geo -> FeatureGrid -> the lookup)."""
    rng = np.random.default_rng(2)
    pos = rng.uniform(-0.9, 0.9, size=(2, 20, 3)).astype(np.float32)
    jm, params = carried["jm"], carried["params"]["model"]
    sched = jtrain.make_schedules(JCFG, jnp.asarray(STEP))
    ref = jax.jit(lambda p, x: jm.sdf_gradients(p, x, sched, True))(params, jnp.asarray(pos))
    got = carried["model"].sdf_gradients(torch.from_numpy(pos), ttrain.make_schedules(TCFG, STEP),
                                         train=True)
    for name, a, b in zip(("sdf", "geo", "grad", "hessian"), got, ref):
        assert tuple(a.shape) == tuple(b.shape), name
        assert rel_l2(a.detach().numpy(), np.asarray(b, np.float32)) <= 1e-2, name
