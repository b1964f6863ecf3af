"""The port against the JAX package on trained weights: the committed
rehearsal checkpoints, each package reading the same weights file (its
params are the orbax restore's bit for bit,
tests/test_torch_converted_checkpoints.py), at the checkpoint's step, so
every grid level is live and the variance is the trained one.

At 64 positions near the scene's sphere (radius 0.5 at the origin, within
+-0.05 of its surface, seed 0): the SDF, the geometry features and d sdf/dx
through the surface field, JAX's Pallas kernels in interpret mode, the
port's plain versions (rehearsal_mlp_dense: K4; rehearsal_grid_dense, f32
table: K3f); then the radiance trunk (K1) and the rgb and polarization
heads on those features, normals and random view directions. Tolerance
rel-L2 <= 1e-2 per output, as the slice tests hold the same kernels
(tests/test_torch_mlp_raw.py, tests/test_torch_f32_slice.py). Measured:
rehearsal_mlp_dense sdf 4.5e-7, geo 2.4e-5, grad 4.7e-7, trunk 1.2e-10,
heads within 3.4e-8; rehearsal_grid_dense sdf 3.6e-4, geo 1.7e-4, grad
3.1e-5, trunk 3.0e-6, heads within 5.4e-8. The JAX outputs also show the
trained surface: the SDF negative inside radius 0.47 and positive outside
0.53, |d sdf/dx| within 0.1 of 1 (median).
rehearsal_mlp_dense is held here, rehearsal_grid_dense in
tests/test_torch_trained_fields_grid.py.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import convert_checkpoints as cc
import rehearsals
import multimodalstudio_tpu.engine.train as jtrain
import multimodalstudio_tpu.models.model as jmodel
from multimodalstudio_tpu.ops.encodings import sh_encoding_dense as jsh

import multimodalstudio_tpu_torch.engine.train as ttrain
from multimodalstudio_tpu_torch.ops.encodings import sh_encoding_dense as tsh

from test_torch_checkpoints import unflatten

torch.set_num_threads(1)

TOL = 1e-2
N = 64


def rel_l2(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def near_sphere(seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r = 0.5 + rng.uniform(-0.05, 0.05, size=(N, 1))
    view = rng.normal(size=(N, 3))
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    up = np.cross(view, rng.normal(size=(N, 3)))
    up /= np.linalg.norm(up, axis=-1, keepdims=True)
    return (d * r).astype(np.float32), view.astype(np.float32), up.astype(np.float32)


def trained_pair(name):
    """(JAX config, JAX model, JAX params, port config, port model, step) of
    a rehearsal run, both packages holding its weights file."""
    r = cc.REHEARSALS[name]
    ckpt = torch.load(os.path.join(r["run"], "checkpoints", f"step-{r['step']:09d}.pt"),
                      weights_only=True)
    jcfg = cc.jax_config(name)
    jm = jmodel.MMSModel(jcfg.model)
    params = unflatten({k: jnp.asarray(v.numpy()) for k, v in ckpt["params"]["model"].items()})
    model = cc.port_model(name)
    model.load_state_dict(ckpt["params"]["model"])
    tcfg = rehearsals.rehearsal_config(name)
    return jcfg, jm, params, tcfg, model, ckpt["step"]


def assert_trained_fields_match(name):
    jcfg, jm, params, tcfg, model, step = trained_pair(name)
    pos, view, up = near_sphere()
    jsched = jtrain.make_schedules(jcfg, jnp.asarray(step))
    tsched = ttrain.make_schedules(tcfg, step)
    assert int(tsched.active_level) == int(jsched.active_level)
    ref = jax.jit(lambda p, x: jm.sdf_gradients(p, x, jsched, False))(params, jnp.asarray(pos))
    with torch.no_grad():
        got = model.sdf_gradients(torch.from_numpy(pos), tsched)
    for what, a, b in zip(("sdf", "geo", "grad"), got[:3], ref[:3]):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        assert a.shape == b.shape, what
        assert np.isfinite(a).all() and rel_l2(a, b) <= TOL, (name, what, rel_l2(a, b))
    # the trained surface: the SDF changes sign across the sphere, |grad| near 1
    sdf, grad = np.asarray(ref[0]), np.asarray(ref[2])
    assert (sdf[np.linalg.norm(pos, axis=-1) < 0.47] < 0).all()
    assert (sdf[np.linalg.norm(pos, axis=-1) > 0.53] > 0).all()
    assert abs(np.median(np.linalg.norm(grad, axis=-1)) - 1.0) < 0.1

    # the trunk and two heads on the same inputs: the JAX features and normals
    geo = np.asarray(ref[1], np.float32)
    nrm = grad / np.linalg.norm(grad, axis=-1, keepdims=True)
    n_dot_v = np.sum(nrm * -view, axis=-1, keepdims=True)
    extras = np.concatenate([geo, n_dot_v], axis=-1).astype(np.float32)
    refl = (2.0 * (n_dot_v * nrm) + view).astype(np.float32)
    spec = jcfg.model.radiance
    assert spec.use_n_dot_v and spec.use_reflection_direction and spec.use_direction_encoding
    jfeat = jm.radiance_field.apply({"params": params["radiance_field"]}, jnp.asarray(pos),
                                    jsh(jnp.asarray(refl), spec.sh_degree), jnp.asarray(extras))
    with torch.no_grad():
        tfeat = model.radiance_field(torch.from_numpy(pos),
                                     tsh(torch.from_numpy(refl), spec.sh_degree),
                                     torch.from_numpy(extras))
    err = rel_l2(tfeat.float().numpy(), np.asarray(jfeat, np.float32))
    assert err <= TOL
    # each head on the JAX trunk's features, so only the head's own rounding differs
    feat = np.array(jfeat, np.float32)
    for mod in ("rgb", "polarization"):
        jout = jm.heads[mod].apply({"params": params["heads"][mod]}, jnp.asarray(feat),
                                   directions=jnp.asarray(view), up_directions=jnp.asarray(up))
        with torch.no_grad():
            tout = model.heads[mod](torch.from_numpy(feat), torch.from_numpy(view),
                                    torch.from_numpy(up))
        err = rel_l2(tout.float().numpy(), np.asarray(jout, np.float32))
        assert np.isfinite(tout.float().numpy()).all() and err <= TOL, (name, mod, err)


@pytest.mark.parametrize("name", ["rehearsal_mlp_dense"])
def test_trained_fields_match_jax(name):
    assert_trained_fields_match(name)
