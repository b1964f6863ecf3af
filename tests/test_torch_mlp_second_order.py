"""Second-order paths of the reference methods: the eikonal loss (and with
compute_hessian the curvature proxy's L1) differentiated through mlp_raw's
jacfwd route, the surface MLP's parameter gradients against JAX's within
rel-L2 1e-3 (the SDF route itself agrees within 1e-4,
tests/test_torch_mlp_reference.py, whose cut and parameters this file
takes); and remat: one batch through the port with remat on and off gives
the same gradients within rel-L2 1e-6 (the recompute runs the same ops on
the same inputs), on mlp_raw and on grid_raw."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multimodalstudio_tpu.engine.train as jtrain
from multimodalstudio_tpu_torch.cameras.camera_optimizer import init_camera_poses
import multimodalstudio_tpu_torch.engine.train as ttrain
import multimodalstudio_tpu_torch.models.model as tmodel
from multimodalstudio_tpu_torch.data.synthetic import make_synthetic_dataset as tmake_dataset

from test_torch_grid_reference import MODS, STEP, configs, rel_l2
from test_torch_train import numpy_batch
from test_torch_mlp_reference import mlp_raw, positions, with_hessian  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("hessian", [False, True])
def test_eikonal_and_curvature_gradients_reach_the_surface_mlp(mlp_raw, hessian):
    """The eikonal loss (and with the hessian the curvature proxy's L1)
    differentiated through the jacfwd route: the surface MLP's parameter
    gradients against JAX's grad of the same function."""
    pos = positions()
    jm, tm = with_hessian(mlp_raw) if hessian else (mlp_raw["jm"], mlp_raw["model"])
    jsched = jtrain.make_schedules(mlp_raw["jcfg"], jnp.asarray(STEP))

    def loss_of(grad, hess, norm):
        out = ((norm(grad) - 1.0) ** 2).mean()
        return out + (abs(hess.sum(-1)).mean() if hess is not None else 0.0)

    def jloss(params):
        _, _, g, h = jm.sdf_gradients(params, jnp.asarray(pos), jsched, True)
        return loss_of(g, h, lambda v: jnp.linalg.norm(v, axis=-1))

    jgrads = jax.grad(jloss)(mlp_raw["params"]["model"])["surface_field"]["field"]["mlp"]
    mlp = tm.surface_field.field.mlp
    for p in mlp.parameters():
        p.grad = None
    _, _, g, h = tm.sdf_gradients(torch.from_numpy(pos),
                                  ttrain.make_schedules(mlp_raw["tcfg"], STEP), train=True)
    loss_of(g, h, lambda v: torch.linalg.vector_norm(v, dim=-1)).backward()
    reached = 0
    for name, p in mlp.named_parameters():
        layer, leaf = name.split(".")
        ref = np.asarray(jgrads[layer][leaf])
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        if not np.linalg.norm(ref) > 0:  # the last bias moves no gradient
            assert np.abs(got).max() == 0.0, name
            continue
        reached += 1
        err = rel_l2(got, ref)
        assert err <= 1e-3, (name, err)
    assert reached == 3 * 4 - 1


@pytest.mark.parametrize("conf", ["confs/mlp_raw.yaml", "confs/grid_raw.yaml"])
def test_remat_gives_the_same_gradients(conf):
    """One batch through the port with remat on and off, on the same
    parameters: every gradient within rel-L2 1e-6."""
    _, tcfg = configs(conf, width=32)
    ds = tmake_dataset(MODS, num_views=3, height=8, width=8, raw=True, device="cpu")
    batch = numpy_batch(ds, tcfg.datamanager.num_rays_per_modality, 3)
    cams = {m: ds.data[m].cameras for m in MODS}
    gen = torch.Generator().manual_seed(0)
    runs = []
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, model=dataclasses.replace(tcfg.model, remat=remat))
        model = tmodel.MMSModel(cfg.model, device="cpu").init(torch.Generator().manual_seed(1))
        with torch.no_grad():  # make the hash tables matter
            for name, p in model.named_parameters():
                if name.endswith("table"):
                    p.mul_(1e3)
        poses = {m: p.requires_grad_(True) for m, p in init_camera_poses(
            cfg.datamanager.camera_optimizer, MODS, {m: 3 for m in MODS}, device="cpu").items()}
        runs.append(ttrain.batch_loss_and_grads(cfg, model, cams, poses, batch, STEP,
                                                ttrain.make_schedules(cfg, STEP), gen))
    assert float(runs[0][0]) == float(runs[1][0])
    for group in ("fields", "camera_poses"):
        for key, g in runs[0][3][group].items():
            ref = runs[1][3][group][key]
            assert torch.isfinite(g).all(), key
            assert rel_l2(g.numpy(), ref.numpy()) <= 1e-6, key
