"""The port's reference grid variants against the JAX package, with
tests/test_torch_grid_reference.py's cut, carry and tolerances: grid on
demosaicked frames (one training batch's losses and gradient groups), and
grid_raw_grid_bg_unbalanced, whose background NeRF field is a hash grid of
radius 2 without position encoding (the field at contracted positions,
then the eval forward of the whole model)."""

import numpy as np
import torch

import jax.numpy as jnp

from test_torch_grid_reference import (
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


def test_grid_demosaicked_batch_matches_jax():
    """grid on demosaicked frames: every channel of a pixel is supervised
    (select_mosaick_channels keeps the renders whole)."""
    c = carry(*configs("confs/grid.yaml"), raw=False)
    assert not c["tcfg"].datamanager.raw
    run = batch_run(c, 7)
    assert_losses_match(run)
    assert_gradients_match(run["j"][3], run["t"][3], run["moved"])


def test_hash_grid_background_matches_jax():
    """The background NeRF field on its hash grid (radius 2, no position
    encoding) at contracted positions out to radius 2, then the eval
    forward of the whole model."""
    c = carry(*configs(method="grid_raw_grid_bg_unbalanced"))
    bf = c["tcfg"].model.background.field
    assert not bf.use_position_encoding and bf.base_field.grid.radius == 2.0
    rng = np.random.default_rng(3)
    pos = rng.uniform(-1.99, 1.99, size=(64, 3)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    jd, jf = c["jm"].background_field.apply({"params": c["params"]["model"]["background_field"]},
                                            jnp.asarray(pos), jnp.asarray(dirs))
    with torch.no_grad():
        td, tf = c["model"].background_field(torch.from_numpy(pos), torch.from_numpy(dirs))
    for name, a, b in (("density", td, jd), ("feature", tf, jf)):
        err = rel_l2(a.numpy(), np.asarray(b))
        assert err <= TOL, (name, err)
    assert_outputs_match(*eval_forward(c, seed=4))
