"""The committed rehearsal checkpoints, converted for the port by
convert_checkpoints.py: for each run its JAX config prints the run's
config.yaml (apart from the lines the converter lists with a reason), and
the committed weights file (checkpoints/step-*.pt beside the orbax
directory) holds exactly the orbax restore's params, bit for bit, at the
checkpoint's step, in the port's model. The grid runs are held here;
rehearsal_mlp_dense, whose JAX template takes longer to build, in
tests/test_torch_converted_mlp_checkpoint.py.
"""

import os

import numpy as np
import pytest
import torch

import jax

import convert_checkpoints as cc
from multimodalstudio_tpu.configs.config import config_to_string

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(cc.REHEARSALS))
def test_converter_config_check_passes(name):
    cfg = cc.jax_config(name)
    cc.check_config(name, cfg)
    added, removed = cc.config_diff(name, config_to_string(cfg))
    assert added == removed == []
    # the listed lines are printed today, and each has its reason
    for line, reason in cc.LINES_ADDED.get(name, {}).items():
        assert line in config_to_string(cfg).splitlines() and reason


def assert_weights_file_is_the_orbax_restore(name):
    r = cc.REHEARSALS[name]
    state = cc.restore(name)
    assert int(state.step) == r["step"]
    path = os.path.join(r["run"], "checkpoints", f"step-{r['step']:09d}.pt")
    ckpt = torch.load(path, weights_only=True)
    assert set(ckpt) == {"params", "step"} and ckpt["step"] == r["step"]
    model = cc.port_model(name)
    assert set(ckpt["params"]["model"]) == set(model.state_dict())
    flat = {}

    def walk(node, prefix=""):
        for k, v in node.items():
            if hasattr(v, "items"):
                walk(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(jax.tree.map(np.asarray, state.params["model"]))
    assert set(flat) == set(ckpt["params"]["model"])
    for key, value in flat.items():
        got = ckpt["params"]["model"][key]
        assert got.dtype == torch.float32 and value.dtype == np.float32, key
        assert np.array_equal(got.numpy(), value), key
    assert set(ckpt["params"]["camera_poses"]) == set(state.params["camera_poses"])
    model.load_state_dict(ckpt["params"]["model"])


@pytest.mark.parametrize("name", ["rehearsal_grid_dense", "rehearsal_grid_packed_confirm"])
def test_weights_file_is_the_orbax_restore_bit_for_bit(name):
    assert_weights_file_is_the_orbax_restore(name)
