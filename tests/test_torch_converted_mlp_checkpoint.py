"""rehearsal_mlp_dense's committed weights file against the orbax restore,
bit for bit (tests/test_torch_converted_checkpoints.py holds the grid
runs; this one runs in a file of its own, as its JAX template, the 8-layer
SDF and trunk of mlp_raw_tpu, takes about 30 s to build on one core)."""

import torch

from test_torch_converted_checkpoints import assert_weights_file_is_the_orbax_restore

torch.set_num_threads(1)


def test_weights_file_is_the_orbax_restore_bit_for_bit():
    assert_weights_file_is_the_orbax_restore("rehearsal_mlp_dense")
