"""rehearsal_grid_dense (f32 slot table, K3f) on trained weights against the
JAX package: tests/test_torch_trained_fields.py's checks, in a file of its
own so the two interpret-mode runs go to separate workers."""

import pytest
import torch

from test_torch_trained_fields import assert_trained_fields_match

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["rehearsal_grid_dense"])
def test_trained_fields_match_jax(name):
    assert_trained_fields_match(name)
