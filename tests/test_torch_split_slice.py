"""grid_raw_tpu's training batch under MMS_SLOT_BWD_SPLIT=1, the slice as a
whole: the losses and every gradient group of one tiny batch through both
packages' loss-and-gradient functions, each with the variable set, so that
the curvature taps' K2 and the render samples' K3 take the split backward
in both.

The configuration is tests/test_torch_train.py's tiny() grid_raw_tpu (a
3-level slot grid, hidden widths 128, 3 modalities, 4 rays per modality in
2 microbatches); the parameters and the batch (seed 5) come from
tests/test_torch_mlp_raw.py's carry() and batch_run(): the port's init
moved by numpy noise, carried to JAX through convert.params_from_jax. JAX
runs its Pallas kernels in interpret mode, the port the plain versions of
its split backward. Tolerances as the merged slice is held
(tests/test_torch_train.py): losses rel 1e-2; each gradient group within
max(3e-2, twice the port's distance to itself with its parameters moved by
1e-6, three draws). The split's own difference from the merged backward
(d_bs of the SDF head, about 2e-3) is below that; the kernel tests of
tests/test_torch_slot_split.py resolve it. Measured: losses within rel
1.8e-3; the SDF head 5.0e-4, the table 9.8e-4, every field group within
1.1e-2; the poses 2.8e-3 to 2.9e-2 (mono, against a noise of 3.3e-2).
"""

import pytest
import torch

import multimodalstudio_tpu_torch.ops.kernels.slot_fused as tsf

from test_torch_mlp_raw import assert_gradients_match, batch_run, carry
from test_torch_train import JCFG, MODS, TCFG

torch.set_num_threads(1)

SPLIT_PLAINS = ("slot_sdf_value_bwd_split_plain", "slot_sdf_chain_bwd_split_plain")
MERGED_PLAINS = ("slot_sdf_value_bwd_plain", "slot_sdf_chain_bwd_plain")


@pytest.fixture(scope="module")
def split_run():
    """One batch (seed 5) through both packages under the variable, and the
    port's moved runs, its backward plains counted."""
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMS_SLOT_BWD_SPLIT", "1")
        for name in SPLIT_PLAINS + MERGED_PLAINS:
            real = getattr(tsf, name)
            mp.setattr(tsf, name, lambda *a, real=real, name=name, **k:
                       calls.append(name) or real(*a, **k))
        run = batch_run(carry(JCFG, TCFG), 5)
    return dict(run, calls=calls)


def test_split_slice_takes_the_split_backward(split_run):
    """Per microbatch one split K2 backward (the curvature taps) and one split
    K3 backward (the render samples), and no merged one, in the port's run
    and each of its three moved runs."""
    microbatches = TCFG.datamanager.num_rays_per_modality // TCFG.datamanager.microbatch_rays
    assert sorted(split_run["calls"]) == sorted(SPLIT_PLAINS * microbatches * 4)


def test_split_slice_losses_match_jax(split_run):
    jtotal, jlo, jmet, _ = split_run["j"]
    ttotal, tlo, tmet, _ = split_run["t"]
    assert set(tlo) == set(jlo)
    assert {"eikonal_loss", "curvature_loss"} <= set(tlo)
    for k in jlo:
        ref = float(jlo[k])
        assert abs(float(tlo[k]) - ref) <= 1e-2 * abs(ref), k
    assert abs(float(ttotal) - float(jtotal)) <= 1e-2 * abs(float(jtotal))
    assert set(tmet) == set(jmet)
    for k in jmet:
        assert abs(float(tmet[k]) - float(jmet[k])) <= 1e-2 * abs(float(jmet[k])), k


def test_split_slice_gradients_match_jax(split_run):
    """Each group within max(3e-2, twice the port's distance to itself with
    its parameters moved by 1e-6)."""
    groups = assert_gradients_match(split_run["j"][3], split_run["t"][3], split_run["moved"], MODS)
    assert {"table", "variance", "surface_field.field.grid_mlp.mlp_head",
            "radiance_field.base_field.mlp", "heads.polarization.field",
            "background_field.base_field.mlp"} <= set(groups)
