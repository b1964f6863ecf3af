"""Port's slot-grid geometry and fused slot SDF kernels (K2, K3) against
the JAX package.

The geometry's entry index must be bit-identical to slot_geometry; its
trilerp weights agree to f32 rounding. The plain K2/K3 versions are held
against the Pallas kernels in interpret mode at the scale of
tests/test_slot_fused.py: a 3-level grid with one dense and two hashed
levels, F=2 features per entry and a bf16 table scaled up 1e4 so the grid
features matter. Both sides round to bf16 at the same points; they differ
by summation order (f32 sums that flip an occasional bf16 rounding) and by
the trilerp weight formula's last f32 bit. Measured rel-L2 is ~1e-7; sdf,
geo and grad are held to rel-L2 <= 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodalstudio_tpu.ops.pallas import slot_fused as jsf
from multimodalstudio_tpu.ops.pallas import slot_grid as jsg
from multimodalstudio_tpu_torch.ops.kernels import slot_fused as tsf
from multimodalstudio_tpu_torch.ops.kernels import slot_grid as tsg

torch.set_num_threads(1)

SPEC_ARGS = dict(num_levels=3, min_res=4, max_res=16, rows_per_level=64, layout="cell",
                 feats=2, table_dtype="bf16")
JSPEC = jsg.SlotGridSpec(**SPEC_ARGS)
TSPEC = tsg.SlotGridSpec(**SPEC_ARGS)
PE = dict(num_frequencies=4, min_freq_exp=0.0, max_freq_exp=3.0)
HID, D_OUT, R = 128, 65, 1.0
REL = 1e-4


def rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def inputs(seed, n=29):
    rng = np.random.default_rng(seed)
    d_in = 3 + 6 * PE["num_frequencies"] + JSPEC.out_dim
    dims = [(d_in, HID), (HID, HID), (HID, D_OUT)]
    ws = [(0.3 * rng.normal(size=d)).astype(np.float32) for d in dims]
    bs = [(0.1 * rng.normal(size=(d[1],))).astype(np.float32) for d in dims]
    table = (rng.uniform(-1.0, 1.0, size=(JSPEC.total_rows, 128)) * 1e-4 * 1e4).astype(np.float32)
    # positions reach past +-r, where the grid coordinate clips
    pos = rng.uniform(-1.2, 1.2, size=(n, 3)).astype(np.float32)
    return pos, table, ws, bs


def both(pos, table, ws, bs):
    j = (jnp.asarray(pos), jnp.asarray(table), [jnp.asarray(w) for w in ws],
         [jnp.asarray(b) for b in bs])
    t = (torch.from_numpy(pos), torch.from_numpy(table), [torch.from_numpy(w) for w in ws],
         [torch.from_numpy(b) for b in bs])
    return j, t


def test_spec_properties_match():
    for name in ("resolutions", "level_entries", "level_rows", "level_offsets"):
        np.testing.assert_array_equal(getattr(TSPEC, name), getattr(JSPEC, name))
    assert TSPEC.total_rows == JSPEC.total_rows
    dense = TSPEC.resolutions.astype(np.int64) ** 3 <= TSPEC.rows_per_level
    assert dense.tolist() == [True, False, False]


def test_geometry_entry_index_bit_identical():
    rng = np.random.default_rng(0)
    x = np.clip(rng.uniform(-0.1, 1.1, size=(257, 3)), 0.0, 1.0 - 1e-6).astype(np.float32)
    jidx, jw, jdw = jsg.slot_geometry(jnp.asarray(x), JSPEC)
    tidx, tw, tdw = tsg.slot_geometry(torch.from_numpy(x), TSPEC)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx).astype(np.int64))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("num_levels,active", [(None, None), (2, 1), (3, 2)])
def test_value_plain_matches_pallas(num_levels, active):
    pos, table, ws, bs = inputs(1)
    k = JSPEC.num_levels if num_levels is None else num_levels
    mask = None if active is None else (np.arange(k * 2) // 2 < active).astype(np.float32)
    (jp, jt, jw, jb), (tp, tt, tw, tb) = both(pos, table, ws, bs)
    ref = jsf.fused_slot_sdf_value(
        jp, jt, jw, jb, JSPEC, radius=R, **PE,
        level_mask=None if mask is None else jnp.asarray(mask), num_levels=num_levels,
    )
    got = tsf.fused_slot_sdf_value(
        tp, tt, tw, tb, TSPEC, radius=R, **PE,
        level_mask=None if mask is None else torch.from_numpy(mask), num_levels=num_levels,
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == (pos.shape[0],)
    assert rel_l2(got.numpy(), ref) <= REL


@pytest.mark.parametrize("active", [None, 2])
def test_chain_plain_matches_pallas(active):
    pos, table, ws, bs = inputs(2)
    mask = None if active is None else (np.arange(6) // 2 < active).astype(np.float32)
    (jp, jt, jw, jb), (tp, tt, tw, tb) = both(pos, table, ws, bs)
    rsdf, rgeo, rgrad = jsf.fused_slot_sdf_chain(
        jp, jt, jw, jb, JSPEC, radius=R, **PE,
        level_mask=None if mask is None else jnp.asarray(mask),
    )
    sdf, geo, grad = tsf.fused_slot_sdf_chain(
        tp, tt, tw, tb, TSPEC, radius=R, **PE,
        level_mask=None if mask is None else torch.from_numpy(mask),
    )
    assert geo.dtype == torch.bfloat16 and tuple(geo.shape) == (pos.shape[0], D_OUT - 1)
    assert rel_l2(sdf.numpy(), rsdf) <= REL
    assert rel_l2(geo.float().numpy(), np.asarray(rgeo, np.float32)) <= REL
    assert rel_l2(grad.numpy(), rgrad) <= REL

