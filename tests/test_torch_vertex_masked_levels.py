"""K6v's plain backward with cotangents zero past an active level, against
JAX's vjp of the vertex-layout lookup.

Training masks every grid level at or past the active one (FeatureGrid's
coarse-to-fine mask), so the lookup's cotangents are zero there. The card's
backward skips such a (sample, level): it reads no row, adds nothing to the
table gradient and writes zero d_w and d_dw. That is exact only if the
function itself gives exact zeros there, which this test holds on the
port's plain backward and on JAX's: the op behind slot_grid_lookup's custom
VJP (its Pallas kernels in interpret mode, as tests/test_torch_slot_vertex.py
runs them) differentiated by jax.vjp in table, w and dw, on the same numpy
inputs: a 3-level vertex grid (level 0 dense, levels 1 and 2 hashed), F = 16,
an f32 table, 29 positions, with and without tangents, 1 or 2 active levels.
The active levels agree within the 1e-5 of tests/test_torch_slot_vertex.py
(both exact f32, differing in summation order only).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import jax

from multimodalstudio_tpu.ops.pallas import slot_grid as jslot

from multimodalstudio_tpu_torch.ops.kernels import slot_grid as tslot

from test_torch_slot_vertex import N, TOL, inputs, rel_l2, specs

torch.set_num_threads(1)

BLOCK = jslot.DEFAULT_BLOCK


def jax_vjp(js, table, x, tangents):
    """(idx, w, dw, vjp) of the lookup op on the geometry of x: vjp maps
    (genc[, gtenc]) to (d_table, d_w[, d_dw]) over the first N samples."""
    k = js.num_levels
    idx, w, dw = (np.array(a) for a in jslot.slot_geometry(jnp.asarray(x), js, k))
    pad = ((0, -N % BLOCK), (0, 0))
    pi, pw, pdw = (jnp.asarray(np.pad(a, pad)) for a in (idx, w, dw))
    lv = tuple((int(o), int(r)) for o, r in zip(js.level_offsets[:k], js.level_rows[:k]))
    op = jslot._lookup_fn(k, js.total_rows, BLOCK, True, 3 if tangents else 0, False, lv, False,
                          js.feats, js.entries_per_row, False)
    if tangents:
        _, f = jax.vjp(lambda t, a, b: op(t, pi, a, b), jnp.asarray(table), pw, pdw)
    else:
        _, f = jax.vjp(lambda t, a: op(t, pi, a), jnp.asarray(table), pw)

    def vjp(*cots):
        out = f(tuple(jnp.asarray(np.pad(c, pad)) for c in cots) if tangents
                else jnp.asarray(np.pad(cots[0], pad)))
        return [np.asarray(out[0])] + [np.asarray(o)[:N] for o in out[1:]]

    return idx, w, dw, vjp


@pytest.fixture(scope="module", params=[True, False], ids=["tangents", "no_tangents"])
def reference(request):
    js, ts = specs()
    table, x = inputs(js, seed=7)
    return ts, table, request.param, jax_vjp(js, table, x, request.param)


@pytest.mark.parametrize("active", [1, 2])
def test_masked_levels_give_exact_zeros(reference, active):
    ts, table, tangents, (idx, w, dw, vjp) = reference
    k, feats = ts.num_levels, ts.feats
    rng = np.random.default_rng(8 + active)
    live = (np.arange(k * feats) < active * feats).astype(np.float32)
    genc = rng.normal(size=(N, k * feats)).astype(np.float32) * live
    gtenc = (rng.normal(size=(N, 3, k * feats)).astype(np.float32) * live).reshape(N, -1)
    cots = (genc, gtenc) if tangents else (genc,)
    want = vjp(*cots)
    got = tslot.slot_lookup_vertex_bwd_plain(
        torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(w),
        torch.from_numpy(dw) if tangents else None, torch.from_numpy(genc),
        torch.from_numpy(gtenc) if tangents else None)
    got = [g.numpy() for g in got if g is not None]
    masked_rows = slice(int(ts.level_offsets[active]), None)
    for side in (got, want):
        # exactly zero on the masked levels: d_table's rows, d_w's and d_dw's columns
        assert not side[0][masked_rows].any()
        assert not side[1].reshape(N, k, 8)[:, active:].any()
        if tangents:
            assert not side[2].reshape(N, 3, k, 8)[:, :, active:].any()
        # and the active levels receive something
        assert side[0][:masked_rows.start].any() and side[1].reshape(N, k, 8)[:, :active].any()
    for g, r in zip(got, want):
        assert rel_l2(g, r) <= TOL
