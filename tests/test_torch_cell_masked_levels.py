"""K6's plain backward and the split's plain table scatter with cotangents
zero past an active level, against the JAX package on the cell layout.

Training masks every grid level at or past the active one (FeatureGrid's
coarse-to-fine mask), so the lookup's cotangents, and the split backward's
per-sample table cotangent, are zero there. The card's K6 backward skips
such a (sample, level): it reads no entry, adds nothing to the table
gradient and writes zero d_w and d_dw; the card's scatter skips an all-zero
chunk. That is exact only if the functions themselves give exact zeros
there, which this test holds on the port's plain versions and on JAX's, on
the same numpy inputs (tests/test_torch_slot_grid.py's 3-level cell grid:
level 0 dense, levels 1 and 2 hashed, F = 2, 29 positions), for a bf16 and
an f32 table and 1 or 2 active levels:

* K6: the op behind slot_grid_lookup's custom VJP (its Pallas kernels in
  interpret mode, as tests/test_torch_slot_grid.py runs them) differentiated
  by jax.vjp in table, w and dw, with tangents;
* the scatter: JAX's split scatter body (_bwd_scatter_kernel, slot_fused.py
  :925) in interpret mode on the same per-sample cotangent, laid out in its
  entry group's lanes, against slot_table_scatter_plain.

The live levels agree within tests/test_torch_slot_grid.py's limits: 1e-5
for a bf16 table (the same roundings, f32 sums in another order) and 1e-3
for an f32 one (the TPU's bf16 hi/lo split reaches f32 to about 2^-16).
"""

import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from multimodalstudio_tpu.ops.pallas import slot_fused as jsf
from multimodalstudio_tpu.ops.pallas import slot_grid as jslot

from multimodalstudio_tpu_torch.ops.kernels import slot_fused as tsf
from multimodalstudio_tpu_torch.ops.kernels import slot_grid as tslot

from test_torch_slot_grid import N, TOL, inputs, rel_l2, specs

torch.set_num_threads(1)

BLOCK = jslot.DEFAULT_BLOCK
RADIUS = 1.0


def jax_vjp(js, table, x):
    """(idx, w, dw, vjp) of the cell lookup op with tangents on the geometry
    of x: vjp maps (genc, gtenc) to (d_table, d_w, d_dw) over the first N
    samples."""
    k = js.num_levels
    idx, w, dw = (np.array(a) for a in jslot.slot_geometry(jnp.asarray(x), js, k))
    pad = ((0, -N % BLOCK), (0, 0))
    pi, pw, pdw = (jnp.asarray(np.pad(a, pad)) for a in (idx, w, dw))
    lv = tuple((int(o), int(r)) for o, r in zip(js.level_offsets[:k], js.level_rows[:k]))
    op = jslot._lookup_fn(k, js.total_rows, BLOCK, True, 3, True, lv, True, js.feats,
                          js.entries_per_row, js.table_dtype == "bf16")
    _, f = jax.vjp(lambda t, a, b: op(t, pi, a, b), jnp.asarray(table), pw, pdw)

    def vjp(genc, gtenc):
        out = f(tuple(jnp.asarray(np.pad(c, pad)) for c in (genc, gtenc)))
        return [np.asarray(out[0])] + [np.asarray(o)[:N] for o in out[1:]]

    return idx, w, dw, vjp


@pytest.fixture(scope="module", params=["bf16", "f32"])
def lookup(request):
    js, ts = specs(request.param)
    table, x = inputs(js, seed=7)
    return ts, table, x, jax_vjp(js, table, x)


def masked_rows(ts, active):
    """The table rows of the levels at or past `active`."""
    return slice(int(ts.level_offsets[active]), None)


@pytest.mark.parametrize("active", [1, 2])
def test_lookup_masked_levels_give_exact_zeros(lookup, active):
    ts, table, x, (idx, w, dw, vjp) = lookup
    k, feats = ts.num_levels, ts.feats
    # both packages index the same entries
    assert np.array_equal(tslot.slot_geometry(torch.from_numpy(x), ts)[0].numpy(), idx)
    rng = np.random.default_rng(8 + active)
    live = (np.arange(k * feats) < active * feats).astype(np.float32)
    genc = rng.normal(size=(N, k * feats)).astype(np.float32) * live
    gtenc = (rng.normal(size=(N, 3, k * feats)).astype(np.float32) * live).reshape(N, -1)
    want = vjp(genc, gtenc)
    got = tslot.slot_lookup_bwd_plain(
        torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(w),
        torch.from_numpy(dw), torch.from_numpy(genc), torch.from_numpy(gtenc), feats=feats,
        bf16=ts.table_dtype == "bf16")
    got = [g.numpy() for g in got]
    rows = masked_rows(ts, active)
    for side in (got, want):
        # exactly zero on the masked levels: d_table's rows, d_w's and d_dw's columns
        assert not side[0][rows].any()
        assert not side[1].reshape(N, k, 8)[:, active:].any()
        assert not side[2].reshape(N, 3, k, 8)[:, :, active:].any()
        # and the active levels receive something
        assert side[0][:rows.start].any() and side[1].reshape(N, k, 8)[:, :active].any()
    for g, r in zip(got, want):
        assert rel_l2(g, r) <= TOL[ts.table_dtype]


def jax_scatter(js, pos, d_comp, entries):
    """JAX's split scatter (_bwd_scatter_kernel, interpret mode) of the
    per-sample table cotangent d_comp [N, k, 8F] at positions pos [N, 3]:
    each (sample, level)'s 8F values placed in its entry group's lanes of
    the level's 128-lane block (entries: the absolute entry indices)."""
    k, feats, pk = js.num_levels, js.feats, js.entries_per_row
    spec = types.SimpleNamespace(
        geom=jsf._make_geom(js, k, RADIUS),
        lv=tuple((int(o), int(r)) for o, r in zip(js.level_offsets[:k], js.level_rows[:k])))
    b = -(-N // 8) * 8
    pos_p = np.zeros((b, 128), np.float32)
    pos_p[:N, :3] = pos
    lanes = np.zeros((b, k, 128), np.float32)
    for s in range(N):
        for l in range(k):
            g = int(entries[s, l]) % pk
            lanes[s, l, g * 8 * feats:(g + 1) * 8 * feats] = d_comp[s, l]
    call = pl.pallas_call(
        functools.partial(jsf._bwd_scatter_kernel, spec),
        grid=(1,),
        in_specs=[pl.BlockSpec((b, 128), lambda i: (i, 0)),
                  pl.BlockSpec((b, k * 128), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((js.total_rows, 128), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((js.total_rows, 128), jnp.float32),
        interpret=True,
    )
    out = call(jnp.asarray(pos_p), jnp.asarray(lanes.reshape(b, k * 128)))
    return np.asarray(out[0] if isinstance(out, (list, tuple)) else out)


@pytest.mark.parametrize("active", [1, 2])
@pytest.mark.parametrize("table_dtype", ["bf16", "f32"])
def test_scatter_zero_chunks_give_exact_zeros(table_dtype, active):
    js, ts = specs(table_dtype)
    rng = np.random.default_rng(11 + active)
    pos = rng.uniform(-1.1, 1.1, size=(N, 3)).astype(np.float32)
    k, width = ts.num_levels, 8 * ts.feats
    live = (np.arange(k) < active).astype(np.float32)[None, :, None]
    d_comp = torch.from_numpy(rng.normal(size=(N, k, width)).astype(np.float32) * live)
    d_comp[::5, 0] = 0.0  # zero chunks on a live level too
    d_comp = d_comp.to(torch.bfloat16 if table_dtype == "bf16" else torch.float32)
    got = tsf.slot_table_scatter_plain(torch.from_numpy(pos), d_comp, ts, radius=RADIUS).numpy()
    entries = tslot.cell_factors(tsf._cell_coords(torch.from_numpy(pos), RADIUS)[0], ts)[0]
    want = jax_scatter(js, pos, d_comp.float().numpy(), entries.numpy())
    rows = masked_rows(ts, active)
    for side in (got, want):
        assert not side[rows].any()
        assert side[:rows.start].any()
    # an entry that only zero chunks reach stays exactly zero in both
    hit = np.zeros(ts.total_rows * 128 // width, bool)
    nz = d_comp.float().reshape(N, k, width).abs().sum(-1).numpy() > 0
    hit[entries.numpy()[nz]] = True
    cold = ~hit.reshape(ts.total_rows, -1).repeat(width, axis=1)
    assert not got[cold].any() and not want[cold].any()
    assert rel_l2(got, want) <= TOL[table_dtype]
