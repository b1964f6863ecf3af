"""Port's slot-grid lookup (K6) against the JAX Pallas kernel.

The plain PyTorch version (what a CPU tensor runs) and its autograd are
held against multimodalstudio_tpu's slot_grid_lookup in Pallas interpret
mode (as tests/test_slot_grid.py runs it) on the same numpy inputs: a
3-level cell-layout grid (resolutions 4, 8, 16, 64 entries per level) with
packed F = 2 entries, 29 positions, the table scaled to +-1. Covered: the
bf16 table of grid_raw_tpu and the f32 table, with and without tangents, a
truncated num_levels, FeatureGrid's rescale and coarse-to-fine mask, and
the VJP into the table and the positions of a loss on enc and tenc (the
positions' gradient carries the second-order term through dw).

In bf16-table mode both sides round at the same points and sum 8 corners
in f32 in another order: measured rel-L2 6e-9 (enc), 1.4e-8 (tenc), 0 (d
table), 5.6e-8 (d x); tolerance 1e-5. The f32 table is exact f32 here and
the TPU's hi/lo bf16 split (about 2^-16) there: measured 3.7e-6 to 4.4e-6
forward, 1.3e-4 (d table) and 8.7e-5 (d x); tolerance 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodalstudio_tpu.fields.components import FeatureGrid as JFeatureGrid
from multimodalstudio_tpu.fields.components import FeatureGridSpec as JFeatureGridSpec
from multimodalstudio_tpu.ops.pallas import slot_grid as jslot
from multimodalstudio_tpu_torch.fields.components import FeatureGrid, FeatureGridSpec
from multimodalstudio_tpu_torch.ops.kernels import build
from multimodalstudio_tpu_torch.ops.kernels import slot_grid as tslot

torch.set_num_threads(1)

N = 29
TOL = {"bf16": 1e-5, "f32": 1e-3}


def rel_l2(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def specs(table_dtype="bf16", **over):
    kw = dict(num_levels=3, min_res=4, max_res=16, rows_per_level=64, layout="cell", feats=2,
              table_dtype=table_dtype)
    kw.update(over)
    return jslot.SlotGridSpec(**kw), tslot.SlotGridSpec(**kw)


def inputs(spec, seed=0, lo=0.01, hi=0.97):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1.0, 1.0, size=(spec.total_rows, 128)).astype(np.float32)
    x = rng.uniform(lo, hi, size=(N, 3)).astype(np.float32)
    return table, x


@pytest.mark.parametrize("table_dtype", ["bf16", "f32"])
def test_plain_lookup_matches_pallas(table_dtype):
    js, ts = specs(table_dtype)
    table, x = inputs(js)
    jt, jx = jnp.asarray(table), jnp.asarray(x)
    tt, tx = torch.from_numpy(table), torch.from_numpy(x)
    tol = TOL[table_dtype]
    enc, tenc = jslot.slot_grid_lookup(jt, jx, js, with_tangents=True)
    got_enc, got_tenc = tslot.slot_grid_lookup(tt, tx, ts, with_tangents=True)
    assert tuple(got_enc.shape) == (N, 6) and tuple(got_tenc.shape) == (3, N, 6)
    assert rel_l2(got_enc, enc) <= tol and rel_l2(got_tenc, tenc) <= tol
    # two of three levels, without tangents: the last level's columns are zero
    ref = jslot.slot_grid_lookup(jt, jx, js, num_levels=2)
    got = tslot.slot_grid_lookup(tt, tx, ts, num_levels=2)
    assert float(got[:, 4:].abs().max()) == 0.0
    assert rel_l2(got, ref) <= tol


@pytest.mark.parametrize("table_dtype", ["bf16", "f32"])
def test_lookup_vjp_matches_jax_grad(table_dtype):
    """d table and d x of a loss on enc and tenc (tenc's term reaches x
    through dw: the second-order path of the custom VJP)."""
    js, ts = specs(table_dtype)
    table, x = inputs(js, seed=1)
    g = np.random.default_rng(2).normal(size=(N, 6)).astype(np.float32)

    def loss(enc, tenc, xp):
        return xp.sum(xp.sin(enc) * xp.asarray(g)) + xp.sum(xp.cos(0.1 * tenc))

    ref = jax.grad(lambda t, p: loss(*jslot.slot_grid_lookup(t, p, js, with_tangents=True), jnp),
                   argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))
    tt = torch.tensor(table, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    loss(*tslot.slot_grid_lookup(tt, tx, ts, with_tangents=True), torch).backward()
    assert float(tt.grad.abs().max()) > 0 and float(tx.grad.abs().max()) > 0
    assert rel_l2(tt.grad, ref[0]) <= TOL[table_dtype]
    assert rel_l2(tx.grad, ref[1]) <= TOL[table_dtype]


def test_feature_grid_matches_jax():
    """Rescale from [-r, r] with the clamp (positions past the radius), 2
    of 3 levels (max_level) and the coarse-to-fine mask at active level 1."""
    js, ts = specs()
    table, _ = inputs(js)
    x = np.random.default_rng(3).uniform(-1.1, 1.1, size=(N, 3)).astype(np.float32)
    jgrid = JFeatureGrid(JFeatureGridSpec(encoding=js, radius=1.0))
    ref = jgrid.apply({"params": {"encoding": {"table": jnp.asarray(table)}}}, jnp.asarray(x), 1, 2)
    grid = FeatureGrid(FeatureGridSpec(encoding=ts, radius=1.0))
    with torch.no_grad():
        grid.encoding.table.copy_(torch.from_numpy(table))
        got = grid(torch.from_numpy(x), 1, 2)
    assert float(got[:, 2:].abs().max()) == 0.0 and float(got[:, :2].abs().max()) > 0
    assert rel_l2(got, ref) <= TOL["bf16"]


def test_function_backward_is_the_plain_backward():
    """The Function hands its cotangents to the plain backward on the CPU
    and returns d table, d w and d dw; idx gets none."""
    _, ts = specs()
    table, x = inputs(ts, seed=4)
    idx, w, dw = tslot.slot_geometry(torch.from_numpy(x), ts)
    rng = np.random.default_rng(5)
    genc = torch.from_numpy(rng.normal(size=(N, 6)).astype(np.float32))
    gtenc = torch.from_numpy(rng.normal(size=(N, 18)).astype(np.float32))
    tt = torch.tensor(table, requires_grad=True)
    wr, dwr = w.clone().requires_grad_(True), dw.clone().requires_grad_(True)
    enc, tenc = tslot._Lookup.apply((2, True), tt, idx, wr, dwr)
    torch.autograd.backward([enc, tenc], [genc, gtenc])
    d_table, d_w, d_dw = tslot.slot_lookup_bwd_plain(torch.from_numpy(table), idx, w, dw, genc,
                                                     gtenc, feats=2, bf16=True)
    assert torch.equal(tt.grad, d_table) and torch.equal(wr.grad, d_w)
    assert torch.equal(dwr.grad, d_dw)
    # a sample's cotangent reaches only its own entry's 16 lanes of the packed row
    rows = d_table.reshape(-1, 16).abs().sum(-1) > 0
    assert set(torch.nonzero(rows).flatten().tolist()) <= set(idx.flatten().tolist())


def test_vertex_layout_raises_and_cpu_counts_no_launch():
    _, ts = specs(table_dtype="f32", layout="vertex", feats=16, gather="copy")
    table, x = inputs(ts)
    with pytest.raises(NotImplementedError, match="cell layout"):
        tslot.slot_grid_lookup(torch.from_numpy(table), torch.from_numpy(x), ts)
    _, ts = specs()
    table, x = inputs(ts)
    build.reset_launch_counts()
    tslot.slot_grid_lookup(torch.from_numpy(table), torch.from_numpy(x), ts, with_tangents=True)
    assert build.KERNELS["slot_grid_lookup"].launches == 0
