"""Port's vertex-layout slot-grid lookup (K6v) against the JAX Pallas kernel.

The vertex layout (exact C0) keeps one grid vertex's 16 features per
row, 2 x 2 x 2 vertices sharing a row by parity, so a cell's 8 corners
read 8 rows. The port's geometry, its plain lookup (what a CPU tensor
runs) and their autograd are held against multimodalstudio_tpu's
slot_geometry and slot_grid_lookup in Pallas interpret mode (as
tests/test_slot_grid.py runs them) on the same numpy inputs: a 3-level
grid (resolutions 4, 8, 16; 64 rows per level, so level 0's 3^3 vertex
groups are dense and levels 1 and 2 hashed), F = 16, an f32 table scaled
to +-1, 29 positions. idx must equal JAX's exactly: a port that took slot
p for offset bits p instead of parity p would give a smooth field, but a
permuted one, which only this comparison catches.

Both sides run exact f32 (the TPU's copy gather and float32 dots) and
differ by summation order only. Measured rel-L2: enc 6.6e-8, tenc
7.1e-8, enc on 2 levels 5.8e-8, d table 9.8e-8, d x 1.4e-7; w and dw
equal JAX's exactly. Tolerance 1e-5 (1e-6 abs for w and dw).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multimodalstudio_tpu.configs.methods as jmethods
import multimodalstudio_tpu.models.model as jmodel
import multimodalstudio_tpu.models.samplers as jsamplers
from multimodalstudio_tpu.fields.components import FeatureGrid as JFeatureGrid
from multimodalstudio_tpu.fields.components import FeatureGridSpec as JFeatureGridSpec
from multimodalstudio_tpu.ops.pallas import slot_grid as jslot

import multimodalstudio_tpu_torch.configs.methods as tmethods
import multimodalstudio_tpu_torch.models.model as tmodel
import multimodalstudio_tpu_torch.models.samplers as tsamplers
from multimodalstudio_tpu_torch.convert import params_from_jax
from multimodalstudio_tpu_torch.fields.components import FeatureGrid, FeatureGridSpec
from multimodalstudio_tpu_torch.ops.kernels import build
from multimodalstudio_tpu_torch.ops.kernels import slot_grid as tslot

from test_torch_mlp_raw import _flatten, _unflatten
from test_torch_train import tiny

torch.set_num_threads(1)

N = 29
TOL = 1e-5
VERTEX = dict(layout="vertex", feats=16, table_dtype="f32")
SMALL = dict(num_levels=3, min_res=4, max_res=16, rows_per_level=64)
VERTEX_KERNELS = ("slot_grid_lookup_vertex", "slot_grid_lookup_vertex_bwd")


def rel_l2(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def specs(**over):
    kw = dict(SMALL, **VERTEX)
    kw.update(over)
    return jslot.SlotGridSpec(**kw), tslot.SlotGridSpec(**kw)


def inputs(spec, seed=0, lo=0.01, hi=0.97):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1.0, 1.0, size=(spec.total_rows, 128)).astype(np.float32)
    x = rng.uniform(lo, hi, size=(N, 3)).astype(np.float32)
    return table, x


def test_spec_has_a_dense_and_hashed_levels():
    js, ts = specs()
    assert list(ts.level_entries) == list(js.level_entries) == [27, 64, 64]
    assert ts.total_rows == js.total_rows == 32 + 64 + 64
    assert ts.resolved_gather == "copy"


@pytest.mark.parametrize("interpolation", ["Smoothstep", "Linear"])
def test_vertex_geometry_matches_jax(interpolation):
    """idx exactly, w and dw within 1e-6; the positions include the grid's
    edges (0 and just below 1) and a truncated level count."""
    js, ts = specs(interpolation=interpolation)
    _, x = inputs(ts, seed=3)
    x[:3] = [[0.0, 0.0, 0.0], [tslot.CLIP_HI] * 3, [0.5, 0.25, tslot.CLIP_HI]]
    for k in (None, 2):
        ji, jw, jdw = jslot.slot_geometry(jnp.asarray(x), js, k)
        ti, tw, tdw = tslot.slot_geometry(torch.from_numpy(x), ts, k)
        levels = 3 if k is None else k
        assert tuple(ti.shape) == (N, levels * 8) and ti.dtype == torch.int64
        assert np.array_equal(ti.numpy(), np.asarray(ji))
        assert float(np.abs(tw.numpy() - np.asarray(jw)).max()) <= 1e-6
        assert float(np.abs(tdw.numpy() - np.asarray(jdw)).max()) <= 1e-6
        # every row lies inside its level's rows
        lvl = torch.arange(levels * 8) // 8
        offs, rows = torch.as_tensor(ts.level_offsets)[lvl], torch.as_tensor(ts.level_rows)[lvl]
        assert bool(((ti >= offs) & (ti < offs + rows)).all())


@pytest.fixture(scope="module")
def lookup_ref():
    """JAX's forward with tangents, and on 2 of 3 levels without."""
    js, _ = specs()
    table, x = inputs(js)
    jt, jx = jnp.asarray(table), jnp.asarray(x)
    enc, tenc = jslot.slot_grid_lookup(jt, jx, js, with_tangents=True)
    trunc = jslot.slot_grid_lookup(jt, jx, js, num_levels=2)
    return table, x, enc, tenc, trunc


def test_plain_lookup_matches_pallas(lookup_ref):
    table, x, enc, tenc, _ = lookup_ref
    _, ts = specs()
    got_enc, got_tenc = tslot.slot_grid_lookup(torch.from_numpy(table), torch.from_numpy(x), ts,
                                               with_tangents=True)
    assert tuple(got_enc.shape) == (N, 48) and tuple(got_tenc.shape) == (3, N, 48)
    assert rel_l2(got_enc, enc) <= TOL and rel_l2(got_tenc, tenc) <= TOL


def test_truncated_plain_lookup_matches_pallas(lookup_ref):
    table, x, enc, _, trunc = lookup_ref
    _, ts = specs()
    got = tslot.slot_grid_lookup(torch.from_numpy(table), torch.from_numpy(x), ts, num_levels=2)
    assert float(got[:, 32:].abs().max()) == 0.0
    assert rel_l2(got, trunc) <= TOL
    # the first two levels' columns are those of the full lookup
    assert rel_l2(got[:, :32], np.asarray(enc)[:, :32]) <= TOL


def test_lookup_vjp_matches_jax_vjp():
    """d table and d x of a loss on enc and tenc through jax.vjp (tenc's
    term reaches x through dw: the second-order path of the custom VJP)."""
    js, ts = specs()
    table, x = inputs(js, seed=1)
    rng = np.random.default_rng(2)
    g = rng.normal(size=(N, 48)).astype(np.float32)
    gt = rng.normal(size=(3, N, 48)).astype(np.float32)

    def f(t, p):
        enc, tenc = jslot.slot_grid_lookup(t, p, js, with_tangents=True)
        return jnp.sin(enc), jnp.cos(0.1 * tenc)

    _, vjp = jax.vjp(f, jnp.asarray(table), jnp.asarray(x))
    ref = vjp((jnp.asarray(g), jnp.asarray(gt)))
    tt = torch.tensor(table, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    enc, tenc = tslot.slot_grid_lookup(tt, tx, ts, with_tangents=True)
    torch.autograd.backward([torch.sin(enc), torch.cos(0.1 * tenc)],
                            [torch.from_numpy(g), torch.from_numpy(gt)])
    assert float(tt.grad.abs().max()) > 0 and float(tx.grad.abs().max()) > 0
    assert rel_l2(tt.grad, ref[0]) <= TOL
    assert rel_l2(tx.grad, ref[1]) <= TOL


def test_feature_grid_matches_jax():
    """FeatureGrid on the vertex table: the rescale from [-r, r] with its
    clamp, 2 of 3 levels (max_level) and the coarse-to-fine mask."""
    js, ts = specs()
    table, _ = inputs(js)
    x = np.random.default_rng(3).uniform(-1.1, 1.1, size=(N, 3)).astype(np.float32)
    jgrid = JFeatureGrid(JFeatureGridSpec(encoding=js, radius=1.0))
    ref = jgrid.apply({"params": {"encoding": {"table": jnp.asarray(table)}}}, jnp.asarray(x), 1, 2)
    grid = FeatureGrid(FeatureGridSpec(encoding=ts, radius=1.0))
    with torch.no_grad():
        grid.encoding.table.copy_(torch.from_numpy(table))
        got = grid(torch.from_numpy(x), 1, 2)
    assert float(got[:, 16:].abs().max()) == 0.0 and float(got[:, :16].abs().max()) > 0
    assert rel_l2(got, ref) <= TOL


@pytest.mark.parametrize("face", [0.25, 0.5])
def test_vertex_lookup_is_continuous_across_a_cell_face(face):
    """The vertex layout's point: a vertex reached from the cells on either
    side of a face is the same (row, lane), so enc is continuous there (x =
    0.25 lies on a face of every level, 0.5 on one of every level too). The
    cell layout keeps a copy per cell, and jumps there."""
    eps = 1e-5
    pts = torch.tensor([[face - eps, 0.3, 0.7], [face + eps, 0.3, 0.7]])
    jumps = {}
    for layout in ("vertex", "cell"):
        spec = tslot.SlotGridSpec(**SMALL, **dict(VERTEX, layout=layout))
        table = torch.from_numpy(inputs(spec)[0])
        enc = tslot.slot_grid_lookup(table, pts, spec)
        jumps[layout] = float((enc[0] - enc[1]).abs().max())
    assert jumps["vertex"] < 1e-2
    assert jumps["cell"] > 1e-1


def test_function_backward_is_the_vertex_plain_backward():
    """The Function hands its cotangents to K6v's plain backward on the CPU;
    only the parity lanes of the rows the samples read receive anything."""
    _, ts = specs()
    table, x = inputs(ts, seed=4)
    idx, w, dw = tslot.slot_geometry(torch.from_numpy(x), ts)
    rng = np.random.default_rng(5)
    genc = torch.from_numpy(rng.normal(size=(N, 48)).astype(np.float32))
    gtenc = torch.from_numpy(rng.normal(size=(N, 144)).astype(np.float32))
    tt = torch.tensor(table, requires_grad=True)
    wr, dwr = w.clone().requires_grad_(True), dw.clone().requires_grad_(True)
    enc, tenc = tslot._Lookup.apply((16, False, True), tt, idx, wr, dwr)
    torch.autograd.backward([enc, tenc], [genc, gtenc])
    d_table, d_w, d_dw = tslot.slot_lookup_vertex_bwd_plain(torch.from_numpy(table), idx, w, dw,
                                                            genc, gtenc)
    assert torch.equal(tt.grad, d_table) and torch.equal(wr.grad, d_w)
    assert torch.equal(dwr.grad, d_dw)
    touched = {(int(r), int(p)) for r, p in zip(idx.flatten(), torch.arange(idx.numel()) % 8)}
    rows, lanes = torch.nonzero(d_table, as_tuple=True)
    assert {(int(r), int(c) % 8) for r, c in zip(rows, lanes)} <= touched


def test_cpu_lookup_counts_no_launch_and_refusals_name_the_layout():
    _, ts = specs()
    table, x = inputs(ts)
    build.reset_launch_counts()
    tt = torch.tensor(table, requires_grad=True)
    enc, tenc = tslot.slot_grid_lookup(tt, torch.from_numpy(x), ts, with_tangents=True)
    (enc.sum() + tenc.sum()).backward()
    assert all(build.KERNELS[k].launches == 0 for k in VERTEX_KERNELS)
    assert all(info.launches == 0 for info in build.KERNELS.values())
    # the spec refuses another entry width or a bf16 table for the layout
    with pytest.raises(ValueError, match="layout='cell'"):
        tslot.SlotGridSpec(**{**SMALL, **VERTEX, "feats": 2})
    with pytest.raises(ValueError, match="onehot gather"):
        tslot.SlotGridSpec(**{**SMALL, **VERTEX, "table_dtype": "bf16"})
    # the fused slot kernels' geometry (they refuse the layout first:
    # tests/test_torch_slot_f32.py)
    with pytest.raises(NotImplementedError, match="vertex layout"):
        tslot.cell_factors(torch.from_numpy(x), ts)


def vertex_table(cfg, enc):
    """cfg with its slot grid's encoding replaced by `enc`."""
    rp = dataclasses.replace
    m = cfg.model
    sf = m.surface.surface_field
    grid = rp(sf.field.grid, encoding=enc)
    return rp(cfg, model=rp(m, surface=rp(m.surface, surface_field=rp(
        sf, use_position_encoding=False, field=rp(sf.field, grid=grid)))))


def test_params_from_jax_carries_the_vertex_table():
    """The JAX model's params tree (its init traced, not run) maps leaf for
    leaf onto the port's state dict; the [total_rows, 128] vertex table
    arrives unchanged."""
    js, ts = specs()
    jcfg = vertex_table(tiny(jmethods, jsamplers, jslot), js)
    tcfg = vertex_table(tiny(tmethods, tsamplers, tslot), ts)
    model = tmodel.MMSModel(tcfg.model, device="cpu")
    shapes = _flatten(jax.eval_shape(jmodel.MMSModel(jcfg.model).init, jax.random.key(0)))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in shapes.items()}
    rng = np.random.default_rng(6)
    tree = _unflatten({k: rng.normal(size=v.shape).astype(np.float32) for k, v in shapes.items()})
    state = params_from_jax({"model": tree, "camera_poses": {}}, model)
    key = "surface_field.field.grid_mlp.feature_grid.encoding.table"
    assert tuple(state["model"][key].shape) == (ts.total_rows, 128)
    flat = _flatten(tree)
    assert np.array_equal(state["model"][key].numpy(), flat[key])
