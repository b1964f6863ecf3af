"""The port's fused slot kernels with an f32 table (K2f, K3f) and with skip
connections, forward, merged and split backward, against the JAX package.

The JAX kernels run in interpret mode. Geometries: those of
tests/test_slot_fused.py:19-28, "f16" (3 levels, one dense and two hashed,
F = 16 features per entry, one entry per 128-lane row, f32 table) and
"p2" (F = 2, f32 table); and a 4-layer chain with a skip at layer 2
(33 -> 128 -> 128 -> [128 | 33] -> 128 -> 65) on the "p2" grid with
either table type. 29 samples, 4 PE frequencies, the table uniform in
+-1 so the grid features matter.

Each case runs jax.vjp of fused_slot_sdf_value / fused_slot_sdf_chain and
the port's autograd Function on the same numpy inputs and cotangents
(K3: on sdf, geo and grad, so the second-order path runs), with
MMS_SLOT_BWD_SPLIT unset (merged backward) and set (split backward:
per-sample pass, scatter, weight-gradient products), each side reading the
variable for its own calls.

Held: the forward outputs and d pos, d table, gW and gb at rel-L2 2e-3, the
limit of the bf16 tests, or, where the port's own conditioning is wider,
twice the port's largest distance to itself with its table moved by a
relative 2^-16 (three draws). JAX's f32 table runs its table and
trilerp-weight dots as a bf16 hi+lo split, about 2^-16 from the port's
exact f32 read, so a rounding of x0's (and the adjoint cotangent's) grid
columns to bf16 flips now and then between the two; a flip that moves a
pre-activation across SoftplusQuad's |z| = 2/beta edge changes act'' from
0 to beta/4 there. At F = 16 (48 grid columns) such flips moved K3f's
gradients by 2.1e-3 at one draw of inputs and by 1e-5 at another; the
port moved as far from itself with its table moved by 2^-16. Measured
here: the F = 2 and skip cases within 6.3e-5 of JAX (most within 5e-6),
F = 16 within 2.1e-3 (K3f's merged gW, against its limit of 2.2e-3; the
limits run from 2e-3 to 7.1e-2).

The f32 split's per-sample table cotangent is f32 [N, K, 8F], and its
scatter gives the merged backward's table gradient bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodalstudio_tpu.ops.pallas import slot_fused as jsf
from multimodalstudio_tpu.ops.pallas import slot_grid as jsg
from multimodalstudio_tpu_torch.ops.kernels import slot_fused as tsf
from multimodalstudio_tpu_torch.ops.kernels import slot_grid as tsg

torch.set_num_threads(1)

GEOM = dict(num_levels=3, min_res=4, max_res=16, rows_per_level=64, layout="cell")
SPECS = {
    "f16": GEOM,
    "p2": dict(GEOM, gather="onehot", feats=2),
    "p2_bf16": dict(GEOM, gather="onehot", feats=2, table_dtype="bf16"),
}
PE = dict(num_frequencies=4, min_freq_exp=0.0, max_freq_exp=3.0)
HID, D_OUT, R = 128, 65, 1.0
REL = 2e-3
SKIP = (2,)


def rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def specs(name):
    return jsg.SlotGridSpec(**SPECS[name]), tsg.SlotGridSpec(**SPECS[name])


def inputs(seed, spec, skip=(), n=29):
    """Positions (some past +-r, where the grid coordinate clips), the table,
    the chain (3 layers, or 4 with the skip at layer 2) and cotangents for
    sdf [N], geo [N, D_OUT-1] and grad [N, 3]."""
    rng = np.random.default_rng(seed)
    d_in = 3 + 6 * PE["num_frequencies"] + spec.out_dim
    dims = ([(d_in, HID), (HID, HID), (HID + d_in, HID), (HID, D_OUT)] if skip
            else [(d_in, HID), (HID, HID), (HID, D_OUT)])
    ws = [(0.3 * rng.normal(size=d)).astype(np.float32) for d in dims]
    bs = [(0.1 * rng.normal(size=(d[1],))).astype(np.float32) for d in dims]
    table = rng.uniform(-1.0, 1.0, size=(spec.total_rows, 128)).astype(np.float32)
    pos = rng.uniform(-1.2, 1.2, size=(n, 3)).astype(np.float32)
    cot = (rng.normal(size=n).astype(np.float32),
           (0.1 * rng.normal(size=(n, D_OUT - 1))).astype(np.float32),
           rng.normal(size=(n, 3)).astype(np.float32))
    return pos, table, ws, bs, cot


def _mask(k, feats, active):
    return None if active is None else (np.arange(k * feats) // feats < active).astype(np.float32)


def jax_run(kind, spec, data, skip=(), num_levels=None, active=None):
    """(outputs, [d pos, d table, gW (flat), gb (flat)]) through jax.vjp."""
    pos, table, ws, bs, (gsdf, ggeo, g3) = data
    k = spec.num_levels if num_levels is None else num_levels
    mask = _mask(k, spec.feats, active)
    kw = dict(radius=R, **PE, skip=skip,
              level_mask=None if mask is None else jnp.asarray(mask))

    def f(p, t, w, b):
        if kind == "chain":
            return jsf.fused_slot_sdf_chain(p, t, w, b, spec, **kw)
        return jsf.fused_slot_sdf_value(p, t, w, b, spec, num_levels=num_levels, **kw)

    args = (jnp.asarray(pos), jnp.asarray(table), [jnp.asarray(w) for w in ws],
            [jnp.asarray(b) for b in bs])
    out, vjp = jax.vjp(f, *args)
    if kind == "chain":
        ct = (jnp.asarray(gsdf), jnp.asarray(ggeo).astype(jnp.bfloat16), jnp.asarray(g3))
        outs = [np.asarray(o.astype(jnp.float32)) for o in out]
    else:
        ct = jnp.asarray(gsdf)
        outs = [np.asarray(out)]
    g = vjp(ct)
    return outs, [np.asarray(g[0]), np.asarray(g[1]),
                  np.concatenate([np.asarray(x).ravel() for x in g[2]]),
                  np.concatenate([np.asarray(x).ravel() for x in g[3]])]


def port_run(kind, spec, data, skip=(), num_levels=None, active=None):
    """The same through the port's autograd Functions on the CPU."""
    pos, table, ws, bs, (gsdf, ggeo, g3) = data
    k = spec.num_levels if num_levels is None else num_levels
    mask = _mask(k, spec.feats, active)
    kw = dict(radius=R, **PE, skip=skip,
              level_mask=None if mask is None else torch.from_numpy(mask))
    tp, tt = torch.tensor(pos, requires_grad=True), torch.tensor(table, requires_grad=True)
    tw = [torch.tensor(w, requires_grad=True) for w in ws]
    tb = [torch.tensor(b, requires_grad=True) for b in bs]
    if kind == "chain":
        out = tsf.fused_slot_sdf_chain(tp, tt, tw, tb, spec, **kw)
        torch.autograd.backward(out, (torch.from_numpy(gsdf),
                                      torch.from_numpy(ggeo).to(torch.bfloat16),
                                      torch.from_numpy(g3)))
        assert out[1].dtype == torch.bfloat16
    else:
        out = (tsf.fused_slot_sdf_value(tp, tt, tw, tb, spec, num_levels=num_levels, **kw),)
        out[0].backward(torch.from_numpy(gsdf))
    assert tp.grad.dtype == tt.grad.dtype == torch.float32
    return [o.detach().float().numpy() for o in out], [
        tp.grad.numpy(), tt.grad.numpy(), torch.cat([w.grad.reshape(-1) for w in tw]).numpy(),
        torch.cat([b.grad.reshape(-1) for b in tb]).numpy()]


def moved_table(data, draw):
    """data with the table moved by a relative 2^-16, the distance of JAX's
    hi+lo split from f32 (slot_grid.py::_hi_lo)."""
    pos, table, ws, bs, cot = data
    noise = np.random.default_rng(100 + draw).normal(size=table.shape).astype(np.float32)
    return pos, table * (1 + noise * np.float32(2.0**-16)), ws, bs, cot


def both_runs(split, kind, spec, data, **kw):
    """JAX's run, the port's, and three port runs on moved tables."""
    with pytest.MonkeyPatch.context() as mp:
        if split:
            mp.setenv("MMS_SLOT_BWD_SPLIT", "1")
        else:
            mp.delenv("MMS_SLOT_BWD_SPLIT", raising=False)
        return (jax_run(kind, spec, data, **kw), port_run(kind, spec, data, **kw),
                [port_run(kind, spec, moved_table(data, d), **kw) for d in range(3)])


def assert_close(what, got, ref, moved):
    """rel-L2 within max(REL, twice the port's distance to itself over the
    moved runs)."""
    noise = max(rel_l2(m, got) for m in moved)
    assert got.shape == ref.shape, what
    assert rel_l2(got, ref) <= max(REL, 2 * noise), (what, rel_l2(got, ref), noise)


# (spec, kind, skip, num_levels, active): the f32 geometries, K2f on a
# truncated and masked grid, and the skip chain on either table type
CASES = {
    "f16-chain": ("f16", "chain", (), None, None),
    "f16-value": ("f16", "value", (), 2, 1),
    "p2-chain": ("p2", "chain", (), None, 2),
    "p2-value": ("p2", "value", (), None, None),
    "skip-f32-chain": ("p2", "chain", SKIP, None, None),
    "skip-f32-value": ("p2", "value", SKIP, None, None),
    "skip-bf16-chain": ("p2_bf16", "chain", SKIP, None, None),
    "skip-bf16-value": ("p2_bf16", "value", SKIP, None, None),
}


@pytest.mark.parametrize("split", [False, True], ids=["merged", "split"])
@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_jax(case, split):
    name, kind, skip, num_levels, active = CASES[case]
    jspec, tspec = specs(name)
    data = inputs(len(case) + 7 * int(split), jspec, skip)
    (jout, jgrad), (tout, tgrad), moved = both_runs(split, kind, jspec, data, skip=skip,
                                                    num_levels=num_levels, active=active)
    for i, what in enumerate(("sdf", "geo", "grad")[: len(tout)]):
        assert_close(what, tout[i], jout[i], [m[0][i] for m in moved])
    for i, what in enumerate(("d_pos", "d_table", "gW", "gb")):
        assert tgrad[i].dtype == np.float32, what
        assert_close(what, tgrad[i], jgrad[i], [m[1][i] for m in moved])
    if active is not None:
        # inactive (masked or truncated) levels get exactly zero table gradient
        assert float(np.abs(tgrad[1][int(tspec.level_offsets[active]):]).max()) == 0.0


def test_f32_split_cotangent_is_f32_and_scatters_to_the_merged_table():
    """K3s's plain per-sample table cotangent of an f32 table is f32
    [N, K, 8F] (F = 16 here, unrounded), and the plain scatter of it is the
    merged plain backward's d_table bit for bit."""
    jspec, spec = specs("f16")
    pos, table, ws, bs, (gsdf, ggeo, g3) = inputs(11, jspec)
    pos, table = torch.from_numpy(pos), torch.from_numpy(table)
    ws, bs = [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs]
    gsdf, g3 = torch.from_numpy(gsdf), torch.from_numpy(g3)
    ggeo = torch.from_numpy(ggeo).to(torch.bfloat16)
    pe = tsf.pe_scales(PE["num_frequencies"], PE["min_freq_exp"], PE["max_freq_exp"])
    mask = torch.from_numpy(_mask(3, 16, 2))
    (_, _, _), (zs, ss, adj, _) = tsf._chain_fwd_plain(pos, table, ws, bs, spec, R, pe,
                                                       "SoftplusQuad", 100.0, mask)
    sample = tsf.slot_sdf_chain_bwd_sample_plain(pos, table, ws, spec, zs, ss, adj, gsdf, ggeo,
                                                 g3, radius=R, pe=pe, activation="SoftplusQuad",
                                                 beta=100.0, mask=mask)
    d_comp = sample[1]
    n = pos.shape[0]
    assert d_comp.dtype == torch.float32 and tuple(d_comp.shape) == (n, 3, 128)
    assert not torch.equal(d_comp, d_comp.to(torch.bfloat16).float())
    merged = tsf.slot_sdf_chain_bwd_plain(pos, table, ws, bs, spec, zs, ss, adj, gsdf, ggeo, g3,
                                          radius=R, **PE, level_mask=mask)
    scattered = tsf.slot_table_scatter_plain(pos, d_comp, spec, radius=R)
    assert torch.equal(scattered, merged[1])
    assert float(scattered[int(spec.level_offsets[2]):].abs().max()) == 0.0


def test_check_refuses_the_vertex_layout():
    """Only the cell layout is fused, as in JAX's _make_geom (slot_fused.py
    :108-109); the f32 table and skips pass."""
    vertex = tsg.SlotGridSpec(num_levels=3, min_res=4, max_res=16, rows_per_level=64)
    assert vertex.layout == "vertex"
    with pytest.raises(ValueError, match="cell"):
        tsf._check(vertex, (), "SoftplusQuad")
    pos = torch.zeros(4, 3)
    table = torch.zeros(vertex.total_rows, 128)
    ws = [torch.zeros(3 + 24 + vertex.out_dim, HID), torch.zeros(HID, D_OUT)]
    bs = [torch.zeros(HID), torch.zeros(D_OUT)]
    with pytest.raises(ValueError, match="cell"):
        tsf.fused_slot_sdf_value(pos, table, ws, bs, vertex, radius=R, **PE)
    with pytest.raises(ValueError, match="cell"):
        tsf.fused_slot_sdf_chain(pos, table, ws, bs, vertex, radius=R, **PE)
    for name in ("f16", "p2"):
        tsf._check(specs(name)[1], SKIP, "SoftplusQuad")
