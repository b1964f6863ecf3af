"""The port's split slot backward (MMS_SLOT_BWD_SPLIT=1: the per-sample
passes of K2s and K3s, the table scatter and the weight-gradient products)
against the JAX package's split backward, on the CPU.

Inputs and losses are those of tests/test_torch_slot_fused.py: inputs(4), 29
samples on a 3-level grid with F = 2 and a bf16 table, 4 PE frequencies, the
chain 33 -> 128 -> 128 -> 65; K3's loss puts cotangents on sdf, geo and grad,
K2's is sum(sin(3 sdf)). The Pallas kernels run in interpret mode. Both
packages read the variable at call time, so each side sets it for its own
calls.

The split sums gb of a hidden layer over the gz read back from the bf16
stack, where the merged backward sums the f32 gz. At these inputs that moves
d_bs by about 2e-3 in the JAX package itself, so a port that ignored the
variable would miss JAX's split d_bs by that much. Every gradient group of
the port's split is held within 1e-4 of JAX's split (measured 0 to 7.5e-6:
f32 sums in other orders); the same inputs show JAX's split and merged d_bs
more than 1e-3 apart, and the port's merged d_bs as far from JAX's split.
The port's split is held against its merged backward at the JAX test's
limits (tests/test_slot_fused.py:189-193): d_table and d_pos 1e-5, d_ws and
d_bs 2e-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodalstudio_tpu.ops.pallas import slot_fused as jsf
from multimodalstudio_tpu_torch.ops.kernels import slot_fused as tsf
from test_torch_slot_fused import JSPEC, PE, R, TSPEC, _inactive_rows, _leaves, both, inputs, rel_l2

torch.set_num_threads(1)

GROUPS = ("d_pos", "d_table", "d_ws", "d_bs")
REL_SPLIT = 1e-4


def chain_loss(s, g, d, lib):
    return (lib.sum(lib.sin(3.0 * s)) + lib.sum(lib.cos(d) * 0.7)
            + lib.sum(lib.sin(g[:, :32])) * 0.1)


def _mask(k, active):
    return None if active is None else (np.arange(k * 2) // 2 < active).astype(np.float32)


def jax_grads(kind, pos, table, ws, bs, num_levels=None, active=None):
    """The four gradient groups of jax.grad through the Pallas op, each
    flattened (d_ws and d_bs over all layers)."""
    k = JSPEC.num_levels if num_levels is None else num_levels
    mask = _mask(k, active)
    jm = None if mask is None else jnp.asarray(mask)

    def loss(p, t, w, b):
        if kind == "chain":
            s, g, d = jsf.fused_slot_sdf_chain(p, t, w, b, JSPEC, radius=R, **PE, level_mask=jm)
            return chain_loss(s, g.astype(jnp.float32), d, jnp)
        s = jsf.fused_slot_sdf_value(p, t, w, b, JSPEC, radius=R, **PE, level_mask=jm,
                                     num_levels=num_levels)
        return jnp.sum(jnp.sin(3.0 * s))

    g = jax.grad(loss, argnums=(0, 1, 2, 3))(*both(pos, table, ws, bs)[0])
    return [np.asarray(g[0]), np.asarray(g[1]),
            np.concatenate([np.asarray(x).ravel() for x in g[2]]),
            np.concatenate([np.asarray(x).ravel() for x in g[3]])]


def port_grads(kind, pos, table, ws, bs, num_levels=None, active=None):
    """The same four groups through the port's autograd Functions."""
    k = JSPEC.num_levels if num_levels is None else num_levels
    mask = _mask(k, active)
    tm = None if mask is None else torch.from_numpy(mask)
    tp, tt, tw, tb = _leaves(pos, table, ws, bs)
    if kind == "chain":
        s, g, d = tsf.fused_slot_sdf_chain(tp, tt, tw, tb, TSPEC, radius=R, **PE, level_mask=tm)
        chain_loss(s, g.float(), d, torch).backward()
    else:
        s = tsf.fused_slot_sdf_value(tp, tt, tw, tb, TSPEC, radius=R, **PE, level_mask=tm,
                                     num_levels=num_levels)
        torch.sin(3.0 * s).sum().backward()
    return [tp.grad.numpy(), tt.grad.numpy(),
            torch.cat([w.grad.reshape(-1) for w in tw]).numpy(),
            torch.cat([b.grad.reshape(-1) for b in tb]).numpy()]


def run(fn, split, *args, **kw):
    with pytest.MonkeyPatch.context() as mp:
        if split:
            mp.setenv("MMS_SLOT_BWD_SPLIT", "1")
        else:
            mp.delenv("MMS_SLOT_BWD_SPLIT", raising=False)
        return fn(*args, **kw)


@pytest.fixture(scope="module")
def grads():
    """kind -> {(package, split): the four groups} at inputs(4)."""
    data = inputs(4)
    return {kind: {(side, split): run(fn, split, kind, *data)
                   for side, fn in (("jax", jax_grads), ("port", port_grads))
                   for split in (False, True)}
            for kind in ("chain", "value")}


@pytest.mark.parametrize("kind", ["chain", "value"])
def test_split_matches_jax_split(grads, kind):
    got, ref = grads[kind][("port", True)], grads[kind][("jax", True)]
    for name, a, b in zip(GROUPS, got, ref):
        assert a.dtype == np.float32 and a.shape == b.shape, name
        assert rel_l2(a, b) <= REL_SPLIT, (name, rel_l2(a, b))


@pytest.mark.parametrize("kind", ["chain", "value"])
def test_split_d_bs_resolves_the_merged_backward(grads, kind):
    """The inputs tell the two backwards apart: JAX's split and merged d_bs
    differ by more than 1e-3, and the port's merged d_bs misses JAX's split
    by more than the first test's limit."""
    g = grads[kind]
    assert rel_l2(g[("jax", True)][3], g[("jax", False)][3]) > 1e-3
    assert rel_l2(g[("port", False)][3], g[("jax", True)][3]) > 10 * REL_SPLIT


@pytest.mark.parametrize("kind", ["chain", "value"])
def test_split_matches_merged_at_jax_limits(grads, kind):
    split, merged = grads[kind][("port", True)], grads[kind][("port", False)]
    for name, a, b in zip(GROUPS, split, merged):
        assert rel_l2(a, b) < (1e-5 if name in ("d_pos", "d_table") else 2e-2), name


def test_truncated_masked_value_split(monkeypatch):
    """K2s on the first 2 of 3 levels with 1 active: JAX's split within 1e-4,
    and exactly zero table gradient past the active level."""
    monkeypatch.setenv("MMS_SLOT_BWD_SPLIT", "1")
    data = inputs(3)
    got = port_grads("value", *data, num_levels=2, active=1)
    ref = jax_grads("value", *data, num_levels=2, active=1)
    for name, a, b in zip(GROUPS, got, ref):
        assert rel_l2(a, b) <= REL_SPLIT, (name, rel_l2(a, b))
    assert float(np.abs(got[1][_inactive_rows(1)]).max()) == 0.0


def test_variable_read_per_call_and_one_layer_chain(monkeypatch):
    """The variable selects the split at each call; a 1-layer chain takes
    the merged backward under it, as in the JAX package (slot_fused.py:1275,
    1621), and its gradients do not move."""
    calls = []
    for name in ("slot_sdf_value_bwd_split_plain", "slot_sdf_chain_bwd_split_plain"):
        real = getattr(tsf, name)
        monkeypatch.setattr(tsf, name, lambda *a, real=real, name=name, **k:
                            calls.append(name) or real(*a, **k))
    pos, table, ws, bs = inputs(5)
    for split, want in ((True, ["slot_sdf_value_bwd_split_plain",
                                "slot_sdf_chain_bwd_split_plain"]), (False, [])):
        calls.clear()
        run(port_grads, split, "value", pos, table, ws, bs)
        run(port_grads, split, "chain", pos, table, ws, bs)
        assert calls == want
    one = ([ws[0][:, :65]], [bs[2]])
    calls.clear()
    for kind in ("value", "chain"):
        with_var = run(port_grads, True, kind, pos, table, *one)
        without = run(port_grads, False, kind, pos, table, *one)
        for a, b in zip(with_var, without):
            np.testing.assert_array_equal(a, b)
    assert calls == []
    monkeypatch.setenv("MMS_SLOT_BWD_SPLIT", "1")
    assert tsf.bwd_split(2) and not tsf.bwd_split(1)


def test_compact_scatter_equals_merged_table():
    """The per-sample pass's compact bf16 cotangent [N, K, 8F], scattered by
    the plain scatter, is the merged plain backward's d_table, bit for bit."""
    pos, table, ws, bs = (torch.from_numpy(a) if isinstance(a, np.ndarray) else
                          [torch.from_numpy(x) for x in a] for a in inputs(6))
    pe = tsf.pe_scales(PE["num_frequencies"], PE["min_freq_exp"], PE["max_freq_exp"])
    mask = torch.from_numpy(_mask(3, 2))
    (_, _, _), (zs, ss, adj, _) = tsf._chain_fwd_plain(pos, table, ws, bs, TSPEC, R, pe,
                                                       "SoftplusQuad", 100.0, mask)
    rng = np.random.default_rng(7)
    n = pos.shape[0]
    gsdf = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    ggeo = torch.from_numpy(rng.normal(size=(n, 64)).astype(np.float32)).to(torch.bfloat16)
    g3 = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    sample = tsf.slot_sdf_chain_bwd_sample_plain(pos, table, ws, TSPEC, zs, ss, adj, gsdf, ggeo,
                                                 g3, radius=R, pe=pe, activation="SoftplusQuad",
                                                 beta=100.0, mask=mask)
    d_comp = sample[1]
    assert d_comp.dtype == torch.bfloat16 and tuple(d_comp.shape) == (n, 3, 16)
    merged = tsf.slot_sdf_chain_bwd_plain(pos, table, ws, bs, TSPEC, zs, ss, adj, gsdf, ggeo, g3,
                                          radius=R, **PE, level_mask=mask)
    scattered = tsf.slot_table_scatter_plain(pos, d_comp, TSPEC, radius=R)
    assert torch.equal(scattered, merged[1])
    assert float(scattered[_inactive_rows(2)].abs().max()) == 0.0
