"""K3's backward (the fused slot-grid SDF chain, bf16 or f32 table), merged
and split, in two parts on the CPU: the per-tile pass and the stacked gW
product.

On the card K3's backward is one per-tile pass (csrc/slot_chain_bwd.cu)
that writes d pos, the table cotangent (merged: into the table gradient;
split: compact [N, K, 8F], which the split's scatter adds into it), gb, the
last layer's column term of gW and, per layer, the stacks of its gW
operands, A_l = [hin_l; qin_l] and B_l = [gz_l; v_l], and chain_wgrad,
gW_l = A_l^T B_l over the 2N stacked rows. Their plain versions, composed,
must give the plain backward: the same f32 products summed in another
order, so within rel-L2 1e-6. Merged: against slot_sdf_chain_bwd_plain.
Split: against slot_sdf_chain_bwd_split_plain for d pos, d table and gb;
its gW against the merged backward's, since the pass's qin at a skip layer
is the merged one's bf16(concat(q, ga) / sqrt 2), where JAX's _wgrads_xla
re-forms it from its bf16 q and ga stacks (one rounding apart; without a
skip the two are the same function).

The composition must also match JAX's vjp of fused_slot_sdf_chain in Pallas
interpret mode (MMS_SLOT_BWD_SPLIT set for the split) at the limits of
tests/test_torch_slot_fused.py (rel-L2 2e-3, bf16 table) and
tests/test_torch_slot_f32.py (max(2e-3, twice the port's distance to itself
with its table moved by a relative 2^-16), f32 table). Cases: both tables
(F = 2), merged and split, a 3-layer SoftplusQuad chain and a 10-layer ReLU
chain with a skip at layer 4; N = 29 (a ragged 64-row tile), 3 levels, 2
active.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodalstudio_tpu.ops.pallas import slot_fused as jsf
from multimodalstudio_tpu.ops.pallas import slot_grid as jsg
from multimodalstudio_tpu_torch.ops.kernels import sdf_chain as sc
from multimodalstudio_tpu_torch.ops.kernels import slot_fused as tsf
from multimodalstudio_tpu_torch.ops.kernels import slot_grid as tsg

torch.set_num_threads(1)

N = 29
SAME_MATH = 1e-6
JAX_REL = 2e-3  # the limit of tests/test_torch_slot_fused.py and tests/test_torch_slot_f32.py
GEOM = dict(num_levels=3, min_res=4, max_res=16, rows_per_level=64, layout="cell",
            gather="onehot", feats=2)
PE = dict(num_frequencies=4, min_freq_exp=0.0, max_freq_exp=3.0)
R, HID, D_OUT = 1.0, 128, 65
CHAINS = {  # name: (layers, skip, activation)
    "3 layers": (3, (), "SoftplusQuad"),
    "10 layers, skip": (10, (4,), "ReLU"),
}
GRADS = ("d_pos", "d_table", "gW", "gb")


def rel_l2(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def make_case(seed, table_dtype, chain):
    """(the JAX and port grid specs, numpy inputs: positions, table, weights,
    biases, level mask, cotangents on sdf, geo and grad)."""
    n_layers, skip, _ = CHAINS[chain]
    spec = dict(GEOM, table_dtype=table_dtype)
    jspec, tspec = jsg.SlotGridSpec(**spec), tsg.SlotGridSpec(**spec)
    rng = np.random.default_rng(seed)
    d_in = 3 + 6 * PE["num_frequencies"] + jspec.out_dim
    dims = [(d_in if l == 0 else HID + (d_in if l in skip else 0), D_OUT if l == n_layers - 1
             else HID) for l in range(n_layers)]
    ws = [(rng.normal(size=d) / np.sqrt(d[0])).astype(np.float32) for d in dims]
    bs = [(0.1 * rng.normal(size=(d[1],))).astype(np.float32) for d in dims]
    table = rng.uniform(-1.0, 1.0, size=(jspec.total_rows, 128)).astype(np.float32)
    pos = rng.uniform(-1.2, 1.2, size=(N, 3)).astype(np.float32)
    mask = (np.arange(3 * GEOM["feats"]) // GEOM["feats"] < 2).astype(np.float32)
    cot = (rng.normal(size=N).astype(np.float32),
           (0.1 * rng.normal(size=(N, D_OUT - 1))).astype(np.float32),
           rng.normal(size=(N, 3)).astype(np.float32))
    return jspec, tspec, (pos, table, ws, bs, mask, cot)


def kwargs(chain):
    _, skip, act = CHAINS[chain]
    return dict(radius=R, **PE, skip=skip, activation=act, beta=100.0)


def torch_inputs(data):
    pos, table, ws, bs, mask, (gsdf, ggeo, g3) = data
    t = torch.from_numpy
    return (t(pos), t(table), [t(w) for w in ws], [t(b) for b in bs], t(mask),
            (t(gsdf), t(ggeo).to(torch.bfloat16), t(g3)))


def residuals(spec, data, kw):
    """The plain forward's residuals (zs, ss, adj, x0)."""
    pos, table, ws, bs, mask, _ = torch_inputs(data)
    pe = tsf.pe_scales(PE["num_frequencies"], PE["min_freq_exp"], PE["max_freq_exp"])
    return tsf._chain_fwd_plain(pos, table, ws, bs, spec, R, pe, kw["activation"], kw["beta"],
                                mask, kw["skip"])[1]


def composed(spec, data, kw, split):
    """The plain pass, then the plain stacked gW (and, split, the plain
    scatter): (d_pos, d_table, gW list, gb list)."""
    pos, table, ws, _, mask, cot = torch_inputs(data)
    zs, ss, adj, _ = residuals(spec, data, kw)
    d_pos, dt, a, b, gbs, col = tsf.slot_chain_bwd_tile_plain(
        pos, table, ws, spec, zs, ss, adj, *cot, level_mask=mask, split=split, **kw)
    if split:
        dt = tsf.slot_table_scatter_plain(pos, dt, spec, radius=R)
    return d_pos, dt, sc.adjoint_wgrad_plain(a, b, col), gbs


def plain(spec, data, kw, split):
    """The plain backward: merged, or the split's per-sample math, scatter
    and _wgrads_xla's products."""
    pos, table, ws, bs, mask, cot = torch_inputs(data)
    zs, ss, adj, x0 = residuals(spec, data, kw)
    if split:
        return tsf.slot_sdf_chain_bwd_split_plain(pos, table, ws, bs, spec, zs, ss, adj, x0, *cot,
                                                  level_mask=mask, **kw)
    return tsf.slot_sdf_chain_bwd_plain(pos, table, ws, bs, spec, zs, ss, adj, *cot,
                                        level_mask=mask, **kw)


def flat(g):
    return np.concatenate([np.asarray(x, np.float32).ravel() for x in g]) if isinstance(
        g, (list, tuple)) else np.asarray(g, np.float32)


def jax_grads(jspec, data, kw, split):
    """d pos, d table, gW and gb through jax.vjp of the Pallas kernels in
    interpret mode, each flat."""
    pos, table, ws, bs, mask, (gsdf, ggeo, g3) = data
    jkw = dict(kw, level_mask=jnp.asarray(mask))

    def f(p, t, w, b):
        return jsf.fused_slot_sdf_chain(p, t, w, b, jspec, **jkw)

    with pytest.MonkeyPatch.context() as mp:
        if split:
            mp.setenv("MMS_SLOT_BWD_SPLIT", "1")
        else:
            mp.delenv("MMS_SLOT_BWD_SPLIT", raising=False)
        _, vjp = jax.vjp(f, jnp.asarray(pos), jnp.asarray(table), [jnp.asarray(w) for w in ws],
                         [jnp.asarray(b) for b in bs])
        g = vjp((jnp.asarray(gsdf), jnp.asarray(ggeo).astype(jnp.bfloat16), jnp.asarray(g3)))
    return [flat(np.asarray(g[0])), flat(np.asarray(g[1])), flat([np.asarray(x) for x in g[2]]),
            flat([np.asarray(x) for x in g[3]])]


def moved_table(data, draw):
    """data with the table moved by a relative 2^-16 (tests/test_torch_slot_f32.py)."""
    pos, table, ws, bs, mask, cot = data
    noise = np.random.default_rng(100 + draw).normal(size=table.shape).astype(np.float32)
    return pos, table * (1 + noise * np.float32(2.0**-16)), ws, bs, mask, cot


CASES = [(t, c) for t in ("bf16", "f32") for c in CHAINS]


@pytest.mark.parametrize("split", [False, True], ids=["merged", "split"])
@pytest.mark.parametrize("table_dtype,chain", CASES)
def test_pass_and_stacked_gw_give_the_plain_backward(table_dtype, chain, split):
    _, spec, data = make_case(11, table_dtype, chain)
    kw = kwargs(chain)
    got = [flat(g) for g in composed(spec, data, kw, split)]
    want = [flat(g) for g in plain(spec, data, kw, split)]
    merged = [flat(g) for g in plain(spec, data, kw, False)]
    for i, what in enumerate(GRADS):
        ref = merged[i] if split and what == "gW" else want[i]
        assert got[i].shape == ref.shape, what
        assert rel_l2(got[i], ref) <= SAME_MATH, (what, rel_l2(got[i], ref))


def test_split_pass_writes_compact_cotangent_and_bf16_gz_sums():
    """The split pass's table cotangent is [N, K, 8F] in the table's type,
    its gb of a hidden layer the sum of the bf16 gz (B stack rows), and its
    stacks those of the merged pass."""
    for table_dtype in ("bf16", "f32"):
        _, spec, data = make_case(12, table_dtype, "3 layers")
        kw = kwargs("3 layers")
        pos, table, ws, _, mask, cot = torch_inputs(data)
        zs, ss, adj, _ = residuals(spec, data, kw)
        args = (pos, table, ws, spec, zs, ss, adj, *cot)
        s = tsf.slot_chain_bwd_tile_plain(*args, level_mask=mask, split=True, **kw)
        m = tsf.slot_chain_bwd_tile_plain(*args, level_mask=mask, split=False, **kw)
        want = torch.bfloat16 if table_dtype == "bf16" else torch.float32
        assert s[1].dtype == want and tuple(s[1].shape) == (N, 3, 8 * GEOM["feats"])
        assert all(torch.equal(x, y) for x, y in zip(s[2] + s[3], m[2] + m[3]))
        assert torch.equal(s[4][0], s[3][0][:N].float().sum(0))
        assert torch.equal(s[5], m[5]) and torch.equal(s[0], m[0])


@pytest.mark.parametrize("split", [False, True], ids=["merged", "split"])
@pytest.mark.parametrize("table_dtype,chain", CASES)
def test_composition_matches_jax_vjp(table_dtype, chain, split):
    jspec, spec, data = make_case(13, table_dtype, chain)
    kw = kwargs(chain)
    got = [flat(g) for g in composed(spec, data, kw, split)]
    ref = jax_grads(jspec, data, kw, split)
    noise = [0.0] * 4
    if table_dtype == "f32":  # the f32 test's limit: twice the port's own spread
        for d in range(3):
            moved = [flat(g) for g in composed(spec, moved_table(data, d), kw, split)]
            noise = [max(a, rel_l2(m, g)) for a, m, g in zip(noise, moved, got)]
    for i, what in enumerate(GRADS):
        assert got[i].shape == ref[i].shape, what
        limit = max(JAX_REL, 2 * noise[i])
        assert rel_l2(got[i], ref[i]) <= limit, (what, rel_l2(got[i], ref[i]), limit)
