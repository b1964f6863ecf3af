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

The backwards run through the port's autograd Functions on the CPU (their
plain backwards, fed the forward's residuals) and are held against
jax.grad of the Pallas ops (custom VJPs over _value_bwd_kernel and
_fused_bwd_kernel) for d pos, d table, gW and gb. K3's loss is the one of
tests/test_slot_fused.py:133-139, with cotangents on sdf, geo and grad, so
the second-order path runs. Measured rel-L2 0 to 2.6e-4: the f32 sums of
the gradients and of the table scatter run in other orders, and a flipped
bf16 rounding of gz moves a gradient by one bf16 ulp. Tolerance 2e-3.
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



REL_BWD = 2e-3


def _leaves(pos, table, ws, bs):
    return (torch.tensor(pos, requires_grad=True), torch.tensor(table, requires_grad=True),
            [torch.tensor(w, requires_grad=True) for w in ws],
            [torch.tensor(b, requires_grad=True) for b in bs])


def _check_grads(jgrads, tp, tt, tw, tb):
    assert tp.grad.dtype == tt.grad.dtype == torch.float32
    assert rel_l2(tp.grad.numpy(), jgrads[0]) <= REL_BWD, "d_pos"
    assert rel_l2(tt.grad.numpy(), jgrads[1]) <= REL_BWD, "d_table"
    for l in range(len(tw)):
        assert rel_l2(tw[l].grad.numpy(), jgrads[2][l]) <= REL_BWD, ("gW", l)
        assert rel_l2(tb[l].grad.numpy(), jgrads[3][l]) <= REL_BWD, ("gb", l)


def _inactive_rows(k_active):
    """Table rows of the levels at or past k_active."""
    return slice(int(JSPEC.level_offsets[k_active]), None)


@pytest.mark.parametrize("num_levels,active", [(None, None), (2, 1), (3, 2)])
def test_value_backward_matches_jax_grad(num_levels, active):
    pos, table, ws, bs = inputs(3)
    k = JSPEC.num_levels if num_levels is None else num_levels
    mask = None if active is None else (np.arange(k * 2) // 2 < active).astype(np.float32)

    def loss(p, t, w, b):
        s = jsf.fused_slot_sdf_value(p, t, w, b, JSPEC, radius=R, **PE, num_levels=num_levels,
                                     level_mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(jnp.sin(3.0 * s))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*both(pos, table, ws, bs)[0])
    tp, tt, tw, tb = _leaves(pos, table, ws, bs)
    sdf = tsf.fused_slot_sdf_value(tp, tt, tw, tb, TSPEC, radius=R, **PE, num_levels=num_levels,
                                   level_mask=None if mask is None else torch.from_numpy(mask))
    torch.sin(3.0 * sdf).sum().backward()
    _check_grads(ref, tp, tt, tw, tb)
    if active is not None:
        # inactive (masked or truncated) levels get exactly zero table gradient
        assert float(tt.grad[_inactive_rows(active)].abs().max()) == 0.0


@pytest.mark.parametrize("activation,active", [("SoftplusQuad", None), ("SoftplusQuad", 2),
                                               ("ReLU", None)])
def test_chain_backward_matches_jax_grad(activation, active):
    pos, table, ws, bs = inputs(4)
    mask = None if active is None else (np.arange(6) // 2 < active).astype(np.float32)

    def loss(s, g, d, lib):
        return (lib.sum(lib.sin(3.0 * s)) + lib.sum(lib.cos(d) * 0.7)
                + lib.sum(lib.sin(g[:, :32])) * 0.1)

    def jloss(p, t, w, b):
        s, g, d = jsf.fused_slot_sdf_chain(
            p, t, w, b, JSPEC, radius=R, **PE, activation=activation,
            level_mask=None if mask is None else jnp.asarray(mask))
        return loss(s, g.astype(jnp.float32), d, jnp)

    ref = jax.grad(jloss, argnums=(0, 1, 2, 3))(*both(pos, table, ws, bs)[0])
    tp, tt, tw, tb = _leaves(pos, table, ws, bs)
    s, g, d = tsf.fused_slot_sdf_chain(
        tp, tt, tw, tb, TSPEC, radius=R, **PE, activation=activation,
        level_mask=None if mask is None else torch.from_numpy(mask))
    loss(s, g.float(), d, torch).backward()
    _check_grads(ref, tp, tt, tw, tb)
    if active is not None:
        assert float(tt.grad[_inactive_rows(active)].abs().max()) == 0.0


def test_plain_backwards_take_the_forward_residuals():
    """The residuals the training forward keeps have the layout the CUDA
    kernels read: zs and ss [L-1, N, H] bf16, adj [N, D_in] f32, and the
    split backward's chain input x0 [N, D_in] bf16."""
    pos, table, ws, bs = inputs(5)
    t = both(pos, table, ws, bs)[1]
    pe = tsf.pe_scales(PE["num_frequencies"], PE["min_freq_exp"], PE["max_freq_exp"])
    mask = torch.ones(6)
    (_, _, _), (zs, ss, adj, x0) = tsf._chain_fwd_plain(*t, TSPEC, R, pe, "SoftplusQuad", 100.0,
                                                        mask)
    _, vzs, vx0 = tsf._value_fwd_plain(*t, TSPEC, 3, R, pe, "SoftplusQuad", 100.0, mask)
    n = pos.shape[0]
    assert zs.dtype == ss.dtype == vzs.dtype == torch.bfloat16
    assert tuple(zs.shape) == tuple(ss.shape) == tuple(vzs.shape) == (2, n, HID)
    assert adj.dtype == torch.float32 and tuple(adj.shape) == (n, 3 + 24 + JSPEC.out_dim)
    assert torch.equal(zs, vzs)
    assert x0.dtype == torch.bfloat16 and tuple(x0.shape) == tuple(adj.shape)
    assert torch.equal(x0, vx0)


@pytest.mark.parametrize("launcher", ["value", "chain", "value_bwd", "chain_bwd", "value_sample",
                                      "chain_sample", "scatter"])
def test_empty_batch_counts_no_launch(launcher, monkeypatch):
    """A launcher given no samples launches nothing, so its count stays."""
    monkeypatch.setattr(tsf.build, "stream_of", lambda t: None)  # no card here
    _, table, ws, bs = inputs(6)
    t = both(np.zeros((0, 3), np.float32), table, ws, bs)[1]
    pe = tsf.pe_scales(PE["num_frequencies"], PE["min_freq_exp"], PE["max_freq_exp"])
    mask = torch.ones(6)
    rest = (TSPEC, 3, R, pe, "SoftplusQuad", 100.0, mask)
    zs = torch.zeros(2, 0, HID, dtype=torch.bfloat16)
    calls = {
        "value": (tsf.VALUE_KERNEL, lambda: tsf._launch(*t, *rest, False, resid=True)),
        "chain": (tsf.CHAIN_KERNEL, lambda: tsf._launch(*t, *rest, True, resid=True)),
        "value_bwd": (tsf.VALUE_BWD_KERNEL,
                      lambda: tsf._launch_value_bwd(*t, *rest, zs, torch.zeros(0))),
        "chain_bwd": (tsf.CHAIN_BWD_KERNEL, lambda: tsf._launch_chain_bwd(
            *t, TSPEC, R, pe, "SoftplusQuad", 100.0, mask, zs, zs, torch.zeros(0, 51),
            torch.zeros(0), torch.zeros(0, D_OUT - 1), torch.zeros(0, 3))),
        "value_sample": (tsf.VALUE_SPLIT_KERNEL,
                         lambda: tsf._launch_value_bwd_sample(*t, *rest, zs, torch.zeros(0))),
        "chain_sample": (tsf.CHAIN_SPLIT_KERNEL, lambda: tsf._launch_chain_bwd_sample(
            *t, TSPEC, R, pe, "SoftplusQuad", 100.0, mask, zs, zs, torch.zeros(0, 51),
            torch.zeros(0), torch.zeros(0, D_OUT - 1), torch.zeros(0, 3))),
        # the table gradient stays zero: no nonzero entries
        "scatter": (tsf.SCATTER_KERNEL, lambda: (tsf._launch_table_scatter(
            t[0], torch.zeros(0, 3, 16, dtype=torch.bfloat16), TSPEC, R).nonzero(),)),
    }
    info, call = calls[launcher]
    before = info.launches
    out = call()
    assert info.launches == before
    assert out[0].shape[0] == 0
