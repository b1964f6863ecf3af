"""The port's multiresolution hash grid (ops/encodings.py) against the JAX
package's: hash_grid_lookup's forward, d table and d x on the sizes of
tests/test_ops.py (4 levels from res 4 to 64 on 2^9 entries per level:
the coarsest level dense, the three finer hashed), for the three
interpolations, both vjp modes and truncated lookups; the hashed indices
(the uint32 products of the reference kept in int64) and the dense ones
exactly; a dense spec whose levels do not fit raises; the lookup through
FeatureGrid (rescale, clamp, coarse-to-fine mask); HashEncoding's init.

Both sides compute in float32 and differ by summation order: forward and
d table within 1e-5 absolute (features of unit-normal tables), d x within
rel-L2 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multimodalstudio_tpu.fields.components as jcomp
import multimodalstudio_tpu.ops.encodings as jenc
import multimodalstudio_tpu_torch.fields.components as tcomp
import multimodalstudio_tpu_torch.ops.encodings as tenc

torch.set_num_threads(1)

SIZES = dict(num_levels=4, min_res=4, max_res=64, log2_hashmap_size=9)
ATOL = 1e-5
RTOL = 1e-5


def specs(**kw):
    j = jenc.HashGridSpec(**{**SIZES, **kw})
    return j, tenc.HashGridSpec(**dataclasses.asdict(j))


def inputs(spec, n=50, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(spec.num_levels * spec.table_size, 2)).astype(np.float32)
    x = rng.uniform(size=(n, 3)).astype(np.float32)
    g = rng.normal(size=(n, spec.out_dim)).astype(np.float32)
    return table, x, g


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_sizes_mix_dense_and_hashed_levels():
    j, _ = specs()
    dense = (j.resolutions.astype(np.int64) + 1) ** 3 <= j.table_size
    assert dense.tolist() == [True, False, False, False]


def test_geometry_indices_equal_the_reference():
    """Dense and hashed indices, level offsets included, bit for bit; the
    per-axis factors give the reference's corner weights."""
    j, t = specs()
    _, x, _ = inputs(j, n=200)
    jidx, jfac, joff = jenc._grid_geometry(jnp.asarray(x), j)
    tidx, tw, toff = tenc.grid_geometry(torch.from_numpy(x), t)
    assert tidx.dtype == torch.int32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(toff.numpy(), np.asarray(joff))
    jcw = np.asarray(jfac[:, :, 0] * jfac[:, :, 1] * jfac[:, :, 2])
    np.testing.assert_array_equal(tenc.corner_weights(tw).numpy(), jcw)


def test_hashed_indices_past_32_bits_match():
    """Coordinates whose products with the primes pass 2^32 (a 2^19-entry
    table at res 2048): the masked int64 XOR is the uint32 one."""
    j, t = specs(num_levels=2, min_res=1024, max_res=2048, log2_hashmap_size=19)
    x = np.random.default_rng(1).uniform(0.5, 1.0 - 1e-6, size=(300, 3)).astype(np.float32)
    jidx, _, _ = jenc._grid_geometry(jnp.asarray(x), j)
    tidx, _, _ = tenc.grid_geometry(torch.from_numpy(x), t)
    assert int(np.asarray(jidx).max()) >= 2**19  # the second level's rows
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("interpolation", ["Smoothstep", "Linear", "Nearest"])
@pytest.mark.parametrize("vjp_mode", ["custom", "autodiff"])
@pytest.mark.parametrize("num_levels", [None, 2])
def test_lookup_and_its_gradients_match_jax(interpolation, vjp_mode, num_levels):
    j, t = specs(interpolation=interpolation, vjp_mode=vjp_mode)
    table, x, g = inputs(j)

    def jloss(tb, p):
        return jnp.sum(jenc.hash_grid_lookup(tb, p, j, num_levels) * g)

    jout = jenc.hash_grid_lookup(jnp.asarray(table), jnp.asarray(x), j, num_levels)
    jgt, jgx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))
    tt = torch.tensor(table, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    tout = tenc.hash_grid_lookup(tt, tx, t, num_levels)
    (tout * torch.from_numpy(g)).sum().backward()
    assert tuple(tout.shape) == (50, j.out_dim)
    if num_levels is not None:  # the truncated levels are zero
        assert float(tout[:, num_levels * 2:].abs().max()) == 0.0
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgt), atol=ATOL, rtol=0)
    if interpolation == "Nearest":  # piecewise constant in x
        assert float(tx.grad.abs().max()) == 0.0 and float(np.abs(jgx).max()) == 0.0
    else:
        assert rel_l2(tx.grad.numpy(), jgx) <= RTOL


def test_custom_backward_saves_only_table_and_positions():
    """The Function's backward recomputes the geometry: what autograd keeps
    of a custom lookup is its two inputs."""
    _, t = specs()
    table, x, _ = inputs(t)
    tt, tx = torch.tensor(table, requires_grad=True), torch.tensor(x, requires_grad=True)
    out = tenc.hash_grid_lookup(tt, tx, t)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 2
    assert saved[0].data_ptr() == tt.data_ptr() and saved[1].data_ptr() == tx.data_ptr()


def test_autodiff_lookup_takes_forward_mode():
    """The autodiff lookup under torch.func.jacfwd gives the custom
    backward's d x (both are the same function)."""
    _, t = specs(vjp_mode="autodiff")
    table, x, _ = inputs(t)
    tb = torch.from_numpy(table)
    jac = torch.func.vmap(torch.func.jacfwd(
        lambda p: tenc.hash_grid_lookup(tb, p[None], t)[0].sum()))(torch.from_numpy(x))
    tx = torch.tensor(x, requires_grad=True)
    tenc.hash_grid_lookup(tb, tx, dataclasses.replace(t, vjp_mode="custom")).sum().backward()
    assert rel_l2(jac.numpy(), tx.grad.numpy()) <= RTOL


@pytest.mark.parametrize("gather_mode", ["rows", "flat"])
def test_gather_modes_are_one_path(gather_mode):
    j, t = specs(gather_mode=gather_mode)
    table, x, _ = inputs(j)
    ref = tenc.hash_grid_lookup(torch.from_numpy(table), torch.from_numpy(x),
                                dataclasses.replace(t, gather_mode="rows"))
    got = tenc.hash_grid_lookup(torch.from_numpy(table), torch.from_numpy(x), t)
    assert torch.equal(got, ref)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jenc.hash_grid_lookup(jnp.asarray(table), jnp.asarray(x), j)),
        atol=ATOL, rtol=0)


def test_dense_spec_whose_levels_do_not_fit_raises():
    _, t = specs(dense=True)
    _, x, _ = inputs(t)
    with pytest.raises(ValueError, match="dense grid requested"):
        tenc.hash_grid_lookup(torch.zeros(4 * t.table_size, 2), torch.from_numpy(x), t)
    _, fits = specs(dense=True, num_levels=2, max_res=7)  # res 4 and 7: 8^3 <= 2^9
    out = tenc.hash_grid_lookup(torch.ones(2 * fits.table_size, 2), torch.from_numpy(x), fits)
    np.testing.assert_allclose(out.numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("active_level,max_level", [(None, None), (2, None), (3, 2)])
def test_feature_grid_on_a_hash_grid_matches_jax(active_level, max_level):
    """FeatureGrid: [-r, r] -> [0, 1], clamped below 1 (positions past the
    radius too), the lookup, and the coarse-to-fine mask, forward and d x."""
    j, t = specs()
    jspec = jcomp.FeatureGridSpec(encoding=j, radius=2.0)
    tspec = tcomp.FeatureGridSpec(encoding=t, radius=2.0)
    table, _, _ = inputs(j)
    x = np.random.default_rng(5).uniform(-2.2, 2.2, size=(64, 3)).astype(np.float32)
    params = {"encoding": {"table": jnp.asarray(table)}}
    jgrid = jcomp.FeatureGrid(jspec)
    level = None if active_level is None else jnp.asarray(active_level)
    jout, jvjp = jax.vjp(lambda p: jgrid.apply({"params": params}, p, level, max_level),
                         jnp.asarray(x))
    g = np.random.default_rng(6).normal(size=jout.shape).astype(np.float32)
    (jgx,) = jvjp(jnp.asarray(g))
    grid = tcomp.FeatureGrid(tspec)
    grid.encoding.table.data.copy_(torch.from_numpy(table))
    tx = torch.tensor(x, requires_grad=True)
    tout = grid(tx, active_level, max_level)
    (tout * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    assert rel_l2(tx.grad.numpy(), jgx) <= RTOL


def test_hash_encoding_init_is_uniform_in_the_scale():
    t = tenc.HashGridSpec(num_levels=2, log2_hashmap_size=12, hash_init_scale=1e-3)
    enc = tenc.HashEncoding(t)
    enc.init_params(torch.Generator().manual_seed(0))
    table = enc.table.detach()
    assert tuple(table.shape) == (2 * 4096, 2)
    assert float(table.abs().max()) <= 1e-3
    assert abs(float(table.mean())) < 2e-5 and abs(float(table.std()) - 1e-3 / 3**0.5) < 2e-5
