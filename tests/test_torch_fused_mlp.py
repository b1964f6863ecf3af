"""Port's fused dense chain (K1) against the JAX Pallas kernel.

The plain PyTorch version (what a CPU tensor runs) is held against
multimodalstudio_tpu's fused_chain in Pallas interpret mode, on the same
numpy inputs. Both round to bf16 at the same points and accumulate in f32,
so they differ only by summation order: an f32 sum in another order flips
an occasional bf16 rounding of an activation, which moves y by about one
bf16 ulp there. Tolerance: rel-L2 <= 1e-2 on the bf16 output.

The plain backward is held against jax.vjp of the Pallas chain (its
custom VJP runs _bwd_kernel): gx, every gW and gb. Measured rel-L2 is
0 to 1.2e-7 (the same cast points, the same products); tolerance 1e-3, for
a bf16 rounding of gz that another summation order may flip.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodalstudio_tpu.ops.pallas.fused_mlp import chain_reference
from multimodalstudio_tpu.ops.pallas.fused_mlp import fused_chain as jax_fused_chain
from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import (
    fused_chain,
    fused_chain_bwd_plain,
    fused_chain_plain,
)

torch.set_num_threads(1)

BF16_REL = 1e-2


def rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def make_chain(seed, d_in, hidden, d_out, n_layers, skip=(), n=29):
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for l in range(n_layers):
        din = d_in if l == 0 else hidden + (d_in if l in skip else 0)
        dout = d_out if l == n_layers - 1 else hidden
        ws.append((rng.normal(size=(din, dout)) / np.sqrt(din)).astype(np.float32))
        bs.append((0.1 * rng.normal(size=(dout,))).astype(np.float32))
    x = rng.uniform(-1.0, 1.0, size=(n, d_in)).astype(np.float32)
    return x, ws, bs


def to_np(y):
    return y.float().numpy() if isinstance(y, torch.Tensor) else np.asarray(y, np.float32)


@pytest.mark.parametrize(
    "activation,skip,n_layers,n",
    [
        ("ReLU", (), 3, 29),
        ("SoftplusQuad", (), 3, 64),
        ("None", (), 2, 29),
        ("ReLU", (4,), 6, 29),
    ],
)
def test_plain_chain_matches_pallas(activation, skip, n_layers, n):
    x, ws, bs = make_chain(1, 39, 128, 65, n_layers, skip, n)
    beta = 100.0
    ref = jax_fused_chain(
        jnp.asarray(x), [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs],
        skip=skip, activation=activation, beta=beta,
    )
    got = fused_chain_plain(
        torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
        [torch.from_numpy(b) for b in bs], skip=skip, activation=activation, beta=beta,
    )
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (n, 65)
    assert rel_l2(to_np(got), to_np(ref)) <= BF16_REL


def test_cpu_wrapper_takes_the_plain_version():
    x, ws, bs = make_chain(2, 285, 256, 3, 3)
    args = (torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
            [torch.from_numpy(b) for b in bs])
    y = fused_chain(*args, activation="ReLU")
    assert torch.equal(y, fused_chain_plain(*args, activation="ReLU"))


def test_plain_tangents_match_reference():
    x, ws, bs = make_chain(3, 39, 128, 17, 3)
    rng = np.random.default_rng(4)
    tx = rng.normal(size=(3,) + x.shape).astype(np.float32)
    ref_y, ref_t = chain_reference(
        jnp.asarray(x), [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs],
        activation="SoftplusQuad", tangents=jnp.asarray(tx),
    )
    y, t = fused_chain_plain(
        torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
        [torch.from_numpy(b) for b in bs], activation="SoftplusQuad",
        tangents=torch.from_numpy(tx),
    )
    assert rel_l2(to_np(y), to_np(ref_y)) <= BF16_REL
    assert rel_l2(to_np(t), to_np(ref_t)) <= BF16_REL


BWD_REL = 1e-3


def _torch(x, ws, bs, grad=False):
    return (torch.tensor(x, requires_grad=grad), [torch.tensor(w, requires_grad=grad) for w in ws],
            [torch.tensor(b, requires_grad=grad) for b in bs])


@pytest.mark.parametrize(
    "activation,skip,n_layers",
    # the last case has the depth and skip of the mlp_raw_tpu radiance trunk
    [("ReLU", (), 3), ("SoftplusQuad", (), 3), ("None", (), 2), ("ReLU", (4,), 6),
     ("ReLU", (4,), 8)],
)
def test_plain_backward_matches_jax_vjp(activation, skip, n_layers):
    x, ws, bs = make_chain(5, 39, 128, 65, n_layers, skip, 29)
    gy = np.random.default_rng(6).normal(size=(29, 65)).astype(np.float32)

    def f(x, ws, bs):
        return jax_fused_chain(x, ws, bs, skip=skip, activation=activation).astype(jnp.float32)

    _, vjp = jax.vjp(f, jnp.asarray(x), [jnp.asarray(w) for w in ws],
                     [jnp.asarray(b) for b in bs])
    rgx, rgw, rgb = vjp(jnp.asarray(gy))
    tx, tw, tb = _torch(x, ws, bs)
    gx, gw, gb = fused_chain_bwd_plain(tx, torch.from_numpy(gy), tw, tb, skip=skip,
                                       activation=activation)
    assert gx.dtype == torch.bfloat16 and tuple(gx.shape) == x.shape
    assert rel_l2(to_np(gx), rgx) <= BWD_REL
    for l in range(n_layers):
        assert gw[l].dtype == torch.float32 and tuple(gw[l].shape) == ws[l].shape
        assert rel_l2(gw[l].numpy(), rgw[l]) <= BWD_REL, l
        assert rel_l2(gb[l].numpy(), rgb[l]) <= BWD_REL, l


def test_autograd_through_the_chain_uses_the_plain_backward():
    """With grad enabled, fused_chain's Function casts gy to bf16 and
    returns the plain backward's gradients (gx in the input's dtype)."""
    x, ws, bs = make_chain(7, 39, 128, 17, 3, (), 29)
    gy = np.random.default_rng(8).normal(size=(29, 17)).astype(np.float32)
    tx, tw, tb = _torch(x, ws, bs, grad=True)
    y = fused_chain(tx, tw, tb, activation="SoftplusQuad")
    (y.float() * torch.from_numpy(gy)).sum().backward()
    gx, gw, gb = fused_chain_bwd_plain(*_torch(x, ws, bs)[:1], torch.from_numpy(gy),
                                       *_torch(x, ws, bs)[1:], activation="SoftplusQuad")
    assert tx.grad.dtype == torch.float32
    assert torch.equal(tx.grad, gx.float())
    for l in range(3):
        assert torch.equal(tw[l].grad, gw[l]) and torch.equal(tb[l].grad, gb[l])
