"""Port's fused dense chain (K1) against the JAX Pallas kernel.

The plain PyTorch version (what a CPU tensor runs) is held against
multimodalstudio_tpu's fused_chain in Pallas interpret mode, on the same
numpy inputs. Both round to bf16 at the same points and accumulate in f32,
so they differ only by summation order: an f32 sum in another order flips
an occasional bf16 rounding of an activation, which moves y by about one
bf16 ulp there. Tolerance: rel-L2 <= 1e-2 on the bf16 output.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodalstudio_tpu.ops.pallas.fused_mlp import chain_reference
from multimodalstudio_tpu.ops.pallas.fused_mlp import fused_chain as jax_fused_chain
from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import fused_chain, fused_chain_plain

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
