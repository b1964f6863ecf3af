"""Port's fused chain adjoint (K5) against the JAX Pallas kernel.

The plain PyTorch forward and the autograd through the Function on the
CPU (its plain backward, written out at _bwd_adj_kernel's cast points with
enc=None) are held against multimodalstudio_tpu's fused_chain_adjoint in
Pallas interpret mode on the same numpy inputs: the slot-grid surface's
shape cut to a ragged N = 37 (15 inputs, 4 layers of width 128, 33
outputs), with and without a skip at layer 2, and a loss on y and adj
whose gradient goes through x, every gW and every gb. Both sides round to
bf16 at the same points and differ only by f32 summation order: measured
rel-L2 0 (y), 5.6e-8 and 1.6e-4 (adj; a flipped bf16 rounding in the case
with the skip), gradients up to 2.1e-5; tolerance 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodalstudio_tpu.ops.pallas.fused_mlp import fused_chain_adjoint as jax_chain_adjoint
from multimodalstudio_tpu_torch.ops.kernels import build
from multimodalstudio_tpu_torch.ops.kernels.sdf_chain import (
    fused_chain_adjoint,
    fused_chain_adjoint_bwd_plain,
    fused_chain_adjoint_plain,
)

torch.set_num_threads(1)

N, D_IN, D_OUT = 37, 15, 33


def rel_l2(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def make_inputs(seed, skip, n=N):
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for l in range(4):
        din = D_IN if l == 0 else 128 + (D_IN if l in skip else 0)
        dout = D_OUT if l == 3 else 128
        ws.append((rng.normal(size=(din, dout)) / np.sqrt(din)).astype(np.float32))
        bs.append((0.01 * rng.normal(size=(dout,))).astype(np.float32))
    x = (0.5 * rng.normal(size=(n, D_IN))).astype(np.float32)
    gy = rng.normal(size=(n, D_OUT)).astype(np.float32)
    ga = rng.normal(size=(n, D_IN)).astype(np.float32)
    return x, ws, bs, gy, ga


@pytest.mark.parametrize("skip,channel", [((), 0), ((2,), 1)])
def test_plain_and_autograd_match_pallas(skip, channel):
    x, ws, bs, gy, ga = make_inputs(0, skip)
    kw = dict(skip=skip, activation="SoftplusQuad", beta=100.0, channel=channel)

    def loss(y, adj, xp):
        return xp.sum(y * xp.asarray(gy)) + xp.sum(adj * xp.asarray(ga))

    def jloss(xj, wj, bj):
        y, adj = jax_chain_adjoint(xj, list(wj), list(bj), **kw)
        return loss(y.astype(jnp.float32), adj, jnp), (y, adj)

    jw, jb = tuple(jnp.asarray(w) for w in ws), tuple(jnp.asarray(b) for b in bs)
    (jg, (jy, jadj)) = jax.grad(jloss, argnums=(0, 1, 2), has_aux=True)(jnp.asarray(x), jw, jb)
    tw = [torch.tensor(w, requires_grad=True) for w in ws]
    tb = [torch.tensor(b, requires_grad=True) for b in bs]
    tx = torch.tensor(x, requires_grad=True)
    y, adj = fused_chain_adjoint(tx, tw, tb, **kw)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (N, D_OUT)
    assert adj.dtype == torch.float32 and tuple(adj.shape) == (N, D_IN)
    assert torch.equal(adj, fused_chain_adjoint_plain(tx, tw, tb, **kw)[1])
    assert rel_l2(y.float().detach(), np.asarray(jy, np.float32)) <= 1e-3
    assert rel_l2(adj, jadj) <= 1e-3
    loss(y.float(), adj, torch).backward()
    assert rel_l2(tx.grad, jg[0]) <= 1e-3
    for l in range(4):
        assert float(tw[l].grad.abs().max()) > 0 and float(tb[l].grad.abs().max()) > 0
        assert rel_l2(tw[l].grad, jg[1][l]) <= 1e-3, l
        assert rel_l2(tb[l].grad, jg[2][l]) <= 1e-3, l


def test_function_backward_is_the_plain_backward():
    """The Function hands (gy rounded to bf16, ga) to the plain backward on
    the CPU; gx comes back bf16-rounded in x's dtype."""
    x, ws, bs, gy, ga = make_inputs(1, (2,), n=20)
    kw = dict(skip=(2,), activation="SoftplusQuad", beta=100.0)
    tx = torch.tensor(x, requires_grad=True)
    tw = [torch.tensor(w, requires_grad=True) for w in ws]
    tb = [torch.tensor(b, requires_grad=True) for b in bs]
    y, adj = fused_chain_adjoint(tx, tw, tb, **kw)
    torch.autograd.backward([y, adj], [torch.from_numpy(gy).to(torch.bfloat16),
                                       torch.from_numpy(ga)])
    gx, gws, gbs = fused_chain_adjoint_bwd_plain(
        torch.from_numpy(x), [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs],
        torch.from_numpy(gy), torch.from_numpy(ga), **kw)
    assert torch.equal(tx.grad, gx.float())
    for l in range(4):
        assert torch.equal(tw[l].grad, gws[l]) and torch.equal(tb[l].grad, gbs[l])


def test_bad_channel_raises_and_cpu_counts_no_launch():
    x, ws, bs, _, _ = make_inputs(2, (), n=8)
    args = (torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
            [torch.from_numpy(b) for b in bs])
    with pytest.raises(ValueError, match="channel"):
        fused_chain_adjoint(*args, channel=D_OUT)
    build.reset_launch_counts()
    fused_chain_adjoint(*args)
    assert build.KERNELS["fused_chain_adjoint"].launches == 0
