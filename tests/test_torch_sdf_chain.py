"""Port's fused SDF chain (K4, adjoint mode) against the JAX Pallas kernel
(its jvp mode, K4j: tests/test_torch_chain_tangents.py).

The plain PyTorch forward (what a CPU tensor runs) is held against
multimodalstudio_tpu's fused_sdf_chain(mode="adjoint") in Pallas interpret
mode on the same numpy inputs, at the size of tests/test_fused_mlp.py's
gradient test (4 layers, width 128, a skip at layer 2, 96 positions, 6
frequencies). Both round to bf16 at the same points and differ only by f32
summation order, which can flip one bf16 rounding of an activation.
Measured rel-L2 3.8e-5 (sdf), 1.2e-4 (geo), 9.4e-5 (grad); tolerances: sdf
and grad 1e-3, geo (bf16) 1e-2.

The port's autograd through the Function on the CPU (the plain backward,
written out at _bwd_adj_kernel's cast points) is held against jax.grad of
the same loss through the Pallas backward: positions, every gW and gb.
The JAX package's own test of this loss against XLA autodiff allows
rel-L2 8e-2 (tests/test_fused_mlp.py:165-167); the port and the Pallas
backward share their cast points, and measure 6.8e-5 (positions) and up to
1.9e-4 (gW), so the tolerance here is 1e-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodalstudio_tpu.ops.pallas.fused_mlp import fused_sdf_chain as jax_fused_sdf_chain
from multimodalstudio_tpu_torch.ops.kernels import build
from multimodalstudio_tpu_torch.ops.kernels.sdf_chain import (
    fused_sdf_chain,
    fused_sdf_chain_bwd_plain,
    fused_sdf_chain_plain,
)

torch.set_num_threads(1)

F, MN, MX = 6, 0.0, 5.0
D_IN = 3 + 6 * F
KW = dict(num_frequencies=F, min_freq_exp=MN, max_freq_exp=MX, skip=(2,),
          activation="SoftplusQuad", beta=100.0)


def rel_l2(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def make_inputs(seed, n=96, n_layers=4, hidden=128, d_out=129, skip=(2,)):
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for l in range(n_layers):
        din = D_IN if l == 0 else hidden + (D_IN if l in skip else 0)
        dout = d_out if l == n_layers - 1 else hidden
        ws.append((rng.normal(size=(din, dout)) / np.sqrt(din)).astype(np.float32))
        bs.append((0.01 * rng.normal(size=(dout,))).astype(np.float32))
    pos = rng.uniform(-0.9, 0.9, size=(n, 3)).astype(np.float32)
    return pos, ws, bs


def test_plain_forward_matches_pallas():
    pos, ws, bs = make_inputs(0)
    ref = jax_fused_sdf_chain(jnp.asarray(pos), [jnp.asarray(w) for w in ws],
                              [jnp.asarray(b) for b in bs], mode="adjoint", **KW)
    got = fused_sdf_chain_plain(torch.from_numpy(pos), [torch.from_numpy(w) for w in ws],
                                [torch.from_numpy(b) for b in bs], **KW)
    sdf, geo, grad = got
    assert sdf.dtype == torch.float32 and tuple(sdf.shape) == (96,)
    assert geo.dtype == torch.bfloat16 and tuple(geo.shape) == (96, 128)
    assert grad.dtype == torch.float32 and tuple(grad.shape) == (96, 3)
    assert rel_l2(sdf.numpy(), ref[0]) <= 1e-3
    assert rel_l2(geo.float().numpy(), np.asarray(ref[1], np.float32)) <= 1e-2
    assert rel_l2(grad.numpy(), ref[2]) <= 1e-3


def _loss_terms(sdf, geo, grad, xp):
    return xp.sum(xp.sin(sdf)) + xp.sum(xp.cos(geo)) + xp.sum(xp.sin(2.0 * grad))


def test_autograd_matches_jax_grad():
    """tests/test_fused_mlp.py:133-167's loss through both packages."""
    pos, ws, bs = make_inputs(1)

    def loss_jax(p, w, b):
        sdf, geo, grad = jax_fused_sdf_chain(p, list(w), list(b), mode="adjoint", **KW)
        return _loss_terms(sdf, geo.astype(jnp.float32), grad, jnp)

    jg = jax.grad(loss_jax, argnums=(0, 1, 2))(
        jnp.asarray(pos), tuple(jnp.asarray(w) for w in ws), tuple(jnp.asarray(b) for b in bs))
    tp = torch.tensor(pos, requires_grad=True)
    tw = [torch.tensor(w, requires_grad=True) for w in ws]
    tb = [torch.tensor(b, requires_grad=True) for b in bs]
    sdf, geo, grad = fused_sdf_chain(tp, tw, tb, **KW)
    _loss_terms(sdf, geo.float(), grad, torch).backward()
    assert rel_l2(tp.grad.numpy(), jg[0]) <= 1e-2
    for l in range(len(ws)):
        assert rel_l2(tw[l].grad.numpy(), jg[1][l]) <= 1e-2, l
        assert rel_l2(tb[l].grad.numpy(), jg[2][l]) <= 1e-2, l


@pytest.mark.parametrize("activation,skip", [("SoftplusQuad", (2,)), ("ReLU", (3,))])
def test_function_backward_is_the_plain_backward(activation, skip):
    """The Function hands the cotangents (ggeo rounded to bf16) to the plain
    backward on the CPU and returns its gradients; ReLU has no act''
    injections, and a skip at the last layer feeds x0 into its input."""
    pos, ws, bs = make_inputs(2, n=40, skip=skip)
    kw = dict(KW, activation=activation, skip=skip)
    rng = np.random.default_rng(3)
    gsdf = torch.from_numpy(rng.normal(size=40).astype(np.float32))
    ggeo = torch.from_numpy(rng.normal(size=(40, 128)).astype(np.float32))
    g3 = torch.from_numpy(rng.normal(size=(40, 3)).astype(np.float32))
    tp = torch.tensor(pos, requires_grad=True)
    tw = [torch.tensor(w, requires_grad=True) for w in ws]
    tb = [torch.tensor(b, requires_grad=True) for b in bs]
    sdf, geo, grad = fused_sdf_chain(tp, tw, tb, **kw)
    assert torch.equal(sdf.detach(), fused_sdf_chain_plain(tp, tw, tb, **kw)[0])
    torch.autograd.backward([sdf, geo, grad], [gsdf, ggeo.to(torch.bfloat16), g3])
    d_pos, gws, gbs = fused_sdf_chain_bwd_plain(
        torch.from_numpy(pos), [torch.from_numpy(w) for w in ws],
        [torch.from_numpy(b) for b in bs], gsdf, ggeo, g3, **kw)
    assert torch.equal(tp.grad, d_pos)
    for l in range(len(ws)):
        assert torch.equal(tw[l].grad, gws[l]) and torch.equal(tb[l].grad, gbs[l])
    assert all(float(g.abs().max()) > 0 for g in (*gws, *gbs))


def test_jvp_mode_and_bad_channel_raise():
    """jvp mode (K4j) runs and agrees with the adjoint mode on the same
    inputs to bf16 noise (rel-L2 1e-2; the two modes round at different
    points); a channel other than the sdf column raises."""
    pos, ws, bs = make_inputs(4, n=40)
    args = (torch.from_numpy(pos), [torch.from_numpy(w) for w in ws],
            [torch.from_numpy(b) for b in bs])
    for a, b in zip(fused_sdf_chain(*args, mode="jvp", **KW), fused_sdf_chain(*args, **KW)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert rel_l2(a.float().numpy(), b.float().numpy()) <= 1e-2
    with pytest.raises(ValueError, match="column 0"):
        fused_sdf_chain(*args, tangent_out_channel=1, **KW)


def test_cpu_wrapper_counts_no_launch():
    pos, ws, bs = make_inputs(5, n=8)
    build.reset_launch_counts()
    fused_sdf_chain(torch.from_numpy(pos), [torch.from_numpy(w) for w in ws],
                    [torch.from_numpy(b) for b in bs], **KW)
    assert build.KERNELS["fused_sdf_chain"].launches == 0
