"""The port's forward-tangent chains against the JAX Pallas kernels: K1t
(fused_chain with tangents) and K4j (fused_sdf_chain in jvp mode).

The port's plain versions, through its autograd Functions (what a CPU
tensor runs), are held against multimodalstudio_tpu's fused_chain and
fused_sdf_chain(mode="jvp") in Pallas interpret mode on the same numpy
inputs: 3 and 4 layers of width 128 (the JAX chains take hidden widths
that are multiples of 128), a skip at layer 2 or none, SoftplusQuad and
ReLU, N = 41 samples (not a multiple of the port's 16- or 32-sample tile).
Both round to bf16 at the same points and differ only by f32 summation
order, which can flip one bf16 rounding of an activation.

Tolerances: the bf16 outputs (y, the full ty, geo) rel-L2 <= 1e-2 (a
flipped rounding moves one element by one bf16 ulp); the f32 outputs (the
channel tangent, sdf, grad) 1e-3; every gradient (gx, gtx, gW, gb, d pos)
1e-2. The JAX package's own tests of these backwards against XLA autodiff
allow 8e-2 (tests/test_fused_mlp.py:117-197); the port and the Pallas
backwards share their cast points. Measured: K1t's y within 1.4e-5, the
channel tangent 3.6e-5 and the full ty 8.6e-5, gx and gtx exact, every gW
and gb within 1.4e-7; K4j's sdf / geo / grad within 1.4e-7 / 0 / 4.9e-8,
d pos 1.3e-7, gW and gb 1.3e-7.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodalstudio_tpu.ops.pallas.fused_mlp import fused_chain as jax_fused_chain
from multimodalstudio_tpu.ops.pallas.fused_mlp import fused_sdf_chain as jax_fused_sdf_chain
from multimodalstudio_tpu_torch.ops.kernels import build
from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import fused_chain
from multimodalstudio_tpu_torch.ops.kernels.sdf_chain import (
    fused_sdf_chain,
    fused_sdf_chain_jvp_bwd_plain,
    fused_sdf_chain_jvp_plain,
    fused_sdf_chain_plain,
)

torch.set_num_threads(1)

N = 41
F, MN, MX = 6, 0.0, 5.0
SDF_KW = dict(num_frequencies=F, min_freq_exp=MN, max_freq_exp=MX, skip=(2,), beta=100.0)
# (activation, skip, layers, tangent channel) of the K1t cases: the
# mlp_raw_tpu SDF chain's kind (SoftplusQuad, a skip) in both output modes,
# and ReLU (no act'' term) without a skip
CASES = [("SoftplusQuad", (2,), 4, 0), ("SoftplusQuad", (2,), 4, None), ("ReLU", (), 3, 0)]


def rel_l2(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def make_chain(seed, d_in, n_layers, skip, d_out=65, hidden=128):
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for l in range(n_layers):
        din = d_in if l == 0 else hidden + (d_in if l in skip else 0)
        dout = d_out if l == n_layers - 1 else hidden
        ws.append((rng.normal(size=(din, dout)) / np.sqrt(din)).astype(np.float32))
        bs.append((0.05 * rng.normal(size=(dout,))).astype(np.float32))
    x = rng.uniform(-1.0, 1.0, size=(N, d_in)).astype(np.float32)
    tx = rng.normal(size=(3, N, d_in)).astype(np.float32)
    return x, tx, ws, bs


def _jax(*arrays):
    return [jnp.asarray(a) if isinstance(a, np.ndarray) else [jnp.asarray(v) for v in a]
            for a in arrays]


def _torch(*arrays, grad=False):
    def one(a):
        return torch.tensor(a, requires_grad=grad)
    return [one(a) if isinstance(a, np.ndarray) else [one(v) for v in a] for a in arrays]


@pytest.mark.parametrize("activation,skip,n_layers,channel", CASES)
def test_tangent_chain_matches_pallas(activation, skip, n_layers, channel):
    """y and ty (column `channel` of the f32 tangents as [N, K], or all of
    them as [K, N, D_out] bf16), then gx, gtx, every gW and gb for the same
    cotangents, through the port's Function (the plain versions) and
    jax.vjp of the Pallas chain."""
    x, tx, ws, bs = make_chain(0, 39, n_layers, skip)
    kw = dict(skip=skip, activation=activation, beta=100.0, tangent_out_channel=channel)
    rng = np.random.default_rng(1)
    gy = rng.normal(size=(N, 65)).astype(np.float32)
    gty = rng.normal(size=(N, 3) if channel is not None else (3, N, 65)).astype(np.float32)
    jx, jtx, jws, jbs = _jax(x, tx, ws, bs)
    (ry, rty), vjp = jax.vjp(lambda *a: jax_fused_chain(a[0], a[2], a[3], tangents=a[1], **kw),
                             jx, jtx, jws, jbs)
    rgx, rgtx, rgw, rgb = vjp((jnp.asarray(gy, ry.dtype), jnp.asarray(gty, rty.dtype)))
    tx_, ttx, tws, tbs = _torch(x, tx, ws, bs, grad=True)
    build.reset_launch_counts()
    y, ty = fused_chain(tx_, tws, tbs, tangents=ttx, **kw)
    assert build.KERNELS["fused_chain_tangents"].launches == 0  # a CPU tensor: plain version
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (N, 65)
    assert rel_l2(y.detach().float().numpy(), np.asarray(ry, np.float32)) <= 1e-2
    if channel is None:
        assert ty.dtype == torch.bfloat16 and tuple(ty.shape) == (3, N, 65)
        assert rel_l2(ty.detach().float().numpy(), np.asarray(rty, np.float32)) <= 1e-2
    else:
        assert ty.dtype == torch.float32 and tuple(ty.shape) == (N, 3)
        assert rel_l2(ty.detach().numpy(), rty) <= 1e-3
    torch.autograd.backward([y, ty], [torch.from_numpy(gy).to(y.dtype),
                                      torch.from_numpy(gty).to(ty.dtype)])
    assert rel_l2(tx_.grad.numpy(), rgx) <= 1e-2
    assert rel_l2(ttx.grad.numpy(), rgtx) <= 1e-2
    for l in range(n_layers):
        assert rel_l2(tws[l].grad.numpy(), rgw[l]) <= 1e-2, l
        assert rel_l2(tbs[l].grad.numpy(), rgb[l]) <= 1e-2, l


def _sdf_inputs(seed):
    x, _, ws, bs = make_chain(seed, 3 + 6 * F, 4, SDF_KW["skip"], d_out=129)
    pos = np.random.default_rng(seed + 100).uniform(-0.9, 0.9, size=(N, 3)).astype(np.float32)
    return pos, ws, bs, dict(SDF_KW, activation="SoftplusQuad")


def _sdf_loss(sdf, geo, grad, xp):
    return xp.sum(xp.sin(sdf)) + xp.sum(xp.cos(geo)) + xp.sum(xp.sin(2.0 * grad))


def test_jvp_mode_matches_pallas():
    """sdf, geo, grad, and tests/test_fused_mlp.py:133-167's loss's d
    positions (through the encoding's Hessian diagonal), gW and gb, through
    both packages in jvp mode."""
    pos, ws, bs, kw = _sdf_inputs(2)

    def loss_jax(p, w, b):
        sdf, geo, grad = jax_fused_sdf_chain(p, list(w), list(b), mode="jvp", **kw)
        return _sdf_loss(sdf, geo.astype(jnp.float32), grad, jnp), (sdf, geo, grad)

    jpos, jws, jbs = _jax(pos, ws, bs)
    jg, ref = jax.grad(loss_jax, argnums=(0, 1, 2), has_aux=True)(jpos, tuple(jws), tuple(jbs))
    tpos, tws, tbs = _torch(pos, ws, bs, grad=True)
    build.reset_launch_counts()
    sdf, geo, grad = fused_sdf_chain(tpos, tws, tbs, mode="jvp", **kw)
    assert build.KERNELS["fused_sdf_chain_jvp"].launches == 0
    assert sdf.dtype == torch.float32 and tuple(sdf.shape) == (N,)
    assert geo.dtype == torch.bfloat16 and tuple(geo.shape) == (N, 128)
    assert grad.dtype == torch.float32 and tuple(grad.shape) == (N, 3)
    assert rel_l2(sdf.detach().numpy(), ref[0]) <= 1e-3
    assert rel_l2(geo.detach().float().numpy(), np.asarray(ref[1], np.float32)) <= 1e-2
    assert rel_l2(grad.detach().numpy(), ref[2]) <= 1e-3
    _sdf_loss(sdf, geo.float(), grad, torch).backward()
    assert rel_l2(tpos.grad.numpy(), jg[0]) <= 1e-2
    for l in range(len(ws)):
        assert rel_l2(tws[l].grad.numpy(), jg[1][l]) <= 1e-2, l
        assert rel_l2(tbs[l].grad.numpy(), jg[2][l]) <= 1e-2, l


def test_mode_variable_selects_the_jvp_route(monkeypatch):
    """MMS_SDF_CHAIN_MODE=jvp, read at call time, sends an adjoint-mode
    call through K4j's plain forward and backward; the two modes agree to
    bf16 noise on the same inputs (rel-L2 1e-2)."""
    pos, ws, bs, kw = _sdf_inputs(4)
    tpos, tws, tbs = _torch(pos, ws, bs, grad=True)
    monkeypatch.setenv("MMS_SDF_CHAIN_MODE", "jvp")
    out = fused_sdf_chain(tpos, tws, tbs, mode="adjoint", **kw)
    rng = np.random.default_rng(5)
    cot = [torch.from_numpy(rng.normal(size=o.shape).astype(np.float32)) for o in out]
    torch.autograd.backward(list(out), [cot[0], cot[1].to(torch.bfloat16), cot[2]])
    plain = _torch(pos, ws, bs)
    jvp = fused_sdf_chain_jvp_plain(*plain, **kw)
    for a, b in zip(out, jvp):
        assert torch.equal(a.detach(), b)
    assert torch.equal(tpos.grad, fused_sdf_chain_jvp_bwd_plain(*plain, *cot, **kw)[0])
    for a, b in zip(jvp, fused_sdf_chain_plain(*plain, **kw)):
        assert rel_l2(a.float().numpy(), b.float().numpy()) <= 1e-2
    monkeypatch.setenv("MMS_SDF_CHAIN_MODE", "scan")
    with pytest.raises(ValueError, match="unknown fused_sdf_chain mode"):
        fused_sdf_chain(*plain, **kw)
