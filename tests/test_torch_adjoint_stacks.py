"""The adjoint backward (K4, the encoding in front; K5 without) in two parts,
on the CPU: the per-tile pass and the stacked gW product.

On the card the backward of the adjoint chains is a per-tile pass that
writes d pos (K4) or gx (K5), gb, the last layer's column term of gW and,
per layer, the stacks of its gW operands, A_l = [hin_l; qin_l] and B_l =
[gz_l; v_l] (csrc/sdf_chain.cu), and chain_wgrad, gW_l = A_l^T B_l over the
2N stacked rows. Their plain versions, composed, must give the plain
backward: the same f32 products summed in another order, so within rel-L2
1e-6; and JAX's vjp of its Pallas kernel in interpret mode within the
limits of tests/test_torch_sdf_chain.py (1e-2, K4) and
tests/test_torch_chain_adjoint.py (1e-3, K5), on a 3-layer SoftplusQuad
chain and a 10-layer ReLU chain with a skip at layer 4, at N = 29 (a
ragged last 64-row tile). The 10-layer chain is ReLU, as in
tests/test_torch_chain_wgrad.py: with SoftplusQuad, K5's gW_0 differed
from JAX's by rel-L2 1.1e-3 there, bf16 roundings flipped by the two sides'
summation orders over ten layers, above the 1e-3 its 4-layer file holds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodalstudio_tpu.ops.pallas.fused_mlp import fused_chain_adjoint as jax_chain_adjoint
from multimodalstudio_tpu.ops.pallas.fused_mlp import fused_sdf_chain as jax_fused_sdf_chain
from multimodalstudio_tpu_torch.ops.kernels import sdf_chain as sc

torch.set_num_threads(1)

N = 29
SAME_MATH = 1e-6
JAX_REL = {"K4": 1e-2, "K5": 1e-3}  # the limits of the K4 and K5 test files
PE = dict(num_frequencies=6, min_freq_exp=0.0, max_freq_exp=5.0)
CHAINS = {  # name: (hidden, d_out, layers, skip, activation, channel)
    "3 layers": (128, 65, 3, (), "SoftplusQuad", 0),
    "10 layers, skip": (128, 17, 10, (4,), "ReLU", 1),
}


def rel_l2(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def make_case(seed, kind, name):
    """Inputs, parameters and cotangents of one case as numpy arrays: K4's
    positions and (gsdf, ggeo, g3), or K5's x [N, 15] and (gy, ga)."""
    hidden, d_out, n_layers, skip, act, channel = CHAINS[name]
    d_in = 39 if kind == "K4" else 15
    if kind == "K4":  # the JAX SDF chains take geo widths that are multiples of 128
        d_out = 129
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for l in range(n_layers):
        din = d_in if l == 0 else hidden + (d_in if l in skip else 0)
        dout = d_out if l == n_layers - 1 else hidden
        ws.append((rng.normal(size=(din, dout)) / np.sqrt(din)).astype(np.float32))
        bs.append((0.01 * rng.normal(size=(dout,))).astype(np.float32))
    if kind == "K4":
        x = rng.uniform(-0.9, 0.9, size=(N, 3)).astype(np.float32)
        cot = (rng.normal(size=N).astype(np.float32),
               rng.normal(size=(N, d_out - 1)).astype(np.float32),
               rng.normal(size=(N, 3)).astype(np.float32))
        kw = dict(PE, skip=skip, activation=act, beta=100.0)
    else:
        x = (0.5 * rng.normal(size=(N, d_in))).astype(np.float32)
        cot = (rng.normal(size=(N, d_out)).astype(np.float32),
               rng.normal(size=(N, d_in)).astype(np.float32))
        kw = dict(skip=skip, activation=act, beta=100.0, channel=channel)
    return x, ws, bs, cot, kw


def torch_args(x, ws, bs, cot):
    t = torch.from_numpy
    return t(x), [t(w) for w in ws], [t(b) for b in bs], [t(c) for c in cot]


def composed(kind, x, ws, bs, cot, kw):
    """The plain per-tile pass, then the plain stacked gW: (d_in grad, gW,
    gb, the A and B stacks)."""
    x, ws, bs, cot = torch_args(x, ws, bs, cot)
    if kind == "K4":
        ggeo = cot[1].to(torch.bfloat16)
        gx, a, b, gbs, col = sc.fused_sdf_chain_bwd_tile_plain(x, ws, bs, cot[0], ggeo, cot[2],
                                                               **kw)
        channel = 0
    else:
        gy = cot[0].to(torch.bfloat16)
        gx, a, b, gbs, col = sc.fused_chain_adjoint_bwd_tile_plain(x, ws, bs, gy, cot[1], **kw)
        channel = kw["channel"]
    return gx, sc.adjoint_wgrad_plain(a, b, col, channel), gbs, a, b


def plain(kind, x, ws, bs, cot, kw):
    x, ws, bs, cot = torch_args(x, ws, bs, cot)
    if kind == "K4":
        return sc.fused_sdf_chain_bwd_plain(x, ws, bs, cot[0], cot[1].to(torch.bfloat16), cot[2],
                                            **kw)
    return sc.fused_chain_adjoint_bwd_plain(x, ws, bs, cot[0].to(torch.bfloat16), cot[1], **kw)


@pytest.mark.parametrize("kind", ["K4", "K5"])
@pytest.mark.parametrize("name", list(CHAINS))
def test_parts_compose_to_the_plain_backward(kind, name):
    x, ws, bs, cot, kw = make_case(21, kind, name)
    gx, gws, gbs, a, b = composed(kind, x, ws, bs, cot, kw)
    rx, rws, rbs = plain(kind, x, ws, bs, cot, kw)
    assert gx.dtype == rx.dtype and rel_l2(gx.float(), rx.float()) <= SAME_MATH
    n_layers = len(ws)
    for l in range(n_layers):
        assert rel_l2(gws[l], rws[l]) <= SAME_MATH, l
        assert rel_l2(gbs[l], rbs[l]) <= SAME_MATH, l
        # two stacked products below the last layer, bf16 values throughout
        rows = N if l == n_layers - 1 else 2 * N
        assert tuple(a[l].shape) == (rows, ws[l].shape[0]), l
        assert tuple(b[l].shape) == (rows, ws[l].shape[1]), l
        for t in (a[l], b[l]):
            assert torch.equal(t, t.to(torch.bfloat16).float()), l


@pytest.mark.parametrize("kind", ["K4", "K5"])
@pytest.mark.parametrize("name", list(CHAINS))
def test_parts_match_jax_vjp(kind, name):
    x, ws, bs, cot, kw = make_case(22, kind, name)
    jw, jb = [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs]
    if kind == "K4":
        outs, vjp = jax.vjp(lambda p, w, b: jax_fused_sdf_chain(p, w, b, mode="adjoint", **kw),
                            jnp.asarray(x), jw, jb)
    else:
        outs, vjp = jax.vjp(lambda p, w, b: jax_chain_adjoint(p, w, b, **kw), jnp.asarray(x), jw,
                            jb)
    rgx, rgw, rgb = vjp(tuple(jnp.asarray(c, o.dtype) for c, o in zip(cot, outs)))
    gx, gws, gbs, _, _ = composed(kind, x, ws, bs, cot, kw)
    tol = JAX_REL[kind]
    assert rel_l2(gx.float(), np.asarray(rgx, np.float32)) <= tol
    for l in range(len(ws)):
        assert rel_l2(gws[l], rgw[l]) <= tol, l
        assert rel_l2(gbs[l], rgb[l]) <= tol, l
