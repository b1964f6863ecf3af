"""The tangent backward (K1t with K = 1, 2 and 3 tangents; K4j, the
encoding and its 3 basis tangents in front) in two parts, on the CPU: the
per-tile pass and the stacked gW product.

On the card the backward of the tangent chains is a per-tile pass over
64-row tiles of b samples' primal and tangent rows that writes gx and gtx
(K1t) or d pos (K4j), gb and, per layer, the stacks of its gW operands,
Hin_l = [hin_l; tin_l] and G_l = [gz_l; gu_l] (csrc/fused_mlp.cu), and
chain_wgrad, gW_l = Hin_l^T G_l over the stacked rows. Their plain versions,
composed, must give the plain backward: the same f32 products summed in
another order, so within rel-L2 1e-6; and JAX's vjp of its Pallas kernel
in interpret mode within the 1e-2 of tests/test_torch_chain_tangents.py,
on a 3-layer SoftplusQuad chain and a 10-layer ReLU chain with a skip at
layer 4 (tests/test_torch_chain_wgrad.py's pair), at N = 29 (a ragged last
tile of 16 or 32 samples).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodalstudio_tpu.ops.pallas.fused_mlp import fused_chain as jax_fused_chain
from multimodalstudio_tpu.ops.pallas.fused_mlp import fused_sdf_chain as jax_fused_sdf_chain
from multimodalstudio_tpu_torch.ops.kernels import fused_mlp as fm
from multimodalstudio_tpu_torch.ops.kernels import sdf_chain as sc

torch.set_num_threads(1)

N = 29
SAME_MATH = 1e-6
JAX_REL = 1e-2  # tests/test_torch_chain_tangents.py's limit on every gradient
PE = dict(num_frequencies=6, min_freq_exp=0.0, max_freq_exp=5.0)
CHAINS = {  # name: (hidden, d_out, layers, skip, activation)
    "3 layers": (128, 65, 3, (), "SoftplusQuad"),
    "10 layers, skip": (128, 17, 10, (4,), "ReLU"),
}
# K1t with 1, 2 and 3 tangents (tiles of 32 and 16 samples), the tangents'
# cotangent on one channel or on all of ty; K4j
KINDS = {"K1t K=1": (1, 0), "K1t K=2": (2, None), "K1t K=3": (3, 1), "K4j": (3, 0)}


def rel_l2(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def make_case(seed, kind, name):
    """Inputs, parameters and cotangents as numpy arrays: K1t's x [N, 39],
    tangents [K, N, 39] and (gy, gty); K4j's positions and (gsdf, ggeo, g3)."""
    hidden, d_out, n_layers, skip, act = CHAINS[name]
    k, channel = KINDS[kind]
    if kind == "K4j":  # the JAX SDF chains take geo widths that are multiples of 128
        d_out = 129
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for l in range(n_layers):
        din = 39 if l == 0 else hidden + (39 if l in skip else 0)
        dout = d_out if l == n_layers - 1 else hidden
        ws.append((rng.normal(size=(din, dout)) / np.sqrt(din)).astype(np.float32))
        bs.append((0.05 * rng.normal(size=(dout,))).astype(np.float32))
    if kind == "K4j":
        x = (rng.uniform(-0.9, 0.9, size=(N, 3)).astype(np.float32),)
        cot = (rng.normal(size=N).astype(np.float32),
               rng.normal(size=(N, d_out - 1)).astype(np.float32),
               rng.normal(size=(N, 3)).astype(np.float32))
        kw = dict(PE, skip=skip, activation=act, beta=100.0)
    else:
        x = (rng.uniform(-1.0, 1.0, size=(N, 39)).astype(np.float32),
             rng.normal(size=(k, N, 39)).astype(np.float32))
        cot = (rng.normal(size=(N, d_out)).astype(np.float32),
               rng.normal(size=(N, k) if channel is not None else (k, N, d_out)).astype(np.float32))
        kw = dict(skip=skip, activation=act, beta=100.0, tangent_out_channel=channel)
    return x, ws, bs, cot, kw


def torch_args(x, ws, bs, cot):
    t = torch.from_numpy
    return [t(v) for v in x], [t(w) for w in ws], [t(b) for b in bs], [t(c) for c in cot]


def composed(kind, x, ws, bs, cot, kw):
    """The plain per-tile pass, then the plain stacked gW: (the input
    gradients, gW, gb, the Hin and G stacks)."""
    x, ws, bs, cot = torch_args(x, ws, bs, cot)
    if kind == "K4j":
        d_pos, hins, gzs, gbs = sc.fused_sdf_chain_jvp_bwd_tile_plain(
            x[0], ws, bs, cot[0], cot[1].to(torch.bfloat16), cot[2], **kw)
        grads = (d_pos,)
    else:
        gty = cot[1] if kw["tangent_out_channel"] is not None else cot[1].to(torch.bfloat16)
        gx, gtx, hins, gzs, gbs = fm.fused_chain_tangent_bwd_tile_plain(
            x[0], x[1], cot[0].to(torch.bfloat16), gty, ws, bs, **kw)
        grads = (gx, gtx)
    return grads, fm.chain_wgrad_plain(hins, gzs), gbs, hins, gzs


def plain(kind, x, ws, bs, cot, kw):
    x, ws, bs, cot = torch_args(x, ws, bs, cot)
    if kind == "K4j":
        d_pos, gws, gbs = sc.fused_sdf_chain_jvp_bwd_plain(x[0], ws, bs, cot[0],
                                                           cot[1].to(torch.bfloat16), cot[2], **kw)
        return (d_pos,), gws, gbs
    gty = cot[1] if kw["tangent_out_channel"] is not None else cot[1].to(torch.bfloat16)
    gx, gtx, gws, gbs = fm.fused_chain_tangent_bwd_plain(x[0], x[1], cot[0].to(torch.bfloat16),
                                                         gty, ws, bs, **kw)
    return (gx, gtx), gws, gbs


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("name", list(CHAINS))
def test_parts_compose_to_the_plain_backward(kind, name):
    x, ws, bs, cot, kw = make_case(31, kind, name)
    grads, gws, gbs, hins, gzs = composed(kind, x, ws, bs, cot, kw)
    rgrads, rws, rbs = plain(kind, x, ws, bs, cot, kw)
    for g, r in zip(grads, rgrads):
        assert g.dtype == r.dtype and rel_l2(g.float(), r.float()) <= SAME_MATH
    rows = N * (1 + KINDS[kind][0])  # the primal rows and every tangent's
    for l in range(len(ws)):
        assert rel_l2(gws[l], rws[l]) <= SAME_MATH, l
        assert rel_l2(gbs[l], rbs[l]) <= SAME_MATH, l
        assert tuple(hins[l].shape) == (rows, ws[l].shape[0]), l
        assert tuple(gzs[l].shape) == (rows, ws[l].shape[1]), l
        for t in (hins[l], gzs[l]):
            assert torch.equal(t, t.to(torch.bfloat16).float()), l


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("name", list(CHAINS))
def test_parts_match_jax_vjp(kind, name):
    x, ws, bs, cot, kw = make_case(32, kind, name)
    jx, jw = [jnp.asarray(v) for v in x], [jnp.asarray(w) for w in ws]
    jb = [jnp.asarray(b) for b in bs]
    if kind == "K4j":
        outs, vjp = jax.vjp(lambda p, w, b: jax_fused_sdf_chain(p, w, b, mode="jvp", **kw), jx[0],
                            jw, jb)
    else:
        outs, vjp = jax.vjp(lambda p, t, w, b: jax_fused_chain(p, w, b, tangents=t, **kw), *jx, jw,
                            jb)
    *rgrads, rgw, rgb = vjp(tuple(jnp.asarray(c, o.dtype) for c, o in zip(cot, outs)))
    grads, gws, gbs, _, _ = composed(kind, x, ws, bs, cot, kw)
    for g, r in zip(grads, rgrads):
        assert rel_l2(g.float(), np.asarray(r, np.float32)) <= JAX_REL
    for l in range(len(ws)):
        assert rel_l2(gws[l], rgw[l]) <= JAX_REL, l
        assert rel_l2(gbs[l], rgb[l]) <= JAX_REL, l
