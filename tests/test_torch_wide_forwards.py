"""The adjoint and tangent forwards and K2's backward at hidden widths past
512, on the CPU.

On the card every chain kernel now runs on K1's building blocks, whose
width classes take every hidden width JAX's can_fuse sends to its fused
kernels (a multiple of 128): the adjoint forward of K3/K3f, K4 and K5
(csrc/adj_fwd.cuh), the tangent forward of K1t and K4j
(csrc/tangent_fwd.cu) and K2's backward, the value mode of K3's pass
(csrc/slot_chain_bwd.cu). Their forward wrappers lay the chain out with
chain_layout, which refuses a width that is not a multiple of 128 and
names JAX's rule. The adjoint forward reads the pack's images: the
forward images of every layer (K4's last layer holds sdf and geo) and the
last layer's backward images, whose column `channel` seeds the adjoint
sweep; both must give back the padded weights bit for bit.

The plain versions (what a CPU tensor runs, and what chip_smoke.py holds
the kernels against) must match JAX's kernels in Pallas interpret mode at
hidden widths 640 and 768 (3 layers with a skip at layer 2, or the slot
chain's 2 hidden layers), N <= 29: the forwards within rel-L2 1e-2 (bf16
outputs and activations, another summation order), and the gradients of
a loss through the port's Functions (their plain backwards, K3's reading
its plain forward's residuals) within 1e-3 of jax.grad, as
tests/test_torch_wide_chain.py holds K1's; K3's within 1e-2, the card
checks' limit: on this draw one pre-activation of one row (15 of 29) rounds
to the other bf16 neighbour on the two sides (forward grad 9.6e-4 apart),
and the flip reaches that row's second-order trilerp fold, d pos 4.4e-3,
d table 3.6e-3 and gW 3.1e-3 apart (other draws at 640 and 768: 6e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodalstudio_tpu.ops.pallas import slot_fused as jsf
from multimodalstudio_tpu.ops.pallas import slot_grid as jsg
from multimodalstudio_tpu.ops.pallas.fused_mlp import fused_chain as jax_fused_chain
from multimodalstudio_tpu.ops.pallas.fused_mlp import fused_chain_adjoint as jax_chain_adjoint
from multimodalstudio_tpu.ops.pallas.fused_mlp import fused_sdf_chain as jax_fused_sdf_chain
from multimodalstudio_tpu_torch.ops.kernels import fused_mlp as fm
from multimodalstudio_tpu_torch.ops.kernels import sdf_chain as sc
from multimodalstudio_tpu_torch.ops.kernels import slot_fused as tsf
from multimodalstudio_tpu_torch.ops.kernels import slot_grid as tsg
from test_torch_chain_wgrad import unpack_forward_images

torch.set_num_threads(1)

FWD_REL = 1e-2  # the forwards' limit (tests/test_torch_wide_chain.py)
VJP_REL = 1e-3  # the gradients' limit against JAX's (the same file's)
N = 29
F, MN, MX = 6, 0.0, 5.0
SDF_KW = dict(num_frequencies=F, min_freq_exp=MN, max_freq_exp=MX, skip=(2,),
              activation="SoftplusQuad", beta=100.0)


def rel_l2(a, b):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def make_chain(seed, d_in, hidden, d_out, skip=(2,), n_layers=4):
    """Weights and biases of an n_layers chain (layer 2 a skip layer)."""
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for l in range(n_layers):
        din = d_in if l == 0 else hidden + (d_in if l in skip else 0)
        dout = d_out if l == n_layers - 1 else hidden
        ws.append((rng.normal(size=(din, dout)) / np.sqrt(din)).astype(np.float32))
        bs.append((0.01 * rng.normal(size=(dout,))).astype(np.float32))
    return rng, ws, bs


def _jax(ws, bs):
    return tuple(jnp.asarray(w) for w in ws), tuple(jnp.asarray(b) for b in bs)


def _leaves(*arrays):
    return [[torch.tensor(v, requires_grad=True) for v in a] if isinstance(a, list)
            else torch.tensor(a, requires_grad=True) for a in arrays]


@pytest.mark.parametrize("hidden", [320, 640, 768, 1024])
def test_forward_layouts_take_the_widths_jax_fuses(hidden, monkeypatch):
    """The adjoint and tangent forwards' wrappers lay the chain out with
    chain_layout: a multiple of 128 past 512 is taken, 320 refused naming
    JAX's can_fuse rule (before any launch: the device checks are lifted)."""
    shapes = [(39, hidden), (hidden, hidden), (hidden + 39, hidden), (hidden, 257)]
    ws = [torch.zeros(*s) for s in shapes]
    bs = [torch.zeros(s[1]) for s in shapes]
    if hidden != 320:
        for adjoint in (False, True):
            layout = fm.chain_of(39, ws, (2,), "SoftplusQuad", 100.0, adjoint)[0]
            assert layout.hidden == hidden and layout.din_pad == (64, hidden, hidden + 64, hidden)
        return
    monkeypatch.setattr(fm, "check_card", lambda *a, **k: None)
    monkeypatch.setattr(sc, "check_card", lambda *a, **k: None)
    pe = tsf.pe_scales(F, MN, MX)
    pos, x = torch.zeros(4, 3), torch.zeros(4, 39)
    launches = [
        lambda: sc._launch_fwd(pos, ws, bs, (2,), "SoftplusQuad", 100.0, pe),
        lambda: sc._launch_jvp_fwd(pos, ws, bs, (2,), "SoftplusQuad", 100.0, pe),
        lambda: sc._launch_adj_fwd(x, ws, bs, (2,), "SoftplusQuad", 100.0, 0),
        lambda: fm._launch_tangent_fwd(x, torch.zeros(3, 4, 39), ws, bs, (2,), "SoftplusQuad",
                                       100.0, 0),
    ]
    for launch in launches:
        with pytest.raises(ValueError, match="hidden width 320.*can_fuse.*multiples of 128"):
            launch()


@pytest.mark.parametrize("hidden,d_out,channel", [(640, 257, 0), (768, 33, 1)])
def test_pack_gives_the_adjoint_forward_its_images(hidden, d_out, channel):
    """The forward images of every layer (K4's last layer: sdf and geo) and
    the last layer's backward images, whose column `channel` the adjoint
    sweep starts from (csrc/k1.cuh last_column), equal the padded weights
    bit for bit."""
    _, ws, bs = make_chain(1, 39, hidden, d_out)
    tw, tb = [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs]
    layout = fm.chain_layout(39, [w.shape for w in ws], (2,), adjoint=True)
    wfw, wbw, bpk = fm.pack_plain(layout, tw, tb)
    for l, wp in enumerate(unpack_forward_images(layout, wfw)):
        assert torch.equal(wp[: ws[l].shape[0], : ws[l].shape[1]], tw[l].to(torch.bfloat16).float())
        assert not wp[ws[l].shape[0]:].any() and not wp[:, ws[l].shape[1]:].any()
    last = layout.n_layers - 1
    column, base = torch.zeros(layout.din_pad[last]), layout.bw_off[last]
    for off, np_ in layout.bwd_pieces(last):
        kc = channel // 64  # the 64-deep chunk of the images that holds the column
        img = wbw[base + kc * np_ * 64: base + (kc + 1) * np_ * 64].float().reshape(np_, 64)
        column[off:off + np_] = fm.swizzle_units(img)[:, channel % 64]
        base += np_ * layout.gcols(last)
    want = torch.zeros(layout.din_pad[last])
    want[:hidden] = tw[last][:hidden, channel].to(torch.bfloat16).float()
    want[hidden:hidden + 39] = tw[last][hidden:, channel].to(torch.bfloat16).float()
    assert torch.equal(column, want)
    assert torch.equal(bpk[layout.b_off[last]:layout.b_off[last] + d_out], tb[last])


@pytest.mark.parametrize("mode", ["adjoint", "jvp"])
def test_sdf_chain_matches_pallas_at_640(mode):
    """K4 (adjoint) and K4j (jvp): sdf, geo and grad, then the gradient of a
    loss on all three through positions, every gW and gb."""
    rng, ws, bs = make_chain(2, 39, 640, 257)
    pos = rng.uniform(-0.9, 0.9, size=(N, 3)).astype(np.float32)
    c = rng.normal(size=(N, 256)).astype(np.float32)

    def loss(sdf, geo, grad, xp):
        return xp.sum(xp.sin(3.0 * sdf)) + xp.sum(geo * xp.asarray(c)) * 0.01 + xp.sum(grad ** 2)

    def jloss(p, w, b):
        sdf, geo, grad = jax_fused_sdf_chain(p, list(w), list(b), mode=mode, **SDF_KW)
        return loss(sdf, geo.astype(jnp.float32), grad, jnp), (sdf, geo, grad)

    jg, (jsdf, jgeo, jgrad) = jax.grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(pos), *_jax(ws, bs))
    tp, tw, tb = _leaves(pos, ws, bs)
    sdf, geo, grad = sc.fused_sdf_chain(tp, tw, tb, mode=mode, **SDF_KW)
    assert rel_l2(sdf, jsdf) <= FWD_REL and rel_l2(grad, jgrad) <= FWD_REL
    assert rel_l2(geo, np.asarray(jgeo, np.float32)) <= FWD_REL
    loss(sdf, geo.float(), grad, torch).backward()
    assert rel_l2(tp.grad, jg[0]) <= VJP_REL
    for l in range(4):
        assert rel_l2(tw[l].grad, jg[1][l]) <= VJP_REL, l
        assert rel_l2(tb[l].grad, jg[2][l]) <= VJP_REL, l


def test_chain_adjoint_matches_pallas_at_768():
    """K5 on channel 1: y and adj, then the gradient of a loss on both."""
    rng, ws, bs = make_chain(3, 15, 768, 33)
    x = (0.5 * rng.normal(size=(N, 15))).astype(np.float32)
    gy = rng.normal(size=(N, 33)).astype(np.float32)
    ga = rng.normal(size=(N, 15)).astype(np.float32)
    kw = dict(skip=(2,), activation="SoftplusQuad", beta=100.0, channel=1)

    def loss(y, adj, xp):
        return xp.sum(y * xp.asarray(gy)) + xp.sum(adj * xp.asarray(ga))

    def jloss(xj, w, b):
        y, adj = jax_chain_adjoint(xj, list(w), list(b), **kw)
        return loss(y.astype(jnp.float32), adj, jnp), (y, adj)

    jg, (jy, jadj) = jax.grad(jloss, argnums=(0, 1, 2), has_aux=True)(jnp.asarray(x),
                                                                      *_jax(ws, bs))
    tx, tw, tb = _leaves(x, ws, bs)
    y, adj = sc.fused_chain_adjoint(tx, tw, tb, **kw)
    assert rel_l2(y, np.asarray(jy, np.float32)) <= FWD_REL and rel_l2(adj, jadj) <= FWD_REL
    loss(y.float(), adj, torch).backward()
    assert rel_l2(tx.grad, jg[0]) <= VJP_REL
    for l in range(4):
        assert rel_l2(tw[l].grad, jg[1][l]) <= VJP_REL, l
        assert rel_l2(tb[l].grad, jg[2][l]) <= VJP_REL, l


def test_tangent_chain_matches_pallas_at_640():
    """K1t with 3 tangents on channel 0: y and ty, then gx, gtx, every gW and
    gb for the same cotangents through jax.vjp."""
    rng, ws, bs = make_chain(4, 39, 640, 17)
    x = rng.uniform(-1.0, 1.0, size=(N, 39)).astype(np.float32)
    tx = rng.normal(size=(3, N, 39)).astype(np.float32)
    gy = rng.normal(size=(N, 17)).astype(np.float32)
    gty = rng.normal(size=(N, 3)).astype(np.float32)
    kw = dict(skip=(2,), activation="SoftplusQuad", beta=100.0, tangent_out_channel=0)
    jws, jbs = _jax(ws, bs)
    (ry, rty), vjp = jax.vjp(lambda a, t, w, b: jax_fused_chain(a, list(w), list(b), tangents=t,
                                                                **kw),
                             jnp.asarray(x), jnp.asarray(tx), jws, jbs)
    rgx, rgtx, rgw, rgb = vjp((jnp.asarray(gy, ry.dtype), jnp.asarray(gty, rty.dtype)))
    tx_, ttx, tw, tb = _leaves(x, tx, ws, bs)
    y, ty = fm.fused_chain(tx_, tw, tb, tangents=ttx, **kw)
    assert rel_l2(y, np.asarray(ry, np.float32)) <= FWD_REL and rel_l2(ty, rty) <= FWD_REL
    torch.autograd.backward([y, ty], [torch.from_numpy(gy).to(y.dtype), torch.from_numpy(gty)])
    assert rel_l2(tx_.grad, rgx) <= FWD_REL and rel_l2(ttx.grad, rgtx) <= FWD_REL
    for l in range(4):
        assert rel_l2(tw[l].grad, rgw[l]) <= FWD_REL, l
        assert rel_l2(tb[l].grad, rgb[l]) <= FWD_REL, l


SPEC = dict(num_levels=3, min_res=4, max_res=16, rows_per_level=64, layout="cell", feats=2,
            table_dtype="bf16")
PE = dict(num_frequencies=4, min_freq_exp=0.0, max_freq_exp=3.0)


def _slot_inputs(seed, hidden):
    rng = np.random.default_rng(seed)
    d_in = 3 + 6 * PE["num_frequencies"] + 3 * SPEC["feats"]
    dims = [(d_in, hidden), (hidden, hidden), (hidden, 65)]
    ws = [(rng.normal(size=d) / np.sqrt(d[0])).astype(np.float32) for d in dims]
    bs = [(0.1 * rng.normal(size=(d[1],))).astype(np.float32) for d in dims]
    table = rng.uniform(-1.0, 1.0, size=(tsg.SlotGridSpec(**SPEC).total_rows, 128))
    pos = rng.uniform(-1.2, 1.2, size=(N, 3)).astype(np.float32)
    return pos, table.astype(np.float32), ws, bs


def _slot_grads_match(jgrads, tp, tt, tw, tb, tol=VJP_REL):
    assert rel_l2(tp.grad, jgrads[0]) <= tol, "d_pos"
    assert rel_l2(tt.grad, jgrads[1]) <= tol, "d_table"
    for l in range(len(tw)):
        assert rel_l2(tw[l].grad, jgrads[2][l]) <= tol, ("gW", l)
        assert rel_l2(tb[l].grad, jgrads[3][l]) <= tol, ("gb", l)


def test_slot_chain_forward_and_its_residuals_match_pallas_at_640():
    """K3: sdf, geo and grad, and the gradient of a loss on all three
    through the plain backward, which reads the plain forward's residuals
    zs, ss [L-1, N, H] bf16 and adj [N, d_in] f32."""
    pos, table, ws, bs = _slot_inputs(5, 640)
    jspec, tspec = jsg.SlotGridSpec(**SPEC), tsg.SlotGridSpec(**SPEC)

    def loss(s, g, d, lib):
        return lib.sum(lib.sin(3.0 * s)) + lib.sum(lib.cos(d) * 0.7) + lib.sum(lib.sin(g)) * 0.1

    def jloss(p, t, w, b):
        s, g, d = jsf.fused_slot_sdf_chain(p, t, list(w), list(b), jspec, radius=1.0, **PE)
        return loss(s, g.astype(jnp.float32), d, jnp), (s, g, d)

    jg, (js, jgeo, jd) = jax.grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(pos), jnp.asarray(table), *_jax(ws, bs))
    tp, tt, tw, tb = _leaves(pos, table, ws, bs)
    s, g, d = tsf.fused_slot_sdf_chain(tp, tt, tw, tb, tspec, radius=1.0, **PE)
    assert rel_l2(s, js) <= FWD_REL and rel_l2(d, jd) <= FWD_REL
    assert rel_l2(g, np.asarray(jgeo, np.float32)) <= FWD_REL
    pe = tsf.pe_scales(PE["num_frequencies"], PE["min_freq_exp"], PE["max_freq_exp"])
    _, (zs, ss, adj, _) = tsf._chain_fwd_plain(tp.detach(), tt.detach(), tw, tb, tspec, 1.0, pe,
                                               "SoftplusQuad", 100.0, torch.ones(6))
    assert zs.dtype == ss.dtype == torch.bfloat16 and tuple(zs.shape) == (2, N, 640)
    assert adj.dtype == torch.float32 and tuple(adj.shape) == (N, 3 + 24 + 6)
    loss(s, g.float(), d, torch).backward()
    _slot_grads_match(jg, tp, tt, tw, tb, tol=FWD_REL)  # one flipped rounding: the docstring


def test_slot_value_vjp_matches_pallas_at_768():
    """K2's backward past 512 (its plain version, on the forward's zs) on a
    3-level table with 2 levels active: d pos, d table, every gW and gb
    against jax.grad."""
    pos, table, ws, bs = _slot_inputs(6, 768)
    jspec, tspec = jsg.SlotGridSpec(**SPEC), tsg.SlotGridSpec(**SPEC)
    mask = (np.arange(6) // 2 < 2).astype(np.float32)

    def jloss(p, t, w, b):
        s = jsf.fused_slot_sdf_value(p, t, list(w), list(b), jspec, radius=1.0, **PE,
                                     level_mask=jnp.asarray(mask))
        return jnp.sum(jnp.sin(3.0 * s)), s

    jg, js = jax.grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(pos), jnp.asarray(table), *_jax(ws, bs))
    tp, tt, tw, tb = _leaves(pos, table, ws, bs)
    s = tsf.fused_slot_sdf_value(tp, tt, tw, tb, tspec, radius=1.0, **PE,
                                 level_mask=torch.from_numpy(mask))
    assert rel_l2(s, js) <= FWD_REL
    torch.sin(3.0 * s).sum().backward()
    _slot_grads_match(jg, tp, tt, tw, tb)
    # the last layer's gradient lies in the sdf column only
    assert not tw[-1].grad[:, 1:].any() and not tb[-1].grad[1:].any()
