"""K1's backward in two parts (the per-tile pass and chain_wgrad) and the
weight images of its pack, on the CPU.

The card runs K1's backward as a per-tile pass (gx, gb and the stacks of the
layer inputs hin_l and cotangents gz_l) and chain_wgrad (gW_l = hin_l^T gz_l
of every layer in one launch), csrc/fused_chain.cu. Their plain versions,
composed, must give the plain backward: the same f32 products in the same
order, so within rel-L2 1e-6; and JAX's fused_chain vjp (its Pallas
_bwd_kernel in interpret mode) within the 1e-3 of
tests/test_torch_fused_mlp.py::test_plain_backward_matches_jax_vjp, on a
3-layer chain and a 10-layer chain with a skip, at N = 29.

The pack writes each layer's weights as bf16 images in the 128-byte
swizzled K-major layout that wgmma reads; its plain version, unpacked, must
give back the padded weights, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodalstudio_tpu.ops.pallas.fused_mlp import fused_chain as jax_fused_chain
from multimodalstudio_tpu_torch.ops.kernels import fused_mlp as fm

torch.set_num_threads(1)

BWD_REL = 1e-3  # tests/test_torch_fused_mlp.py's limit against the JAX vjp
SAME_MATH = 1e-6

CHAINS = {  # name: (d_in, hidden, d_out, layers, skip, activation)
    "3 layers": (39, 128, 65, 3, (), "SoftplusQuad"),
    "10 layers, skip": (39, 128, 17, 10, (4,), "ReLU"),
}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def make_chain(seed, d_in, hidden, d_out, n_layers, skip, n=29):
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for l in range(n_layers):
        din = d_in if l == 0 else hidden + (d_in if l in skip else 0)
        dout = d_out if l == n_layers - 1 else hidden
        ws.append((rng.normal(size=(din, dout)) / np.sqrt(din)).astype(np.float32))
        bs.append((0.1 * rng.normal(size=(dout,))).astype(np.float32))
    x = rng.uniform(-1.0, 1.0, size=(n, d_in)).astype(np.float32)
    gy = rng.normal(size=(n, d_out)).astype(np.float32)
    return x, gy, ws, bs


def unpack_forward_images(layout, wfw):
    """The padded f32 weights [din_pad, dout_pad] of each layer out of the
    forward images (the inverse of fm.pack_plain's first output)."""
    out, pos = [], 0
    for l in range(layout.n_layers):
        wp = torch.zeros(layout.din_pad[l], layout.dout_pad[l])
        for off, np_ in fm.pieces(layout.dout_pad[l]):
            for kc in range(layout.din_pad[l] // 64):
                m = fm.swizzle_units(wfw[pos:pos + np_ * 64].float().reshape(np_, 64))
                wp[kc * 64:(kc + 1) * 64, off:off + np_] = m.T
                pos += np_ * 64
        out.append(wp)
    return out


def composed(x, gy, ws, bs, skip, activation):
    """The plain per-tile pass, then the plain chain_wgrad."""
    gx, hins, gzs, gbs = fm.chain_bwd_tile_plain(
        torch.from_numpy(x), torch.from_numpy(gy), [torch.from_numpy(w) for w in ws],
        [torch.from_numpy(b) for b in bs], skip=skip, activation=activation)
    return gx, fm.chain_wgrad_plain(hins, gzs), gbs, hins, gzs


@pytest.mark.parametrize("name", list(CHAINS))
def test_parts_compose_to_the_plain_backward(name):
    d_in, hidden, d_out, n_layers, skip, act = CHAINS[name]
    x, gy, ws, bs = make_chain(11, d_in, hidden, d_out, n_layers, skip)
    gx, gws, gbs, hins, gzs = composed(x, gy, ws, bs, skip, act)
    rx, rws, rbs = fm.fused_chain_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(gy).to(torch.bfloat16),
        [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs], skip=skip,
        activation=act)
    assert gx.dtype == torch.bfloat16 and rel_l2(gx.float(), rx.float()) <= SAME_MATH
    for l in range(n_layers):
        assert tuple(hins[l].shape) == (29, ws[l].shape[0])
        assert tuple(gzs[l].shape) == (29, ws[l].shape[1])
        assert rel_l2(gws[l], rws[l]) <= SAME_MATH, l
        assert rel_l2(gbs[l], rbs[l]) <= SAME_MATH, l
    # the stacks are bf16 values, gz_{L-1} is gy rounded to bf16
    for t in (*hins, *gzs):
        assert torch.equal(t, t.to(torch.bfloat16).float())
    assert torch.equal(gzs[-1], torch.from_numpy(gy).to(torch.bfloat16).float())


@pytest.mark.parametrize("name", list(CHAINS))
def test_parts_match_jax_vjp(name):
    d_in, hidden, d_out, n_layers, skip, act = CHAINS[name]
    x, gy, ws, bs = make_chain(12, d_in, hidden, d_out, n_layers, skip)

    def f(x, ws, bs):
        return jax_fused_chain(x, ws, bs, skip=skip, activation=act).astype(jnp.float32)

    _, vjp = jax.vjp(f, jnp.asarray(x), [jnp.asarray(w) for w in ws],
                     [jnp.asarray(b) for b in bs])
    rgx, rgw, rgb = vjp(jnp.asarray(gy))
    gx, gws, gbs, _, _ = composed(x, gy, ws, bs, skip, act)
    assert rel_l2(gx.float(), rgx) <= BWD_REL
    for l in range(n_layers):
        assert rel_l2(gws[l], rgw[l]) <= BWD_REL, l
        assert rel_l2(gbs[l], rgb[l]) <= BWD_REL, l


@pytest.mark.parametrize("d_in,hidden,d_out,skip", [(285, 256, 3, ()), (99, 128, 257, ()),
                                                    (285, 256, 256, (4,)), (39, 64, 17, (2,))])
def test_pack_round_trip(d_in, hidden, d_out, skip):
    n_layers = 8 if 4 in skip else 4
    _, _, ws, bs = make_chain(13, d_in, hidden, d_out, n_layers, skip, n=1)
    tw, tb = [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs]
    layout = fm.chain_layout(d_in, [w.shape for w in ws], skip)
    wfw, wbw, bpk = fm.pack_plain(layout, tw, tb)
    assert wfw.dtype == torch.bfloat16 and wfw.numel() == layout.fw_off[-1]
    assert wbw.numel() == layout.bw_off[-1] and bpk.numel() == layout.b_off[-1]
    for l, wp in enumerate(unpack_forward_images(layout, wfw)):
        want = torch.zeros(layout.din_pad[l], layout.dout_pad[l])
        want[: ws[l].shape[0], : ws[l].shape[1]] = tw[l].to(torch.bfloat16).float()
        assert torch.equal(wp, want), l
        assert torch.equal(bpk[layout.b_off[l]:layout.b_off[l] + ws[l].shape[1]], tb[l])
    # the backward images: layer l's, from the last layer's first, read back as W
    for l in range(n_layers):
        pos, depth = layout.bw_off[l], layout.gcols(l)
        back = torch.zeros(layout.din_pad[l], depth)
        for off, np_ in layout.bwd_pieces(l):
            for kc in range(depth // 64):
                m = fm.swizzle_units(wbw[pos:pos + np_ * 64].float().reshape(np_, 64))
                back[off:off + np_, kc * 64:(kc + 1) * 64] = m
                pos += np_ * 64
        din, dout = ws[l].shape
        assert torch.equal(back[:din, :dout], tw[l].to(torch.bfloat16).float()), l
        assert not back[din:].any() and not back[:, dout:].any(), l  # zero padding


def test_swizzle_and_stack_layout():
    m = torch.arange(16 * 64, dtype=torch.float32).reshape(16, 64)
    img = fm.swizzle_units(m)
    # row r keeps its units, permuted by unit ^ (r % 8); the permutation is its own inverse
    assert torch.equal(img[1, :8], m[1, 8:16]) and torch.equal(fm.swizzle_units(img), m)
    tiles, cols = 2, 128
    rows = torch.arange(tiles * 64 * cols, dtype=torch.float32).reshape(tiles * 64, cols)
    images = torch.cat([fm.swizzle_units(rows[t * 64:(t + 1) * 64, c:c + 64]).reshape(-1)
                        for t in range(tiles) for c in range(0, cols, 64)])
    assert torch.equal(fm.stack_rows(images, tiles, cols), rows)


def test_layout_refuses_what_the_card_does_not_take():
    with pytest.raises(ValueError, match="hidden width 96"):
        fm.chain_layout(39, [(39, 96), (96, 3)], ())
    with pytest.raises(ValueError, match="2 to 32 layers"):
        fm.chain_layout(39, [(39, 3)], ())
    with pytest.raises(ValueError, match="layer 0 cannot be a skip layer"):
        fm.chain_layout(39, [(39, 128), (128, 3)], (0,))
    layout = fm.chain_layout(285, [(285, 256), (256, 256), (541, 256), (256, 257)], (2,))
    assert layout.p0 == 320 and layout.din_pad == (320, 256, 576, 256)
    assert fm.pieces(272) == [(0, 256), (256, 16)]
    assert layout.bwd_pieces(2) == [(256, 256), (512, 64), (0, 256)]
    assert layout.bw_off[3] == 0 and layout.bw_off[0] < layout.bw_off[-1]
