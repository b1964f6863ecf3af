"""Hidden widths 384 and 512 on the card's chain kernels, on the CPU.

The card runs a hidden layer wider than 256 columns as two wgmma pieces
(256, then the rest), its first piece's output held in a side image until
the second's product retired (csrc/k1.cuh). chain_layout must lay such a
chain out as the kernels walk it: forward images per piece, the backward
product's h part in the same two pieces, and refuse a wider chain, naming
the shared-memory bound. The pack's images must give back the padded
weights bit for bit.

The plain versions (what a CPU tensor runs, and what chip_smoke.py holds
the kernels against) must match JAX's fused_chain in Pallas interpret mode
at those widths: the forward within rel-L2 1e-2 (bf16 output, another
summation order), the backward against jax.vjp within 1e-3, and K1's
per-tile pass and chain_wgrad, composed, within 1e-6 of the plain backward
(the same f32 products), as tests/test_torch_chain_wgrad.py holds them at
128. Inputs: 2 and 3 layers (one with a skip), N = 29.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodalstudio_tpu.ops.pallas.fused_mlp import fused_chain as jax_fused_chain
from multimodalstudio_tpu_torch.ops.kernels import fused_mlp as fm
from test_torch_chain_wgrad import composed, make_chain, rel_l2, unpack_forward_images

torch.set_num_threads(1)

BF16_REL = 1e-2  # tests/test_torch_fused_mlp.py's forward limit
BWD_REL = 1e-3  # its limit against the JAX vjp
SAME_MATH = 1e-6

CHAINS = {  # name: (d_in, hidden, d_out, layers, skip, activation)
    "384, 2 layers": (39, 384, 17, 2, (), "SoftplusQuad"),
    "384, 3 layers, skip": (39, 384, 65, 3, (2,), "ReLU"),
    "512, 2 layers": (51, 512, 3, 2, (), "ReLU"),
    "512, 3 layers, skip": (39, 512, 257, 3, (2,), "SoftplusQuad"),
}


def _torch(ws, bs):
    return [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs]


@pytest.mark.parametrize("hidden", [384, 512])
def test_layout_cuts_wide_hidden_layers_into_two_pieces(hidden):
    d_in, skip = 39, (2,)
    shapes = [(d_in, hidden), (hidden, hidden), (hidden + d_in, hidden), (hidden, 257)]
    layout = fm.chain_layout(d_in, shapes, skip)
    rest = hidden - 256
    assert fm.pieces(hidden) == [(0, 256), (256, rest)]
    assert layout.din_pad == (64, hidden, hidden + 64, hidden)
    # the backward product's h part in the forward's two pieces; a skip layer's x0 part first
    assert layout.bwd_pieces(1) == [(0, 256), (256, rest)]
    assert layout.bwd_pieces(2) == [(hidden, 64), (0, 256), (256, rest)]
    assert layout.bwd_pieces(0) == [(0, 64)]
    # the images of each layer cover its padded weight once
    assert layout.fw_off[-1] == sum(a * b for a, b in zip(layout.din_pad, layout.dout_pad))
    assert layout.bw_off[-1] == sum(a * layout.gcols(l) for l, a in enumerate(layout.din_pad))


@pytest.mark.parametrize("hidden", [384, 512])
def test_pack_round_trip_at_wide_widths(hidden):
    _, _, ws, bs = make_chain(21, 39, hidden, 65, 3, (2,), n=1)
    tw, tb = _torch(ws, bs)
    layout = fm.chain_layout(39, [w.shape for w in ws], (2,))
    wfw, wbw, _ = fm.pack_plain(layout, tw, tb)
    for l, wp in enumerate(unpack_forward_images(layout, wfw)):
        assert torch.equal(wp[: ws[l].shape[0], : ws[l].shape[1]], tw[l].to(torch.bfloat16).float())
    for l in range(3):
        pos, depth = layout.bw_off[l], layout.gcols(l)
        back = torch.zeros(layout.din_pad[l], depth)
        for off, np_ in layout.bwd_pieces(l):
            for kc in range(depth // 64):
                back[off:off + np_, kc * 64:(kc + 1) * 64] = fm.swizzle_units(
                    wbw[pos:pos + np_ * 64].float().reshape(np_, 64))
                pos += np_ * 64
        din, dout = ws[l].shape
        assert torch.equal(back[:din, :dout], tw[l].to(torch.bfloat16).float()), l
        assert not back[din:].any() and not back[:, dout:].any(), l


@pytest.mark.parametrize("hidden", [640, 1024, 96])
def test_layout_refuses_wider_chains_naming_the_bound(hidden):
    with pytest.raises(ValueError, match=f"hidden width {hidden}.*shared memory"):
        fm.chain_layout(39, [(39, hidden), (hidden, hidden), (hidden, 3)], ())


@pytest.mark.parametrize("name", list(CHAINS))
def test_plain_forward_matches_jax_at_wide_widths(name):
    d_in, hidden, d_out, n_layers, skip, act = CHAINS[name]
    x, _, ws, bs = make_chain(22, d_in, hidden, d_out, n_layers, skip)
    ref = jax_fused_chain(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                          [jnp.asarray(b) for b in bs], skip=skip, activation=act)
    got = fm.fused_chain_plain(torch.from_numpy(x), *_torch(ws, bs), skip=skip, activation=act)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (29, d_out)
    assert rel_l2(got.float(), np.asarray(ref, np.float32)) <= BF16_REL


@pytest.mark.parametrize("name", list(CHAINS))
def test_plain_backward_and_its_parts_match_jax_vjp_at_wide_widths(name):
    d_in, hidden, d_out, n_layers, skip, act = CHAINS[name]
    x, gy, ws, bs = make_chain(23, d_in, hidden, d_out, n_layers, skip)

    def f(x, ws, bs):
        return jax_fused_chain(x, ws, bs, skip=skip, activation=act).astype(jnp.float32)

    _, vjp = jax.vjp(f, jnp.asarray(x), [jnp.asarray(w) for w in ws],
                     [jnp.asarray(b) for b in bs])
    rgx, rgw, rgb = vjp(jnp.asarray(gy))
    gx, gws, gbs = fm.fused_chain_bwd_plain(torch.from_numpy(x), torch.from_numpy(gy),
                                            *_torch(ws, bs), skip=skip, activation=act)
    assert rel_l2(gx.float(), rgx) <= BWD_REL
    for l in range(n_layers):
        assert rel_l2(gws[l], rgw[l]) <= BWD_REL, l
        assert rel_l2(gbs[l], rgb[l]) <= BWD_REL, l
    # the per-tile pass and chain_wgrad, composed, give the plain backward
    cx, cws, cbs, hins, gzs = composed(x, gy, ws, bs, skip, act)
    assert rel_l2(cx.float(), gx.float()) <= SAME_MATH
    for l in range(n_layers):
        assert tuple(hins[l].shape) == (29, ws[l].shape[0])
        assert rel_l2(cws[l], gws[l]) <= SAME_MATH, l
        assert rel_l2(cbs[l], gbs[l]) <= SAME_MATH, l
