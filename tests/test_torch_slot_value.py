"""The host side of K2 (fused_slot_sdf_value's forward) on K1's forward, on
the CPU.

On the card K2 packs its chain with K1's pack kernel, the last layer cut to
its sdf column (value_chain: one 16-column piece), and launches the kernel
of csrc/slot_value.cu with the grid's SlotParams, built once per (grid,
levels, radius, encoding). For the chains it serves (grid_raw_tpu's 51 ->
128 -> 128 -> 257 on a bf16 table, the f32 table's 135-input chain, that
chain with a skip, and a 3-level table with 2 levels active) these tests
hold:

* the cut chain's layout and images: the hidden layers' forward images as
  the whole chain's, bit for bit, the last layer's as column 0 of its
  weight; the plain forward of the cut chain equal to the whole chain's
  (column 0 depends on no other column): zs and x0 bit for bit, sdf within
  rel-L2 1e-6 (the last product summed in another order on the CPU);
* SlotParams against the geometry arguments the first design's entry points
  took (_grid_args), and built once;
* the outputs K2 allocates against the residuals its backward reads (the
  plain forward's): zs [L-1, N, H] bf16, and x0 [N, rup16(d_in)] bf16;
* a chain wider than the card's hidden widths refused, naming the bound.
"""

import numpy as np
import pytest
import torch

from multimodalstudio_tpu_torch.ops.kernels import fused_mlp as fm
from multimodalstudio_tpu_torch.ops.kernels import slot_fused as sf
from multimodalstudio_tpu_torch.ops.kernels.slot_grid import SlotGridSpec, make_table_init
from test_torch_chain_wgrad import unpack_forward_images

torch.set_num_threads(1)

BF16 = SlotGridSpec(num_levels=6, min_res=16, max_res=512, rows_per_level=4096, layout="cell",
                    feats=2, table_dtype="bf16")
F32 = SlotGridSpec(num_levels=6, min_res=16, max_res=512, rows_per_level=512, layout="cell",
                   feats=16, table_dtype="f32")
SMALL = SlotGridSpec(num_levels=3, min_res=4, max_res=16, rows_per_level=64, layout="cell",
                     feats=2, table_dtype="bf16")
PE = sf.pe_scales(6, 0.0, 5.0)

CHAINS = {  # name: (grid, active levels k, layer widths, skip)
    "grid_raw_tpu, bf16": (BF16, 4, [(51, 128), (128, 128), (128, 257)], ()),
    "f32 table": (F32, 6, [(135, 128), (128, 128), (128, 257)], ()),
    "f32 table, skip": (F32, 6, [(135, 128), (128, 128), (263, 128), (128, 257)], (2,)),
    "3 levels, 2 active": (SMALL, 2, [(45, 128), (128, 128), (128, 257)], ()),
}


def make(name, n=37, seed=0):
    gspec, k, dims, skip = CHAINS[name]
    rng = np.random.default_rng(seed)
    ws = [torch.from_numpy((rng.normal(size=d) / np.sqrt(d[0])).astype(np.float32)) for d in dims]
    bs = [torch.from_numpy((0.1 * rng.normal(size=d[1])).astype(np.float32)) for d in dims]
    pos = torch.from_numpy(rng.uniform(-1.1, 1.1, size=(n, 3)).astype(np.float32))
    table = make_table_init(gspec)(torch.Generator().manual_seed(seed)) * 1e4
    mask = torch.ones(k * gspec.feats)
    mask[(k - 1) * gspec.feats:] = 0.5  # a partial coarse-to-fine mask
    return gspec, k, skip, ws, bs, pos, table, mask


@pytest.mark.parametrize("name", list(CHAINS))
def test_cut_chain_layout_and_images(name):
    gspec, k, skip, ws, bs, *_ = make(name)
    d_in = sf.value_d_in(gspec, PE)
    assert d_in == ws[0].shape[0]
    cws, cbs = sf.value_chain(ws, bs)
    assert tuple(cws[-1].shape) == (ws[-1].shape[0], 1) and tuple(cbs[-1].shape) == (1,)
    assert cws[-1].data_ptr() == ws[-1].data_ptr()  # a view: the pack reads it in place
    layout, geom = fm.chain_of(d_in, cws, skip, "SoftplusQuad", 100.0)
    whole = fm.chain_layout(d_in, [tuple(w.shape) for w in ws], skip)
    L = len(ws)
    assert layout.d_out == 1 and layout.dout_pad[-1] == 16 and fm.pieces(16) == [(0, 16)]
    assert layout.din_pad == whole.din_pad and layout.p0 == -(-d_in // 64) * 64
    assert (geom.L, geom.H, geom.P0, geom.d_in, geom.d_out) == (L, 128, layout.p0, d_in, 1)
    assert geom.skip_mask == sum(1 << l for l in skip)
    wfw, _, bpk = fm.pack_plain(layout, cws, cbs, backward=False)
    full, _, _ = fm.pack_plain(whole, ws, bs, backward=False)
    hidden = layout.fw_off[L - 1]
    assert hidden == whole.fw_off[L - 1] and torch.equal(wfw[:hidden], full[:hidden])
    last = unpack_forward_images(layout, wfw)[-1]
    assert torch.equal(last[: ws[-1].shape[0], :1], ws[-1][:, :1].to(torch.bfloat16).float())
    assert not last[:, 1:].any()
    assert bpk[layout.b_off[L - 1]] == bs[-1][0] and not bpk[layout.b_off[L - 1] + 1:].any()


@pytest.mark.parametrize("name", list(CHAINS))
def test_cut_chain_gives_the_whole_chains_sdf(name):
    gspec, k, skip, ws, bs, pos, table, mask = make(name)
    args = (gspec, k, 1.0, PE, "SoftplusQuad", 100.0, mask, skip)
    sdf, zs, x0 = sf._value_fwd_plain(pos, table, ws, bs, *args)
    csdf, czs, cx0 = sf._value_fwd_plain(pos, table, *sf.value_chain(ws, bs), *args)
    # the last product's f32 sum in another order (a matrix-vector product): 1e-6
    assert torch.equal(zs, czs) and torch.equal(x0, cx0)
    assert float((sdf - csdf).norm() / sdf.norm()) <= 1e-6
    assert torch.isfinite(sdf).all() and sdf.abs().max() > 0
    # the inactive levels enter the chain as zeros
    assert not x0[:, sf.value_d_in(gspec, PE) - (gspec.num_levels - k) * gspec.feats:].any()


@pytest.mark.parametrize("name", list(CHAINS))
def test_slot_params_match_the_grid_arguments(name):
    gspec, k, *_ = make(name)
    p = sf.slot_params(gspec, k, 1.0, PE)
    assert sf.slot_params(gspec, k, 1.0, PE) is p  # built once
    levels, feats, pk_shift, res, dense, ent_mask, row_off, radius, clip = sf._grid_args(
        gspec, k, 1.0)
    assert (p.levels, p.feats, p.pk_shift) == (levels, feats, pk_shift)
    assert list(p.res[:k]) == list(res) and list(p.dense[:k]) == list(dense)
    assert list(p.ent_mask[:k]) == list(ent_mask) and list(p.row_off[:k]) == list(row_off)
    assert p.radius == radius and np.float32(p.clip_hi) == np.float32(clip)
    assert p.smooth == 1 and p.pe_freqs == 6 and p.pw == 39
    assert list(p.pe_scale[:6]) == [float(v) for v in PE]


@pytest.mark.parametrize("name", list(CHAINS))
def test_outputs_are_the_residuals_the_backwards_read(name):
    gspec, k, skip, ws, bs, pos, table, mask = make(name)
    n = pos.shape[0]
    sdf, zs, x0 = sf.value_outputs(n, ws, gspec, PE, torch.device("cpu"), resid=True, x0=True)
    p_sdf, p_zs, p_x0 = sf._value_fwd_plain(pos, table, ws, bs, gspec, k, 1.0, PE,
                                            "SoftplusQuad", 100.0, mask, skip)
    assert sdf.dtype == torch.float32 and sdf.shape == p_sdf.shape
    assert zs.dtype == p_zs.dtype == torch.bfloat16 and zs.shape == p_zs.shape
    assert tuple(zs.shape) == (len(ws) - 1, n, 128)
    # x0 at the chain input's 16-column width
    d_in = sf.value_d_in(gspec, PE)
    assert x0.dtype == torch.bfloat16 and tuple(x0.shape) == (n, -(-d_in // 16) * 16)
    assert x0.shape[1] == fm.rup16(d_in) and p_x0.shape[1] == d_in
    none = sf.value_outputs(n, ws, gspec, PE, torch.device("cpu"))
    assert none[1] is None and none[2] is None


def test_wider_value_chain_is_refused_naming_the_bound():
    """K2's chain takes the widths JAX fuses (640 among them) and refuses a
    width JAX's can_fuse never sends to the fused kernels (576)."""
    gspec = BF16
    d_in = sf.value_d_in(gspec, PE)
    for width in (640, 576):
        ws = [torch.zeros(d_in, width), torch.zeros(width, width), torch.zeros(width, 257)]
        bs = [torch.zeros(width), torch.zeros(width), torch.zeros(257)]
        if width == 640:
            layout = fm.chain_of(d_in, sf.value_chain(ws, bs)[0], (), "SoftplusQuad", 100.0)[0]
            assert layout.hidden == 640 and layout.dout_pad[-1] == 16
            continue
        with pytest.raises(ValueError, match="hidden width 576.*multiples of 128"):
            fm.chain_of(d_in, sf.value_chain(ws, bs)[0], (), "SoftplusQuad", 100.0)
