"""The port's LPIPS (utils/lpips.py) against the JAX package's
(utils/lpips_jax.py): the random-init fallback equal to JAX's _rand_params
bit for bit; lpips within rel 1e-5 of JAX's on seeded 2 x 64 x 64 x 3
inputs, with the fallback weights and with a file in the vendored format
(HWIO kernels, as scripts/vendor_lpips_weights.py writes it) loaded by
both; and the six properties of tests/test_lpips.py on the port, on the
CPU (float32 on both sides)."""

import numpy as np
import pytest
import torch

from multimodalstudio_tpu.utils import lpips_jax

from multimodalstudio_tpu_torch.utils import lpips as tl

torch.set_num_threads(1)

REL = 1e-5


def lp(x0, x1, params=None):
    return tl.lpips(x0, x1, params, device="cpu").numpy()


@pytest.fixture(scope="module")
def imgs():
    return np.random.RandomState(3).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(11)
    x0 = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    x1 = np.clip(x0 + 0.3 * rng.normal(size=x0.shape), -1, 1).astype(np.float32)
    return x0, x1


def test_fallback_parameters_are_jaxs_bit_for_bit():
    ref, got = lpips_jax._rand_params(), tl.rand_params()
    assert set(got) == set(ref) and got["source"] == ref["source"] == "randinit"
    for k in ref:
        if k != "source":
            assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k


def test_lpips_matches_jax_with_the_fallback(pair):
    params = tl.rand_params()
    ref = np.asarray(lpips_jax.lpips(*pair, params=lpips_jax._rand_params()))
    got = lp(*pair, params)
    assert got.shape == ref.shape == (2,)
    assert np.all(np.abs(got - ref) <= REL * np.abs(ref)), (got, ref)


def test_lpips_matches_jax_on_a_vendored_weights_file(pair, tmp_path):
    """A weights file in the vendored layout, written with seeded numpy
    draws (mixed-sign heads: the metric clips them at 0), read by each
    package's loader."""
    rng = np.random.default_rng(5)
    arrays, c_in = {}, 3
    for i, (c_out, k, _, _) in enumerate(tl.ALEX):
        arrays[f"conv{i}_w"] = (rng.normal(size=(k, k, c_in, c_out))
                                * np.sqrt(2.0 / (c_in * k * k))).astype(np.float32)
        arrays[f"conv{i}_b"] = (0.05 * rng.normal(size=c_out)).astype(np.float32)
        arrays[f"lin{i}_w"] = rng.normal(size=c_out).astype(np.float32) / c_out
        c_in = c_out
    path = tmp_path / "lpips_weights.npz"
    np.savez(path, **arrays)
    params = tl.load_params(str(path))
    assert tl.weight_source(str(path)) == params["source"] == "trained"
    with np.load(path) as z:
        jparams = {k: z[k] for k in z.files}
    ref = np.asarray(lpips_jax.lpips(*pair, params=jparams))
    got = lp(*pair, params)
    assert np.all(np.abs(got - ref) <= REL * np.abs(ref)), (got, ref)


# tests/test_lpips.py's properties on the port


def test_identity_is_zero(imgs):
    d = lp(imgs, imgs)
    assert d.shape == (2,)
    np.testing.assert_allclose(d, 0.0, atol=1e-6)


def test_orders_perturbation_strength(imgs):
    noise = np.random.RandomState(0).standard_normal(imgs.shape).astype(np.float32)
    d_small = lp(imgs, np.clip(imgs + 0.05 * noise, -1, 1))
    d_large = lp(imgs, np.clip(imgs + 0.5 * noise, -1, 1))
    assert np.all(d_small > 0) and np.all(d_large > d_small)


def test_deterministic_across_loads(imgs):
    a, b = tl.rand_params(0), tl.rand_params(0)
    for i in range(len(tl.ALEX)):
        np.testing.assert_array_equal(a[f"conv{i}_w"], b[f"conv{i}_w"])
    np.testing.assert_array_equal(lp(imgs[:1], -imgs[:1]), lp(imgs[:1], -imgs[:1]))


def test_weight_source_reported():
    assert tl.weight_source() in ("trained", "randinit")
    assert tl.load_params()["source"] == tl.weight_source()


def test_single_image_rank_promotes(imgs):
    assert lp(imgs[0], imgs[1]).shape == (1,)


def test_blur_cheaper_than_noise():
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32) / 63.0
    x = np.stack([np.sin(8 * xx) * yy, np.cos(6 * yy) * xx, (xx - yy) ** 2],
                 axis=-1)[None].astype(np.float32)
    blurred = (x + np.roll(x, 1, axis=1) + np.roll(x, -1, axis=1) + np.roll(x, 1, axis=2)
               + np.roll(x, -1, axis=2)) / 5.0
    l2_blur = float(np.mean((blurred - x) ** 2))
    noise = np.random.RandomState(1).standard_normal(x.shape).astype(np.float32)
    noise *= np.sqrt(l2_blur / np.mean(noise**2))
    assert float(lp(x, x + noise)[0]) > float(lp(x, blurred)[0])


def test_the_card_is_the_default(monkeypatch, imgs):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.lpips(imgs, imgs)
