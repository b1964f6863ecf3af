"""The port's native host sampler (data/native.py, csrc/mms_native.cpp)
against the JAX package's extension (native/mms_native.cpp, built by
tests/conftest.py): sample_pixels byte for byte over seeds, thread counts
1, 3 and 8, with and without a mosaick mask; the port's
UniformPixelSampler (sampler.THREADS threads) equal to JAX's on the same
dataset and seed on a one-core host, and the same batches whatever the
host's core count; and the sampling checks of tests/test_preprocessing.py's
TestNativeDataPath on the port. The library builds from the port's own
copy of the source into build/torch_native/ (a .gitignore'd directory),
and a failed build raises. Inputs are seeded numpy draws; every
comparison is exact."""

import numpy as np
import pytest
import torch

from multimodalstudio_tpu.data import native as jnative
from multimodalstudio_tpu.data.sampler import UniformPixelSampler as JSampler
from multimodalstudio_tpu.data.synthetic import make_synthetic_dataset as jmake_dataset

from multimodalstudio_tpu_torch.data import native, sampler
from multimodalstudio_tpu_torch.data.sampler import UniformPixelSampler
from multimodalstudio_tpu_torch.data.synthetic import make_synthetic_dataset

torch.set_num_threads(1)


def frames(seed, shape=(3, 11, 13, 4)):
    rng = np.random.default_rng(seed)
    return (rng.random(shape, dtype=np.float32),
            rng.integers(0, 4, size=shape[1:3]).astype(np.int8))


def test_the_library_builds_from_the_ports_source_into_an_ignored_directory():
    path = native.build()
    assert path.parent.name == "torch_native" and path.parent.parent.name == "build"
    assert native.SOURCE.parent.name == "csrc" and native.SOURCE.exists()
    assert path.exists() and jnative.available()


@pytest.mark.parametrize("threads", [1, 3, 8])
@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
def test_sample_pixels_is_the_extensions_bytes(threads, masked):
    for seed in (0, 7, 2**62 - 3):
        imgs, mask = frames(seed % 1000)
        m = mask if masked else None
        got = native.sample_pixels(imgs, m, 53, seed, 0.5, threads)
        ref = jnative.sample_pixels(imgs, m, 53, seed, 0.5, threads)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes(), (seed, threads, masked)


MODS = ("rgb", "polarization", "mono")
SCENE = dict(num_views=3, height=12, width=10, raw=True)


def test_uniform_pixel_sampler_is_jaxs(monkeypatch):
    """JAX's sampler draws on one thread a CPU core: on a one-core host its bytes are the
    port's, which draws on sampler.THREADS = 1 everywhere."""
    assert sampler.THREADS == 1
    monkeypatch.setattr(jnative.os, "cpu_count", lambda: 1)
    tds = make_synthetic_dataset(MODS, **SCENE, device="cpu")
    jds = jmake_dataset(MODS, **SCENE)
    t, j = UniformPixelSampler(tds, 37, seed=4), JSampler(jds, 37, seed=4)
    for _ in range(2):
        tb, jb = t.sample(), j.sample()
        for m in MODS:
            assert np.array_equal(tb[m].camera_indices.numpy(), np.asarray(jb[m].camera_indices))
            for f in ("pixel_coords", "pixels", "mosaick_channel"):
                assert np.array_equal(getattr(tb[m], f).numpy(), np.asarray(getattr(jb[m], f))), f


def test_a_seed_draws_the_same_batches_whatever_the_hosts_core_count(monkeypatch):
    """Every rank of a data-parallel run draws the global batch from the same seed: the
    draws may not depend on the host (the native draws at `threads` 0 do: one a core)."""
    tds = make_synthetic_dataset(MODS, **SCENE, device="cpu")
    runs = []
    for cores in (1, 6, 64):
        monkeypatch.setattr(native.os, "cpu_count", lambda: cores)
        s = UniformPixelSampler(tds, 37, seed=4)
        runs.append([s.sample() for _ in range(2)])
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            for m in MODS:
                for f in ("camera_indices", "pixel_coords", "pixels", "mosaick_channel"):
                    assert torch.equal(getattr(a[m], f), getattr(b[m], f)), (m, f)


def test_the_plain_version_is_taken_only_when_asked():
    imgs, mask = frames(1)
    plain = native.sample_pixels(imgs, mask, 64, 5, plain=True)
    rng = np.random.default_rng(5)
    assert np.array_equal(plain[0], rng.integers(0, 3, 64).astype(np.int32))
    assert not np.array_equal(native.sample_pixels(imgs, mask, 64, 5)[0], plain[0])


def test_a_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "mms_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed"):
        native.build()


# tests/test_preprocessing.py::TestNativeDataPath on the port


def test_native_library_built():
    assert native.load() is not None


def test_sample_pixels_matches_frames():
    imgs = np.random.default_rng(0).random((3, 16, 16, 4)).astype(np.float32)
    mask = np.tile(np.array([[0, 1], [3, 2]], np.int8), (8, 8))
    fi, co, px, ch = native.sample_pixels(imgs, mask, 64, seed=7)
    for i in range(64):
        y, x = int(co[i, 0] - 0.5), int(co[i, 1] - 0.5)
        np.testing.assert_allclose(px[i], imgs[fi[i], y, x])
        assert ch[i] == mask[y, x]

