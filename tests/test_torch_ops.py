"""The port's ray, encoding, camera, pose, polarization, sampler and metric
functions against the JAX package on the same numpy inputs.

All of these are float32 math on both sides; they differ by the order of
float32 operations and by the transcendental functions' last bits.
Tolerance: rel-L2 <= 1e-5 (1e-4 for the iterative undistortion and the
SSIM, whose sums run over many more terms).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodalstudio_tpu.cameras import camera_optimizer as jco
from multimodalstudio_tpu.cameras import cameras as jcam
from multimodalstudio_tpu.core import rays as jrays
from multimodalstudio_tpu.models import colliders as jcol
from multimodalstudio_tpu.models import samplers as jsmp
from multimodalstudio_tpu.ops import encodings as jenc
from multimodalstudio_tpu.ops import lie_groups as jlie
from multimodalstudio_tpu.ops import math as jmath
from multimodalstudio_tpu.ops import polarization as jpol
from multimodalstudio_tpu_torch.cameras import camera_optimizer as tco
from multimodalstudio_tpu_torch.cameras import cameras as tcam
from multimodalstudio_tpu_torch.core import rays as trays
from multimodalstudio_tpu_torch.models import colliders as tcol
from multimodalstudio_tpu_torch.models import samplers as tsmp
from multimodalstudio_tpu_torch.ops import encodings as tenc
from multimodalstudio_tpu_torch.ops import lie_groups as tlie
from multimodalstudio_tpu_torch.ops import math as tmath
from multimodalstudio_tpu_torch.ops import polarization as tpol

torch.set_num_threads(1)

F32 = 1e-5


def rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def T(a):
    return torch.tensor(np.asarray(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def unit(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_alphas_and_weights():
    rng = np.random.default_rng(0)
    deltas = rng.uniform(0.0, 0.2, size=(17, 9)).astype(np.float32)
    dens = rng.uniform(0.0, 20.0, size=(17, 9)).astype(np.float32)
    ja = jrays.alphas_from_densities(J(deltas), J(dens))
    ta = trays.alphas_from_densities(T(deltas), T(dens))
    assert rel_l2(ta, ja) <= F32
    assert rel_l2(trays.weights_from_alphas(ta), jrays.weights_from_alphas(ja)) <= F32


@pytest.mark.parametrize("include_input", [True, False])
def test_nerf_encoding(include_input):
    x = np.random.default_rng(1).uniform(-2, 2, size=(31, 3)).astype(np.float32)
    j = jenc.nerf_encoding(J(x), 6, 0.0, 5.0, include_input)
    t = tenc.nerf_encoding(T(x), 6, 0.0, 5.0, include_input)
    assert t.shape == j.shape and rel_l2(t, j) <= F32


def test_sh_encodings():
    d = unit(np.random.default_rng(2), 41)
    assert rel_l2(tenc.sh_encoding(T(d), 4), jenc.sh_encoding(J(d), 4)) <= F32
    assert rel_l2(tenc.sh_encoding_dense(T(d), 4), jenc.sh_encoding_dense(J(d), 4)) <= F32


@pytest.mark.parametrize("order", [None, float("inf")])
def test_scene_contraction(order):
    x = np.random.default_rng(3).uniform(-3, 3, size=(64, 3)).astype(np.float32)
    assert rel_l2(tmath.scene_contraction(T(x), order), jmath.scene_contraction(J(x), order)) <= F32


@pytest.mark.parametrize("name", ["exp_map_SO3xR3", "exp_map_SE3"])
def test_lie_exp(name):
    rng = np.random.default_rng(4)
    # include tangents below the small-angle switches
    tan = np.concatenate([rng.normal(size=(16, 6)), 1e-3 * rng.normal(size=(4, 6))]).astype(np.float32)
    assert rel_l2(getattr(tlie, name)(T(tan)), getattr(jlie, name)(J(tan))) <= F32


@pytest.mark.parametrize("shared", [True, False])
def test_tangent_transform(shared):
    rng = np.random.default_rng(5)
    tan = (0.1 * rng.normal(size=(1 if shared else 4, 6))).astype(np.float32)
    idx = rng.integers(0, 4, size=9)
    kw = dict(mode="SO3xR3", shared_optimization=shared)
    j = jco.tangent_transform(jco.CameraOptimizerSpec(**kw), J(tan), J(idx))
    t = tco.tangent_transform(tco.CameraOptimizerSpec(**kw), T(tan), T(idx))
    assert rel_l2(t, j) <= F32


def _cameras(mod, distortion, rng):
    n = 3
    c2w = np.concatenate(
        [np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(n)]),
         rng.normal(size=(n, 3, 1))], axis=-1).astype(np.float32)
    dist = (0.01 * rng.normal(size=(n, 6))).astype(np.float32) if distortion else None
    vals = dict(fx=np.full(n, 40.0, np.float32), fy=np.full(n, 42.0, np.float32),
                cx=np.full(n, 16.0, np.float32), cy=np.full(n, 15.0, np.float32),
                camera_to_worlds=c2w, distortion_params=dist)
    conv = J if mod is jcam else T
    return mod.Cameras(**{k: None if v is None else conv(v) for k, v in vals.items()},
                       width=32, height=30)


@pytest.mark.parametrize("distortion", [False, True])
def test_generate_rays(distortion):
    rng = np.random.default_rng(6)
    jc = _cameras(jcam, distortion, np.random.default_rng(7))
    tc = _cameras(tcam, distortion, np.random.default_rng(7))
    idx = rng.integers(0, 3, size=50)
    coords = rng.uniform(0, 30, size=(50, 2)).astype(np.float32)
    opt = jlie.exp_map_SO3xR3(J((0.05 * rng.normal(size=(50, 6))).astype(np.float32)))
    jr = jcam.generate_rays(jc, J(idx.astype(np.int32)), J(coords), opt)
    tr = tcam.generate_rays(tc, T(idx), T(coords), T(opt))
    tol = 1e-4 if distortion else F32
    for name in ("origins", "directions", "up_directions", "pixel_area", "directions_norm"):
        assert rel_l2(getattr(tr, name), getattr(jr, name)) <= tol, name


def test_sphere_collider_and_background_bounds():
    rng = np.random.default_rng(8)
    o = rng.normal(size=(40, 3)).astype(np.float32) * 2
    d = unit(rng, 40)
    z = np.zeros((40, 1), np.float32)
    kw = dict(pixel_area=z, directions_norm=z, camera_indices=np.zeros(40, np.int32))
    jb = jrays.RayBundle(origins=J(o), directions=J(d), up_directions=J(d),
                         **{k: J(v) for k, v in kw.items()})
    tb = trays.RayBundle(origins=T(o), directions=T(d), up_directions=T(d),
                         **{k: T(v) for k, v in kw.items()})
    jr, jm = jcol.sphere_collide(jb, 1.0)
    tr, tm = tcol.sphere_collide(tb, 1.0)
    assert rel_l2(tm, jm) == 0.0
    assert rel_l2(tr.nears, jr.nears) <= F32 and rel_l2(tr.fars, jr.fars) <= F32
    jbg = jcol.background_bounds(jb, jm, 1.0)
    tbg = tcol.background_bounds(tb, tm, 1.0)
    assert rel_l2(tbg.nears, jbg.nears) <= F32 and rel_l2(tbg.fars, jbg.fars) <= F32


def test_sampler_pieces():
    rng = np.random.default_rng(9)
    a = np.sort(rng.uniform(size=(12, 9)), -1).astype(np.float32)
    b = np.sort(rng.uniform(size=(12, 4)), -1).astype(np.float32)
    b[:, 0] = a[:, 2]  # a tie: a's entry goes first
    b = np.sort(b, -1)  # both inputs must stay ascending
    va, vb = rng.normal(size=a.shape).astype(np.float32), rng.normal(size=b.shape).astype(np.float32)
    jm, jv = jsmp.merge_sorted(J(a), J(b), (J(va), J(vb)))
    tm, tv = tsmp.merge_sorted(T(a), T(b), (T(va), T(vb)))
    assert np.array_equal(tm.numpy(), np.asarray(jm)) and np.array_equal(tv.numpy(), np.asarray(jv))
    bins = np.concatenate([np.zeros((12, 1)), np.sort(rng.uniform(size=(12, 8)), -1),
                           np.ones((12, 1))], -1).astype(np.float32)
    w = rng.uniform(size=(12, 9)).astype(np.float32)
    j = jsmp.pdf_sample_bins(J(bins), J(w), 8, None, False, histogram_padding=1e-5)
    t = tsmp.pdf_sample_bins(T(bins), T(w), 8, histogram_padding=1e-5)
    assert rel_l2(t, j) <= F32
    sdf = rng.normal(size=(12, 10)).astype(np.float32)
    euclid = np.cumsum(rng.uniform(0.01, 0.2, size=(12, 11)), -1).astype(np.float32)
    j = jsmp.rendering_sdf_with_fixed_inv_s(J(euclid), J(sdf), 64.0)
    t = tsmp.rendering_sdf_with_fixed_inv_s(T(euclid), T(sdf), 64.0)
    assert rel_l2(t, j) <= F32


def test_polarization():
    rng = np.random.default_rng(10)
    stokes = rng.uniform(0.1, 1.0, size=(33, 3)).astype(np.float32)
    d, up = unit(rng, 33), unit(rng, 33)
    ja = jpol.align_polarization_filters(J(stokes), J(d), J(up))
    ta = tpol.align_polarization_filters(T(stokes), T(d), T(up))
    assert rel_l2(ta, ja) <= F32
    for tv, jv in zip(tpol.stokes_to_intensity(ta), jpol.stokes_to_intensity(ja)):
        assert rel_l2(tv, jv) <= F32
    data = rng.uniform(0.05, 1.0, size=(5, 7, 4)).astype(np.float32)
    assert rel_l2(tpol.to_dop(data=T(data)), jpol.to_dop(data=J(data))) <= F32
    assert rel_l2(tpol.to_aop(data=T(data)), jpol.to_aop(data=J(data))) <= F32


def test_psnr_and_ssim():
    rng = np.random.default_rng(11)
    gt = rng.uniform(size=(24, 20, 3)).astype(np.float32)
    pred = np.clip(gt + 0.05 * rng.normal(size=gt.shape), 0, 1).astype(np.float32)
    mask = (rng.uniform(size=(24, 20, 1)) > 0.3).astype(np.float32)
    assert rel_l2(tmath.psnr(T(pred), T(gt)), jmath.psnr(J(pred), J(gt))) <= F32
    assert rel_l2(tmath.psnr(T(pred), T(gt), T(mask)), jmath.psnr(J(pred), J(gt), J(mask))) <= F32
    assert rel_l2(tmath.ssim(T(pred), T(gt)), jmath.ssim(J(pred), J(gt))) <= 1e-4
    assert rel_l2(tmath.masked_ssim(T(pred), T(gt), T(mask)),
                  jmath.masked_ssim(J(pred), J(gt), J(mask))) <= 1e-4
