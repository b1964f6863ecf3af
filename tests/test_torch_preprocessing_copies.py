"""The port's copies of the JAX package's jax-free preprocessing modules
(preprocessing/colmap.py, preprocessing/metadata.py) and of the helpers no
config reaches (the four schedule specs, ops/distortion.py::distort,
ops/polarization.py::mueller_linear_polarizer, Cameras.rescaled), each
against the JAX package's on the same inputs.

COLMAP's text model (cameras.txt, images.txt, points3D.txt) is built here
from the synthetic scene's cameras and sphere, so no colmap binary runs.
The parsers, qvec_to_rotmat, w2c_to_c2w, cluster_points,
generate_bounding_box, process_camera_matrix, adjust_frame and
build_metadata must agree exactly (the same numpy and OpenCV calls); the
two meta_data.json files must be equal, and both packages' load_dataset
must read the port's the same. The helpers: float32 JAX against the port
within rel 1e-6 (the schedules, computed in float64 by the port, within
1e-6 absolute of factors of order 1), and distort's round trip through
radial_and_tangential_undistort within 1e-5.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import multimodalstudio_tpu.cameras.cameras as jcameras
import multimodalstudio_tpu.engine.schedules as jsched
import multimodalstudio_tpu.ops.distortion as jdist
import multimodalstudio_tpu.ops.polarization as jpol
import multimodalstudio_tpu.preprocessing.colmap as jcolmap
import multimodalstudio_tpu.preprocessing.metadata as jmeta
from multimodalstudio_tpu.data.synthetic import make_synthetic_dataset as jmake_dataset

import multimodalstudio_tpu_torch.engine.schedules as tsched
import multimodalstudio_tpu_torch.ops.distortion as tdist
import multimodalstudio_tpu_torch.ops.polarization as tpol
import multimodalstudio_tpu_torch.preprocessing.colmap as tcolmap
import multimodalstudio_tpu_torch.preprocessing.metadata as tmeta
from multimodalstudio_tpu_torch.data.dataset import load_dataset as tload
from multimodalstudio_tpu_torch.data.synthetic import make_synthetic_dataset as tmake_dataset
from multimodalstudio_tpu_torch.utils.images import to16, write_png16

from test_torch_disk_dataset import assert_same_dataset

torch.set_num_threads(1)

MODS = ("rgb", "mono")
RUB2RDF = np.diag([1.0, -1.0, -1.0])


def rotmat_to_qvec(r):
    """COLMAP's (w, x, y, z) of a rotation matrix (trace form; the test's
    rotations keep w away from 0)."""
    w = np.sqrt(max(1.0 + np.trace(r), 1e-12)) / 2.0
    return np.array([w, (r[2, 1] - r[1, 2]) / (4 * w), (r[0, 2] - r[2, 0]) / (4 * w),
                     (r[1, 0] - r[0, 1]) / (4 * w)])


def write_text_model(root, camera_lines, images, points):
    """COLMAP's text model in `root`: cameras.txt of `camera_lines`,
    images.txt of `images`, (name, camera id, c2w) in OpenGL axes, their
    world-to-camera poses in COLMAP's, every second image given one 2D
    point, and points3D.txt of `points`."""
    with open(root / "cameras.txt", "w") as f:
        f.write("# Camera list\n")
        f.writelines(line + "\n" for line in camera_lines)
    lines = ["# Image list", "#   POINTS2D[] as (X, Y, POINT3D_ID)"]
    for image_id, (name, camera_id, c2w) in enumerate(images, start=1):
        r_c2w = c2w[:3, :3] @ RUB2RDF
        r = r_c2w.T
        t = -r @ c2w[:3, 3]
        q = rotmat_to_qvec(r)
        lines.append(f"{image_id} {' '.join(f'{v:.12g}' for v in q)} "
                     f"{' '.join(f'{v:.12g}' for v in t)} {camera_id} {name}")
        lines.append("1.0 2.0 -1" if image_id % 2 == 0 else "")
    (root / "images.txt").write_text("\n".join(lines) + "\n")
    with open(root / "points3D.txt", "w") as f:
        f.write("# 3D point list\n")
        for i, p in enumerate(points):
            f.write(f"{i + 1} {p[0]:.9g} {p[1]:.9g} {p[2]:.9g} 128 128 128 0.5 1 2\n")


def sphere_and_far_cluster():
    """Points on a sphere of radius 0.5 and a far cluster."""
    rng = np.random.default_rng(0)
    sphere = rng.normal(size=(400, 3))
    sphere = 0.5 * sphere / np.linalg.norm(sphere, axis=-1, keepdims=True)
    far = rng.normal(size=(150, 3)) * 0.05 + np.array([6.0, 0.0, 0.0])
    return np.concatenate([sphere, far])


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """COLMAP's text model of the synthetic scene: one camera per modality
    (OPENCV with distortion, PINHOLE), one image per (modality, view)
    named <view>.png, and points on the sphere plus a far cluster."""
    root = tmp_path_factory.mktemp("colmap")
    ds = jmake_dataset(MODS, num_views=6, height=16, width=20, raw=True)
    images = []
    for ci, mod in enumerate(MODS):
        c2ws = np.asarray(ds.data[mod].cameras.camera_to_worlds, np.float64)
        for vid, c2w in zip(ds.data[mod].frame_ids, c2ws):
            name = f"{mod}\\{int(vid):04d}.png" if ci else f"{int(vid):04d}.png"
            images.append((name, ci + 1, c2w))
    write_text_model(root, ["1 OPENCV 20 16 24.0 24.0 10.0 8.0 0.01 -0.002 0.001 0.0005",
                            "2 PINHOLE 20 16 24.0 24.0 10.0 8.0"],
                     images, sphere_and_far_cluster())
    return root, ds


def test_colmap_parsers_match_jax(model_dir):
    root, _ = model_dir
    jc, tc = (m.parse_cameras_txt(str(root / "cameras.txt")) for m in (jcolmap, tcolmap))
    assert jc.keys() == tc.keys()
    for k in jc:
        assert {a: b for a, b in jc[k].items() if a != "params"} == \
            {a: b for a, b in tc[k].items() if a != "params"}
        assert np.array_equal(jc[k]["params"], tc[k]["params"])
    ji, ti = (m.parse_images_txt(str(root / "images.txt")) for m in (jcolmap, tcolmap))
    assert ji.keys() == ti.keys() and len(ji) == 12
    for k in ji:
        assert ji[k]["camera_id"] == ti[k]["camera_id"]
        for f in ("qvec", "tvec"):
            assert np.array_equal(ji[k][f], ti[k][f])
        assert np.array_equal(jcolmap.qvec_to_rotmat(ji[k]["qvec"]),
                              tcolmap.qvec_to_rotmat(ti[k]["qvec"]))
        assert np.array_equal(jcolmap.w2c_to_c2w(ji[k]["qvec"], ji[k]["tvec"]),
                              tcolmap.w2c_to_c2w(ti[k]["qvec"], ti[k]["tvec"]))
    assert np.array_equal(jcolmap.parse_points3d_txt(str(root / "points3D.txt")),
                          tcolmap.parse_points3d_txt(str(root / "points3D.txt")))


def checkerboard_scene():
    """A central ball and two tilted planar boards outside the unit
    half-cube, the scene the MMS-DATA reorientation expects
    (tests/test_preprocessing.py's)."""
    rng = np.random.default_rng(2)
    c, s = np.cos(0.4), np.sin(0.4)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    board = np.stack([rng.uniform(-0.3, 0.3, 400), rng.uniform(-0.3, 0.3, 400),
                      np.full(400, -0.75)], axis=-1) @ rot.T
    return np.concatenate([rng.normal(size=(600, 3)) * 0.2, board, board + [0.05, 0.05, 0.0]])


@pytest.mark.parametrize("kw", [{}, {"pointcloud_filtering": True, "scale": 1.5},
                                {"reorient_axis": True}])
def test_bounding_box_and_clusters_match_jax(model_dir, tmp_path, kw):
    root, _ = model_dir
    pts = jcolmap.parse_points3d_txt(str(root / "points3D.txt"))
    if kw.get("reorient_axis"):
        pts = checkerboard_scene()
    jc = jmeta.cluster_points(pts, 0.5)
    tc = tmeta.cluster_points(pts, 0.5)
    assert [c.tolist() for c in jc] == [c.tolist() for c in tc]
    jout, tout = tmp_path / "j", tmp_path / "t"
    jout.mkdir()
    tout.mkdir()
    jg, jb = jmeta.generate_bounding_box(pts, radius=0.5, output_path=str(jout), **kw)
    tg, tb = tmeta.generate_bounding_box(pts, radius=0.5, output_path=str(tout), **kw)
    assert np.array_equal(jg, tg) and jb == tb
    assert (jout / "pointcloud.ply").read_text() == (tout / "pointcloud.ply").read_text()


def modality_data():
    k = np.array([[24.0, 0.0, 10.0], [0.0, 24.0, 8.0], [0.0, 0.0, 1.0]])
    return {mod: {"original_camera_matrix": k.copy(), "original_roi": (1, 2, 18, 13),
                  "dist_coeffs": np.array([0.01, -0.002, 0.001, 0.0005, 0.0, 0.0, 0.0, 0.0])}
            for mod in MODS}


@pytest.mark.parametrize("undistort,scale", [(False, 1.0), (True, 1.0), (True, 0.5)])
def test_camera_matrices_and_frames_match_jax(undistort, scale):
    jd = jmeta.process_camera_matrix(modality_data(), undistort=undistort, scale=scale)
    td = tmeta.process_camera_matrix(modality_data(), undistort=undistort, scale=scale)
    for mod in MODS:
        assert jd[mod].keys() == td[mod].keys()
        for key, v in jd[mod].items():
            assert np.array_equal(np.asarray(v), np.asarray(td[mod][key])), (mod, key)
    frame = (np.random.default_rng(1).uniform(size=(16, 20, 3)) * 65535).astype(np.uint16)
    for mod in MODS:
        a = jmeta.adjust_frame(frame, jd[mod], undistort=undistort, scale=scale)
        b = tmeta.adjust_frame(frame, td[mod], undistort=undistort, scale=scale)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("undistorted,mosaicked", [(True, True), (False, False)])
def test_build_metadata_matches_jax_and_loads(model_dir, tmp_path, undistorted, mosaicked):
    root, ds = model_dir
    data = modality_data()
    for d in data.values():
        d["current_camera_matrix"] = d["original_camera_matrix"]
        d["current_roi"] = (0, 0, 20, 16)
    gt2w = np.diag([0.5, 0.5, 0.5, 1.0])
    gt2w[:3, 3] = [0.1, -0.2, 0.05]
    patterns = {"rgb": [[1, 2], [0, 1]], "mono": [[0]]}
    calibration = {"mono": {"camera2reference": np.eye(4).tolist()}} if not undistorted else None
    kw = dict(images_txt=str(root / "images.txt"), modalities=MODS, gt2world=gt2w,
              bbox=[[-0.5, -0.5, -0.5], [0.5, 0.5, 0.5]], scale=1.0, undistorted=undistorted,
              mosaicked=mosaicked, mosaick_patterns=patterns, calibration=calibration)
    jpath = jmeta.build_metadata(str(tmp_path / "j"), modality_data=data, **kw)
    tpath = tmeta.build_metadata(str(tmp_path / "t"), modality_data=data, **kw)
    with open(jpath) as f:
        jtext = f.read()
    with open(tpath) as f:
        assert f.read() == jtext
    meta = json.loads(jtext)
    # frames for every view the metadata lists, then both packages' loaders on it
    tds = tmake_dataset(MODS, num_views=6, height=16, width=20, raw=mosaicked, device="cpu")
    for mod in MODS:
        os.makedirs(tmp_path / "t" / "modalities" / mod, exist_ok=True)
        for fr in meta["modalities"][mod]["frames"]:
            img = to16(tds.data[mod].images[fr["frame_id"]])
            write_png16(str(tmp_path / "t" / "modalities" / mod / fr["file_name"]), img)
    idx = {m: [fr["frame_id"] for fr in meta["modalities"][m]["frames"]] for m in MODS}
    assert all(idx.values())
    from multimodalstudio_tpu.data.dataset import load_dataset as jload

    j = jload(str(tmp_path / "t"), MODS, idx, raw=mosaicked)
    t = tload(str(tmp_path / "t"), MODS, idx, raw=mosaicked, device="cpu")
    assert_same_dataset(j, t)
    assert t.data["rgb"].cameras.pixel_offset == 0.0
    assert (t.data["rgb"].cameras.distortion_params is None) == undistorted


# ------------------------------------------------------------ the helpers

SCHEDULES = [
    ("ExponentialDecaySpec", dict(lr_final_ratio=0.05)),
    ("ExponentialDecaySpec", dict(lr_final_ratio=0.1, lr_delay_steps_ratio=0.1,
                                  lr_delay_mult=0.01)),
    ("NeuSSchedulerSpec", dict(warm_up_ratio=0.1, learning_rate_alpha=0.05)),
    ("CosineRaiseSpec", dict(saturation_ratio=0.3, learning_rate_alpha=0.1)),
    ("MaskedSchedulerSpec", dict(mask_ratio=0.4)),
    ("MaskedSchedulerSpec", dict(mask_ratio=0.2, inner="NeuSSchedulerSpec")),
]


@pytest.mark.parametrize("name,kw", SCHEDULES)
def test_schedule_specs_match_jax(name, kw):
    def build(mod):
        args = dict(kw)
        if isinstance(args.get("inner"), str):
            args["inner"] = getattr(mod, args["inner"])()
        return getattr(mod, name)(**args)

    jspec, tspec = build(jsched), build(tsched)
    max_iters = 1000
    for step in list(range(0, 1001, 7)) + [99, 100, 101, 199, 200, 299, 300, 399, 400]:
        ref = float(jspec.factor(jnp.asarray(step), max_iters))
        got = tspec.factor(step, max_iters)
        assert abs(got - ref) <= 1e-6, (step, got, ref)


def test_distort_matches_jax_and_round_trips():
    rng = np.random.default_rng(2)
    coords = rng.uniform(-0.6, 0.6, size=(64, 2)).astype(np.float32)
    params = np.array([0.05, -0.01, 0.002, 0.0005, 0.001, -0.002], np.float32)
    ref = np.asarray(jdist.distort(jnp.asarray(coords), jnp.asarray(params)))
    got = tdist.distort(torch.from_numpy(coords), torch.from_numpy(params))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)
    back = tdist.radial_and_tangential_undistort(got, torch.from_numpy(params))
    np.testing.assert_allclose(back.numpy(), coords, atol=1e-5)


def test_mueller_linear_polarizer_matches_jax():
    theta = np.random.default_rng(3).uniform(-np.pi, np.pi, size=(5, 7)).astype(np.float32)
    ref = np.asarray(jpol.mueller_linear_polarizer(jnp.asarray(theta)))
    got = tpol.mueller_linear_polarizer(torch.from_numpy(theta))
    assert tuple(got.shape) == ref.shape == (5, 7, 3, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_cameras_rescaled_matches_jax():
    jds = jmake_dataset(("rgb",), num_views=3, height=17, width=23)
    tds = tmake_dataset(("rgb",), num_views=3, height=17, width=23, device="cpu")
    jc = jds.data["rgb"].cameras.rescaled(0.3)
    tc = tds.data["rgb"].cameras.rescaled(0.3)
    for f in dataclasses.fields(tc):
        a, b = getattr(tc, f.name), getattr(jc, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        else:
            assert a == b, f.name
    assert (tc.width, tc.height) == (6, 5)
    assert jcameras.PERSPECTIVE == tc.camera_type
