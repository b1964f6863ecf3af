"""The port's capture preprocessing scripts
(multimodalstudio_tpu_torch/scripts/preprocess_custom_dataset.py and
preprocess_mmsdata.py) against the JAX repo's (scripts/*.py) on one small
capture: 16-bit raw frames modalities/<mod>/<n>.png of the synthetic scene,
a few views at 18 x 24 (the 2 x 2 and 3 x 3 mosaics tile it).

No colmap binary runs: in both packages colmap_available returns True and
run_sfm_pipeline writes COLMAP's text model of the synthetic cameras for
the SfM images it is given (named as COLMAP names them, "<mod>/<name>",
or "<name>" under a calibration), with a sphere and a far cluster, or two
checkerboard planes for the MMS-DATA reorientation. Each case must give
the same output tree byte for byte: meta_data.json, the frames (PNG or
.npy), the SfM images, pointcloud.ply and camera_poses.ply. The port's
load_dataset then reads the port's scene on the CPU.
"""

import json
import sys

import numpy as np
import pytest
import torch

import cv2

import multimodalstudio_tpu.preprocessing.colmap as jcolmap
import scripts.preprocess_custom_dataset as jcustom
import scripts.preprocess_mmsdata as jmms

import multimodalstudio_tpu_torch.preprocessing.colmap as tcolmap
import multimodalstudio_tpu_torch.scripts.preprocess_custom_dataset as tcustom
import multimodalstudio_tpu_torch.scripts.preprocess_mmsdata as tmms
from multimodalstudio_tpu_torch.data.dataset import load_dataset
from multimodalstudio_tpu_torch.data.synthetic import make_synthetic_dataset
from multimodalstudio_tpu_torch.utils.images import to16

from test_torch_preprocessing_copies import (
    checkerboard_scene,
    sphere_and_far_cluster,
    write_text_model,
)

torch.set_num_threads(1)

FIVE = ("rgb", "infrared", "mono", "polarization", "multispectral")
VIEWS, H, W = 4, 18, 24


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """The raw capture of the five modalities, their cameras (c2w by view)
    and a calibration JSON chaining each modality to rgb."""
    root = tmp_path_factory.mktemp("capture")
    ds = make_synthetic_dataset(FIVE, num_views=VIEWS, height=H, width=W, raw=True, device="cpu")
    c2ws = {}
    calibration = {}
    for i, mod in enumerate(FIVE):
        (root / "modalities" / mod).mkdir(parents=True)
        for vid, img in zip(ds.data[mod].frame_ids, ds.data[mod].images):
            cv2.imwrite(str(root / "modalities" / mod / f"{int(vid)}.png"), to16(img[..., 0]))
        c2ws[mod] = np.asarray(ds.data[mod].cameras.camera_to_worlds, np.float64)
        c2r = np.eye(4)
        c2r[:3, 3] = [0.01 * i, -0.005 * i, 0.002 * i]
        calibration[mod] = {
            "camera_matrix": [[28.0 + i, 0.0, 12.0], [0.0, 28.0 + i, 9.0], [0.0, 0.0, 1.0]],
            "dist_coeffs": [0.01 * (i + 1), -0.002, 0.001, 0.0005, 0.0, 0.0, 0.0, 0.0],
            "width": W, "height": H, "camera2reference": c2r.tolist(),
        }
    (root / "calibration.json").write_text(json.dumps(calibration))
    return root, c2ws


def fake_sfm(c2ws, points):
    """run_sfm_pipeline writing the text model of the SfM images under
    image_path: a subdirectory per modality (camera i + 1 for the i-th of
    FIVE present) or, under a calibration, the reference's images alone
    (camera 1, rgb's poses)."""
    def run_sfm_pipeline(work_dir, image_path, camera_model="OPENCV"):
        from pathlib import Path

        base = Path(image_path)
        mods = sorted((p.name for p in base.iterdir() if p.is_dir()), key=FIVE.index)
        images, lines = [], []
        for ci, mod in enumerate(mods or ["rgb"]):
            d = base / mod if mods else base
            lines.append(f"{ci + 1} OPENCV {W} {H} {30.0 + ci} {30.0 + ci} 12.0 9.0 "
                         f"{0.01 * (ci + 1)} -0.002 0.001 0.0005" if ci == 0 else
                         f"{ci + 1} PINHOLE {W} {H} {30.0 + ci} {30.0 + ci} 12.0 9.0")
            for f in sorted(d.iterdir()):
                name = f"{mod}/{f.name}" if mods else f.name
                images.append((name, ci + 1, c2ws[mod][int(f.stem)]))
        txt = Path(work_dir) / "sparse_txt"
        txt.mkdir(parents=True, exist_ok=True)
        write_text_model(txt, lines, images, points)
        return str(txt)

    return run_sfm_pipeline


def tree(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


CASES = {
    "rgb and mono, defaults": (["--modalities", "rgb", "mono"], None, False),
    "five modalities, mosaicked, undistorted, half scale, calibrated": (
        ["--modalities", *FIVE, "--mosaicked", "--undistort", "--scale", "0.5",
         "--calibration", "{calibration}"], None, False),
    "rgb and mono, ArUco scale 0.5": (["--modalities", "rgb", "mono"], 0.5, False),
    "MMS-DATA, two checkerboards": (["--calibration", "{calibration}"], None, True),
    "MMS-DATA, two checkerboards, mosaicked, undistorted": (
        ["--calibration", "{calibration}", "--mosaicked", "--undistort"], None, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scripts_write_the_same_scene(capture, tmp_path, monkeypatch, case):
    root, c2ws = capture
    args, aruco, mms = CASES[case]
    points = checkerboard_scene() if mms else sphere_and_far_cluster()
    for mod in (jcolmap, tcolmap):
        monkeypatch.setattr(mod, "colmap_available", lambda: True)
        monkeypatch.setattr(mod, "run_sfm_pipeline", fake_sfm(c2ws, points))
        if aruco is not None:
            monkeypatch.setattr(mod, "compute_aruco_scale", lambda *a, **k: aruco)
    outs = {}
    for which in ("jax", "port"):
        out = tmp_path / which
        argv = ["--input", str(root), "--output", str(out)] + [
            a.format(calibration=root / "calibration.json") for a in args]
        if which == "jax":
            monkeypatch.setattr(sys, "argv", ["preprocess"] + argv)
            (jmms if mms else jcustom).main()
        else:
            (tmms if mms else tcustom).main(argv)
        outs[which] = out
    jtree, ttree = tree(outs["jax"]), tree(outs["port"])
    assert sorted(jtree) == sorted(ttree)
    for name in jtree:
        assert jtree[name] == ttree[name], name
    names = set(ttree)
    assert {"meta_data.json", "pointcloud.ply", "camera_poses.ply"} <= names
    assert any(n.startswith("colmap/images/") for n in names)

    meta = json.loads(ttree["meta_data.json"])
    mods = list(meta["modalities"])
    raw = meta["raw"]
    if mms:  # the MMS-DATA patterns, or a frame of more than 4 channels as .npy
        assert mods == list(FIVE)
        if raw:
            for m in mods:
                assert meta["modalities"][m]["mosaick_pattern"] == tmms.MMS_MOSAICK_PATTERNS[m]
        else:
            assert "modalities/multispectral/0000.npy" in names
    # meta_data.json names every frame .png, the .npy frames too (as the reference's
    # build_metadata does): a loader reaches only the PNG frames
    png = [m for m in mods if f"modalities/{m}/0000.png" in names]
    ds = load_dataset(str(outs["port"]), png, {m: list(range(VIEWS)) for m in png}, raw=raw,
                      device="cpu")
    for m in png:
        frames = ds.data[m].images
        assert frames.shape[0] == VIEWS and np.isfinite(frames).all() and frames.max() > 0
        assert (frames.shape[1], frames.shape[2]) == (meta["modalities"][m]["height"],
                                                      meta["modalities"][m]["width"])
    for m in set(mods) - set(png):
        with pytest.raises(FileNotFoundError):
            load_dataset(str(outs["port"]), [m], {m: [0]}, raw=raw, device="cpu")
