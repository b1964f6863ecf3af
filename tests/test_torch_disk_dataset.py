"""Scenes on disk in the port against the JAX package: load_dataset (PNG
frames through the port's own reader, no OpenCV), write_synthetic_scene,
train_eval_indices, and launcher.build_datasets on a scene directory.

- The JAX package's writer (cv2) read by both packages' load_dataset, raw
  and demosaicked, and the port's writer read by JAX's: equal frames
  (np.array_equal), cameras (intrinsics, camera_to_worlds, distortion,
  camera_type, pixel_offset), mosaick masks, scene box and worldtogt; the
  two writers' meta_data.json equal.
- A hand-edited meta_data.json (OPENCV_FISHEYE with distortion, a
  pixel offset, near_far and box scene boxes, .npy and 8-bit frames): the
  same, and one view's rays against JAX's generate_rays within 1e-5.
- train_eval_indices with explicit, per-modality and seeded-ratio splits
  equal to JAX's; per-modality view counts (tests/test_integration.py's
  unaligned case); launcher.build_datasets with skip indices equal to
  JAX's build_datasets.
- The port's Trainer trains 2 steps of the tiny grid_raw_tpu of
  tests/test_torch_train.py on a disk scene whose modalities have
  different view counts: every loss finite, every parameter moved.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import multimodalstudio_tpu.configs.config as jconfig
import multimodalstudio_tpu.data.dataset as jdataset
import multimodalstudio_tpu.launcher as jlauncher
from multimodalstudio_tpu.cameras.cameras import generate_rays as jgenerate_rays
from multimodalstudio_tpu.data.synthetic import write_synthetic_scene as jwrite

import multimodalstudio_tpu_torch.configs.config as tconfig
import multimodalstudio_tpu_torch.data.dataset as tdataset
from multimodalstudio_tpu_torch import launcher as tlauncher
from multimodalstudio_tpu_torch.cameras.cameras import generate_rays as tgenerate_rays
from multimodalstudio_tpu_torch.data.synthetic import write_synthetic_scene as twrite
from multimodalstudio_tpu_torch.engine.trainer import Trainer

from test_torch_train import TCFG

torch.set_num_threads(1)

FIVE = ("rgb", "mono", "infrared", "polarization", "multispectral")
GEOM = dict(num_views=5, height=10, width=12)


def assert_same_dataset(j, t):
    assert t.modalities == j.modalities and t.raw == j.raw
    assert dataclasses.asdict(t.scene_box) == dataclasses.asdict(j.scene_box)
    assert np.array_equal(t.worldtogt, j.worldtogt)
    assert t.channels_per_modality == j.channels_per_modality
    for mod in j.modalities:
        jd, td = j.data[mod], t.data[mod]
        assert td.images.dtype == jd.images.dtype == np.float32
        assert np.array_equal(td.images, jd.images), mod
        assert np.array_equal(td.frame_ids, jd.frame_ids), mod
        jc, tc = jd.cameras, td.cameras
        for name in ("fx", "fy", "cx", "cy", "camera_to_worlds"):
            assert np.array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name))), name
        assert (tc.distortion_params is None) == (jc.distortion_params is None)
        if jc.distortion_params is not None:
            assert np.array_equal(tc.distortion_params.numpy(), np.asarray(jc.distortion_params))
        for name in ("width", "height", "pixel_offset", "camera_type"):
            assert getattr(tc, name) == getattr(jc, name), name
        for name in ("mosaick_pattern", "mosaick_mask"):
            a, b = getattr(td, name), getattr(jd, name)
            assert (a is None) == (b is None) and (a is None or np.array_equal(a, b)), name
    if j.mosaick_masks_across is None:
        assert t.mosaick_masks_across is None
    else:
        for a in j.mosaick_masks_across:
            for b in j.mosaick_masks_across[a]:
                assert np.array_equal(t.mosaick_masks_across[a][b], j.mosaick_masks_across[a][b])


def load_both(scene, mods, idx, raw):
    return (jdataset.load_dataset(scene, mods, idx, raw=raw),
            tdataset.load_dataset(scene, mods, idx, raw=raw, device="cpu"))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Both writers' scenes, raw (five modalities) and demosaicked (rgb,
    mono, polarization: a PNG holds 1, 3 or 4 channels)."""
    root = tmp_path_factory.mktemp("scenes")
    out = {}
    for raw, mods in ((True, FIVE), (False, ("rgb", "mono", "polarization"))):
        for name, write in (("jax", jwrite), ("port", twrite)):
            out[name, raw] = (write(str(root / f"{name}_{int(raw)}"), mods, raw=raw, **GEOM), mods)
    return out


@pytest.mark.parametrize("raw", [True, False])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_load_dataset_matches_jax(scenes, writer, raw):
    scene, mods = scenes[writer, raw]
    idx = {m: [0, 2, 3, 4] for m in mods}
    assert_same_dataset(*load_both(scene, mods, idx, raw))


@pytest.mark.parametrize("raw", [True, False])
def test_writers_write_the_same_scene(scenes, raw):
    (jscene, mods), (tscene, _) = scenes["jax", raw], scenes["port", raw]
    with open(os.path.join(jscene, "meta_data.json")) as f:
        jmeta = json.load(f)
    with open(os.path.join(tscene, "meta_data.json")) as f:
        assert json.load(f) == jmeta
    idx = {m: list(range(GEOM["num_views"])) for m in mods}
    jdata = jdataset.load_dataset(jscene, mods, idx, raw=raw)
    tdata = tdataset.load_dataset(tscene, mods, idx, raw=raw, device="cpu")
    for mod in mods:
        assert np.array_equal(tdata.data[mod].images, jdata.data[mod].images), mod


def test_port_writer_refuses_frames_a_png_cannot_hold(tmp_path):
    with pytest.raises(ValueError, match="1, 3 or 4 channels"):
        twrite(str(tmp_path / "s"), ("multispectral",), raw=False, **GEOM)


@pytest.fixture(scope="module")
def edited(scenes, tmp_path_factory):
    """The JAX writer's raw scene with a hand-edited meta_data.json:
    OPENCV_FISHEYE cameras with distortion (undistorted false), pixel
    offset 0.25, a near_far scene box, one rgb frame as .npy and one mono
    frame as 8-bit PNG; and a copy with a box scene box."""
    import shutil

    import cv2

    src, _ = scenes["jax", True]
    out = {}
    for box in ("near_far", "box"):
        dst = str(tmp_path_factory.mktemp(f"edited_{box}"))
        shutil.copytree(src, dst, dirs_exist_ok=True)
        with open(os.path.join(dst, "meta_data.json")) as f:
            meta = json.load(f)
        meta["undistorted"] = False
        meta["pixel_offset"] = 0.25
        aabb = [[-1.0, -0.8, -0.6], [1.0, 0.9, 0.7]]
        meta["scene_box"] = ({"collider_type": "near_far", "near": 0.1, "far": 5.0, "aabb": aabb}
                             if box == "near_far" else {"collider_type": "box", "aabb": aabb})
        for i, (mod, m) in enumerate(meta["modalities"].items()):
            m["camera_model"] = "OPENCV_FISHEYE"
            m["distortion_params"] = [0.05 * (i + 1), -0.01, 0.002, 0.0, 0.001, -0.002]
        rgb = meta["modalities"]["rgb"]["frames"][1]
        img = cv2.imread(os.path.join(dst, "modalities", "rgb", rgb["file_name"]),
                         cv2.IMREAD_UNCHANGED)
        np.save(os.path.join(dst, "modalities", "rgb", "0001.npy"), img.astype(np.float32) / 65535)
        rgb["file_name"] = "0001.npy"
        mono = meta["modalities"]["mono"]["frames"][2]
        path = os.path.join(dst, "modalities", "mono", mono["file_name"])
        cv2.imwrite(path, (cv2.imread(path, cv2.IMREAD_UNCHANGED) >> 8).astype(np.uint8))
        with open(os.path.join(dst, "meta_data.json"), "w") as f:
            json.dump(meta, f)
        out[box] = dst
    return out


@pytest.mark.parametrize("box", ["near_far", "box"])
def test_edited_metadata_loads_and_rays_match_jax(edited, box):
    idx = {m: [0, 1, 2, 4] for m in FIVE}
    j, t = load_both(edited[box], FIVE, idx, True)
    assert_same_dataset(j, t)
    assert t.scene_box.collider_type == box
    cams_j, cams_t = j.data["polarization"].cameras, t.data["polarization"].cameras
    assert cams_t.camera_type == 2 and cams_t.distortion_params is not None
    h, w = cams_t.height, cams_t.width
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    coords = (np.stack([ys, xs], -1).reshape(-1, 2) + cams_t.pixel_offset).astype(np.float32)
    idx_ray = np.full(len(coords), 2, np.int32)
    jr = jgenerate_rays(cams_j, jnp.asarray(idx_ray), jnp.asarray(coords))
    tr = tgenerate_rays(cams_t, torch.from_numpy(idx_ray), torch.from_numpy(coords))
    for name in ("origins", "directions", "up_directions", "pixel_area", "directions_norm"):
        np.testing.assert_allclose(getattr(tr, name).numpy(), np.asarray(getattr(jr, name)),
                                   atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("mode", ["explicit", "per_modality", "ratio"])
def test_train_eval_indices_match_jax(scenes, mode):
    scene, mods = scenes["port", True]
    kw = {"explicit": dict(eval_image_indices=[1, 4]),
          "per_modality": dict(eval_indices_per_modality={"rgb": [0], "mono": [2, 3]}),
          "ratio": dict(eval_ratio=0.4, seed=3)}[mode]
    want = jdataset.train_eval_indices(scene, mods, **kw)
    assert tdataset.train_eval_indices(scene, mods, **kw) == want
    assert any(want[1].values()) and any(want[0].values())


def test_per_modality_view_counts(scenes):
    scene, _ = scenes["port", True]
    ds = tdataset.load_dataset(scene, ("rgb", "mono"), {"rgb": [0, 1, 2, 3, 4], "mono": [1, 3]},
                               raw=True, device="cpu")
    assert ds.num_frames("rgb") == 5 and ds.num_frames("mono") == 2
    assert ds.unique_views() == [0, 1, 2, 3, 4]
    np.testing.assert_array_equal(ds.data["mono"].frame_ids, [1, 3])


def _split_config(cmod):
    cfg = cmod.load_config(method="grid_raw_tpu")
    dm = dataclasses.replace(cfg.datamanager, eval_image_indices=(1, 4),
                             skip_indices_per_modality=(("mono", (0, 3)), ("rgb", (2,))))
    return dataclasses.replace(cfg, modalities=FIVE, datamanager=dm)


def test_build_datasets_on_a_directory_matches_jax(scenes):
    scene, _ = scenes["port", True]
    jtrain, jeval = jlauncher.build_datasets(_split_config(jconfig), scene)
    ttrain, teval = tlauncher.build_datasets(_split_config(tconfig), scene, device="cpu")
    assert list(ttrain.data["mono"].frame_ids) == [2] and list(ttrain.data["rgb"].frame_ids) == [0, 3]
    assert list(teval.data["mono"].frame_ids) == [1, 4]
    assert_same_dataset(jtrain, ttrain)
    assert_same_dataset(jeval, teval)


def test_trainer_trains_on_a_disk_scene_with_unaligned_views(scenes):
    scene, _ = scenes["port", True]
    mods = TCFG.modalities
    cfg = dataclasses.replace(
        TCFG, max_num_iterations=2, steps_per_eval_batch=0, steps_per_eval_image=0,
        steps_per_eval_all_images=0, steps_per_save=0,
        logging=dataclasses.replace(TCFG.logging, steps_per_log=1, steps_per_flush_buffer=2),
        datamanager=dataclasses.replace(TCFG.datamanager, eval_image_indices=(4,),
                                        skip_indices_per_modality=((mods[1], (0, 2)),)))
    train, evald = tlauncher.build_datasets(cfg, scene, device="cpu")
    counts = {m: train.num_frames(m) for m in mods}
    assert counts[mods[0]] == 4 and counts[mods[1]] == 2
    cfg = tlauncher.resolve_model_channels(cfg, train)
    trainer = Trainer(cfg, train, evald, device="cpu")
    trainer.setup()
    before = {k: p.detach().clone() for k, p in trainer.model.named_parameters()}
    poses = {m: p.detach().clone() for m, p in trainer.state.camera_poses.items()}
    trainer.train()
    assert trainer.state.step == 2 and trainer.state.opt_state.count == 2
    window = getattr(trainer, "_aux_window", None)
    auxes = [a for _, a in window] if window else []
    assert auxes
    for aux in auxes:
        assert all(np.isfinite(float(v)) for v in aux["losses"].values())
        assert aux["metrics"]["grads_finite"] == 1.0
    unmoved = [k for k, p in trainer.model.named_parameters() if torch.equal(p, before[k])]
    assert unmoved == []
    assert all(not torch.equal(p, poses[m]) for m, p in trainer.state.camera_poses.items())
