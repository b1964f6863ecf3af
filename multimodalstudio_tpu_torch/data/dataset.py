"""Datasets: meta_data.json parsing, frame loading, mosaick masks and
train/eval splits (JAX reference: data/dataset.py). Frames are host numpy
arrays (float32 in [0, 1]); camera tables are tensors on the dataset's
device. PNG frames are decoded by utils/images.py, not OpenCV, in OpenCV's
channel order (BGR), which the loader flips for non-raw rgb as the
reference's does."""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodalstudio_tpu_torch.cameras.cameras import (
    EQUIRECTANGULAR,
    FISHEYE,
    PERSPECTIVE,
    Cameras,
)
from multimodalstudio_tpu_torch.core.scene_box import SceneBox
from multimodalstudio_tpu_torch.device import resolve_device
from multimodalstudio_tpu_torch.utils.images import read_png

CAMERA_MODEL_TO_TYPE = {
    "PINHOLE": PERSPECTIVE,
    "SIMPLE_PINHOLE": PERSPECTIVE,
    "OPENCV": PERSPECTIVE,
    "OPENCV_FISHEYE": FISHEYE,
    "EQUIRECTANGULAR": EQUIRECTANGULAR,
}


def normalize_frame(img: np.ndarray) -> np.ndarray:
    """uint8 / uint16 to float32 in [0, 1]; a float frame over 1 is taken
    as 8- or 16-bit by its range (dataset.py:37-46)."""
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    img = img.astype(np.float32)
    if img.max() > 1.0:
        img = img / 65535.0 if img.max() > 255.0 else img / 255.0
    return img


def normalize_loaded_frame(img: np.ndarray) -> np.ndarray:
    """A just-loaded frame as float32 in [0, 1], by its dtype, not its
    values (dataset.py:49-57): a dark uint frame is still divided by its
    dtype's range; a float frame is kept unless its range says otherwise."""
    if img.dtype in (np.uint8, np.uint16):
        return normalize_frame(img)
    return normalize_frame(img) if img.max() > 1 else img.astype(np.float32)


def read_frame(path: str) -> np.ndarray:
    """A frame from a .npy file, or from a PNG file as
    cv2.imread(path, IMREAD_UNCHANGED) returns it (dataset.py:60-70)."""
    if path.endswith(".npy"):
        return np.load(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    return read_png(path)


def build_mosaick_mask(pattern: np.ndarray, height: int, width: int) -> np.ndarray:
    """Tile a mosaick pattern to frame size."""
    n_h = math.ceil(height / pattern.shape[0])
    n_w = math.ceil(width / pattern.shape[1])
    return np.tile(pattern, (n_h, n_w))[:height, :width].astype(np.int8)


def build_masks_across_modalities(
    patterns: Dict[str, np.ndarray], shapes: Dict[str, Tuple[int, int]]
) -> Dict[str, Dict[str, np.ndarray]]:
    """Every modality's pattern tiled to every modality's frame shape."""
    return {
        mod_shape: {mod_pat: build_mosaick_mask(p, h, w) for mod_pat, p in patterns.items()}
        for mod_shape, (h, w) in shapes.items()
    }


@dataclasses.dataclass
class ModalityData:
    """All frames and cameras of one modality."""

    images: np.ndarray  # [F, H, W, C] float32
    cameras: Cameras
    frame_ids: np.ndarray  # [F] original view ids
    mosaick_pattern: Optional[np.ndarray] = None
    mosaick_mask: Optional[np.ndarray] = None  # [H, W] int8

    @property
    def num_frames(self) -> int:
        return self.images.shape[0]

    @property
    def channels(self) -> int:
        return self.images.shape[-1]


@dataclasses.dataclass
class MMSDataset:
    """A split (train or eval) of a multimodal scene."""

    modalities: Tuple[str, ...]
    data: Dict[str, ModalityData]
    scene_box: SceneBox
    worldtogt: np.ndarray
    raw: bool
    # masks[target_shape_modality][pattern_modality]
    mosaick_masks_across: Optional[Dict[str, Dict[str, np.ndarray]]] = None

    @property
    def channels_per_modality(self) -> Dict[str, int]:
        out = {}
        for mod, d in self.data.items():
            if self.raw and d.mosaick_pattern is not None:
                out[mod] = int(len(np.unique(d.mosaick_pattern)))
            else:
                out[mod] = d.channels
        return out

    def num_frames(self, mod: str) -> int:
        return self.data[mod].num_frames

    def unique_views(self) -> List[int]:
        views = set()
        for d in self.data.values():
            views |= set(int(i) for i in d.frame_ids)
        return sorted(views)


def _scene_box_from_metadata(meta: dict) -> SceneBox:
    sb = meta["scene_box"]
    ct = sb["collider_type"]
    if ct == "sphere":
        return SceneBox(collider_type="sphere", radius=float(sb["radius"]))
    if ct == "near_far":
        return SceneBox(collider_type="near_far", near=float(sb["near"]), far=float(sb["far"]),
                        aabb=tuple(map(tuple, sb["aabb"])))
    if ct == "box":
        return SceneBox(collider_type="box", aabb=tuple(map(tuple, sb["aabb"])))
    raise ValueError(f"collider {ct} not supported")


def _load_modality(meta: dict, data_dir: str, mod: str, indexes: Sequence[int], raw: bool,
                   device: torch.device) -> ModalityData:
    """One modality's frames of the given view ids, in view-id order, and
    their cameras on `device` (dataset.py:143-205)."""
    mmeta = meta["modalities"][mod]
    images, c2ws, ids = [], [], []
    for frame in mmeta["frames"]:
        idx = frame["frame_id"]
        if idx not in indexes:
            continue
        img = normalize_loaded_frame(
            read_frame(os.path.join(data_dir, "modalities", mod, frame["file_name"])))
        images.append(img[..., None] if img.ndim == 2 else img)
        c2ws.append(np.asarray(frame["camtoworld"], dtype=np.float32)[:3, :4])
        ids.append(idx)
    order = np.argsort(ids)
    images = np.stack([images[i] for i in order])
    c2ws = np.stack([c2ws[i] for i in order])
    ids = np.asarray([ids[i] for i in order])
    if mod == "rgb" and not raw and images.shape[-1] == 3:
        images = images[..., ::-1]  # BGR to RGB

    n = len(ids)

    def full(key):
        return torch.full((n,), float(mmeta[key]), dtype=torch.float32, device=device)

    dist = None
    if not meta.get("undistorted", True):
        dist = torch.as_tensor(np.asarray(mmeta["distortion_params"], np.float32),
                               device=device).expand(n, 6).clone()
    cameras = Cameras(
        fx=full("fx"), fy=full("fy"), cx=full("cx"), cy=full("cy"),
        camera_to_worlds=torch.as_tensor(c2ws, device=device),
        distortion_params=dist,
        width=int(mmeta["width"]), height=int(mmeta["height"]),
        pixel_offset=float(meta.get("pixel_offset", 0.5)),
        camera_type=CAMERA_MODEL_TO_TYPE[mmeta.get("camera_model", "PINHOLE")],
    )
    pattern = mask = None
    if raw:
        pattern = np.asarray(mmeta["mosaick_pattern"])
        mask = build_mosaick_mask(pattern, int(mmeta["height"]), int(mmeta["width"]))
    return ModalityData(images=images, cameras=cameras, frame_ids=ids,
                        mosaick_pattern=pattern, mosaick_mask=mask)


def load_dataset(data_dir: str, modalities: Sequence[str],
                 indexes_per_modality: Dict[str, Sequence[int]], raw: bool = False,
                 device="cuda") -> MMSDataset:
    """One split of a scene directory (meta_data.json and
    modalities/<modality>/<file_name>) given each modality's view ids
    (dataset.py:208-238); cameras on `device` (the card by default, which
    raises without one)."""
    dev = resolve_device(device)
    with open(os.path.join(data_dir, "meta_data.json")) as f:
        meta = json.load(f)
    if raw:
        assert meta.get("raw", False), "dataset frames are not raw"
    data = {mod: _load_modality(meta, data_dir, mod, indexes_per_modality[mod], raw, dev)
            for mod in modalities}
    masks_across = None
    if raw:
        masks_across = build_masks_across_modalities(
            {m: d.mosaick_pattern for m, d in data.items()},
            {m: (d.cameras.height, d.cameras.width) for m, d in data.items()})
    return MMSDataset(
        modalities=tuple(modalities),
        data=data,
        scene_box=_scene_box_from_metadata(meta),
        worldtogt=np.asarray(meta.get("worldtogt", np.eye(4)), dtype=np.float32),
        raw=raw,
        mosaick_masks_across=masks_across,
    )


def train_eval_indices(
    data_dir: str,
    modalities: Sequence[str],
    eval_image_indices: Optional[Sequence[int]] = None,
    eval_indices_per_modality: Optional[Dict[str, Sequence[int]]] = None,
    eval_ratio: float = 0.0,
    seed: int = 0,
) -> Tuple[Dict[str, List[int]], Dict[str, List[int]]]:
    """Each modality's (train, eval) view ids (dataset.py:250-279): the
    per-modality eval ids, else the shared ones, else a seeded random
    `eval_ratio` of the views (numpy's default_rng(seed).choice, so the
    split is the reference's), else none."""
    with open(os.path.join(data_dir, "meta_data.json")) as f:
        meta = json.load(f)
    train, evals = {}, {}
    for mod in modalities:
        all_ids = [fr["frame_id"] for fr in meta["modalities"][mod]["frames"]]
        if eval_indices_per_modality is not None:
            ev = list(eval_indices_per_modality.get(mod, []))
        elif eval_image_indices is not None:
            ev = list(eval_image_indices)
        elif eval_ratio > 0:
            rng = np.random.default_rng(seed)
            k = int(len(all_ids) * eval_ratio)
            ev = sorted(rng.choice(all_ids, size=k, replace=False).tolist())
        else:
            ev = []
        evals[mod] = sorted(i for i in all_ids if i in ev)
        train[mod] = sorted(i for i in all_ids if i not in ev)
    return train, evals
