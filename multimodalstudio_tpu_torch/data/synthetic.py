"""Synthetic multimodal scene (JAX reference: data/synthetic.py): a
lambertian sphere in the unit region of interest with a
direction-dependent background, ray-traced analytically in all five
modalities (rgb, mono, infrared, polarization, multispectral) and
optionally mosaicked to raw single-channel frames; `write_synthetic_scene`
writes it to disk in the reference's meta_data.json layout, as 16-bit
PNGs (utils/images.py, no OpenCV)."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from multimodalstudio_tpu_torch.cameras.cameras import PERSPECTIVE, Cameras
from multimodalstudio_tpu_torch.core.scene_box import SceneBox
from multimodalstudio_tpu_torch.data.dataset import (
    MMSDataset,
    ModalityData,
    build_masks_across_modalities,
    build_mosaick_mask,
)
from multimodalstudio_tpu_torch.device import resolve_device
from multimodalstudio_tpu_torch.utils.images import write_png16

MOSAICK_PATTERNS = {
    "rgb": np.array([[1, 2], [0, 1]]),
    "mono": np.array([[0]]),
    "infrared": np.array([[0]]),
    "polarization": np.array([[0, 1], [3, 2]]),
    "multispectral": np.arange(9).reshape(3, 3),
}

CHANNELS = {"rgb": 3, "mono": 1, "infrared": 1, "polarization": 4, "multispectral": 9}

_LIGHT = np.array([0.4, 0.5, 0.7]) / np.linalg.norm([0.4, 0.5, 0.7])
_SPHERE_RADIUS = 0.5


def _look_at(position: np.ndarray, target: np.ndarray, up=np.array([0.0, 0.0, 1.0])):
    """c2w [3, 4] looking from position at target, -Z forward, +Y up."""
    forward = target - position
    z = -forward / np.linalg.norm(forward)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.concatenate([np.stack([x, y, z], axis=-1), position[:, None]], axis=-1)


def _shade(points: np.ndarray, normals: np.ndarray, mod: str, tex_freq: float) -> np.ndarray:
    """Per-modality appearance on the sphere; tex_freq sets the albedo
    band frequency."""
    lam = np.clip(normals @ _LIGHT, 0.0, 1.0)
    tex = 0.5 + 0.5 * np.sin(tex_freq * points[..., 0]) * np.cos(tex_freq * points[..., 1])
    if tex_freq > 6.0:
        tex = 0.5 * tex + 0.25 + 0.25 * np.sin(
            tex_freq * 0.7071 * (points[..., 1] + points[..., 2]) + 1.3
        )
    base = 0.15 + 0.75 * lam * tex
    if mod == "rgb":
        return np.stack([base, base * 0.8 + 0.1, base * 0.6 + 0.2], axis=-1)
    if mod == "mono":
        return base[..., None]
    if mod == "infrared":
        return (0.3 + 0.6 * lam)[..., None]
    if mod == "multispectral":
        return base[..., None] * np.linspace(0.4, 1.0, 9)
    if mod == "polarization":
        dop = 0.3 * (1.0 - lam)
        psi = np.arctan2(normals[..., 1], normals[..., 0])
        stokes = np.stack([base, base * dop * np.cos(2 * psi), base * dop * np.sin(2 * psi)], -1)
        rows = 0.5 * np.array([[1, 1, 0], [1, 0, 1], [1, -1, 0], [1, 0, -1]], dtype=np.float64)
        return np.clip(stokes @ rows.T, 0.0, 1.0)
    raise ValueError(mod)


def _background(dirs: np.ndarray, mod: str) -> np.ndarray:
    g = 0.5 + 0.3 * dirs[..., 2] + 0.1 * dirs[..., 0]
    c = CHANNELS[mod]
    scale = np.linspace(0.9, 1.1, c) if c > 1 else np.array([1.0])
    return np.clip(g[..., None] * scale, 0.0, 1.0)


def render_view(c2w, fx, fy, cx, cy, height, width, mod, tex_freq: float = 6.0) -> np.ndarray:
    """Analytically ray-trace one view of the scene, [H, W, C] float32."""
    ys, xs = np.meshgrid(np.arange(height) + 0.5, np.arange(width) + 0.5, indexing="ij")
    cam_dirs = np.stack([(xs - cx) / fx, -(ys - cy) / fy, -np.ones_like(xs)], axis=-1)
    dirs = cam_dirs @ c2w[:3, :3].T
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    oc = c2w[:3, 3][None, None, :]
    b = np.sum(dirs * oc, axis=-1)
    disc = b * b - (np.sum(oc * oc, axis=-1) - _SPHERE_RADIUS**2)
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit = (disc > 0) & (t > 0)
    points = oc + t[..., None] * dirs
    fg = _shade(points, points / _SPHERE_RADIUS, mod, tex_freq)
    return np.where(hit[..., None], fg, _background(dirs, mod)).astype(np.float32)


def make_synthetic_dataset(
    modalities: Sequence[str] = ("rgb",),
    num_views: int = 8,
    height: int = 64,
    width: int = 64,
    raw: bool = False,
    view_ids: Optional[Sequence[int]] = None,
    tex_freq: float = 6.0,
    device="cuda",
) -> MMSDataset:
    """An in-memory dataset of the analytic scene; cameras on `device`
    (the card by default, which raises without one)."""
    dev = resolve_device(device)
    view_ids = list(view_ids) if view_ids is not None else list(range(num_views))
    fx = fy = 1.2 * width
    cx, cy = width / 2.0, height / 2.0
    data: Dict[str, ModalityData] = {}
    for mod in modalities:
        images, c2ws = [], []
        for vid in view_ids:
            angle = 2 * np.pi * vid / max(num_views, 1)
            pos = np.array([2.5 * np.cos(angle), 2.5 * np.sin(angle), 1.0 + 0.3 * np.sin(2 * angle)])
            c2w = _look_at(pos, np.zeros(3))
            img = render_view(c2w, fx, fy, cx, cy, height, width, mod, tex_freq=tex_freq)
            if raw:
                mask = build_mosaick_mask(MOSAICK_PATTERNS[mod], height, width)
                img = np.take_along_axis(img, mask[..., None].astype(np.int64), axis=-1)[..., :1]
            images.append(img)
            c2ws.append(c2w.astype(np.float32))
        n = len(view_ids)

        def full(v):
            return torch.full((n,), float(v), dtype=torch.float32, device=dev)

        cameras = Cameras(
            fx=full(fx), fy=full(fy), cx=full(cx), cy=full(cy),
            camera_to_worlds=torch.as_tensor(np.stack(c2ws), device=dev),
            distortion_params=None, width=width, height=height, pixel_offset=0.5,
            camera_type=PERSPECTIVE,
        )
        pattern = MOSAICK_PATTERNS[mod] if raw else None
        data[mod] = ModalityData(
            images=np.stack(images),
            cameras=cameras,
            frame_ids=np.asarray(view_ids),
            mosaick_pattern=pattern,
            mosaick_mask=build_mosaick_mask(pattern, height, width) if raw else None,
        )
    masks_across = None
    if raw:
        masks_across = build_masks_across_modalities(
            {m: d.mosaick_pattern for m, d in data.items()}, {m: (height, width) for m in data}
        )
    return MMSDataset(
        modalities=tuple(modalities),
        data=data,
        scene_box=SceneBox(collider_type="sphere", radius=1.0),
        worldtogt=np.eye(4, dtype=np.float32),
        raw=raw,
        mosaick_masks_across=masks_across,
    )


def write_synthetic_scene(
    out_dir: str,
    modalities: Sequence[str] = ("rgb", "mono"),
    num_views: int = 6,
    height: int = 32,
    width: int = 32,
    raw: bool = False,
) -> str:
    """Write the scene to `out_dir` as the reference's writer does
    (synthetic.py:196-248): modalities/<modality>/<view:04d>.png, 16-bit,
    and the same meta_data.json. A PNG holds RGB(A); the reference hands
    cv2 a non-raw rgb frame as BGR, which cv2 stores as the frame's own RGB,
    and any other frame as it is, whose first and third channels cv2 swaps
    on the way to the file, so the files here hold the same samples."""
    ds = make_synthetic_dataset(modalities, num_views, height, width, raw=raw, device="cpu")
    meta: dict = {
        "worldtogt": np.eye(4).tolist(),
        "undistorted": True,
        "raw": bool(raw),
        "pixel_offset": 0.5,
        "scene_box": {"collider_type": "sphere", "radius": 1.0},
        "modalities": {},
    }
    for mod in modalities:
        d = ds.data[mod]
        frames = []
        mod_dir = os.path.join(out_dir, "modalities", mod)
        os.makedirs(mod_dir, exist_ok=True)
        for i, vid in enumerate(d.frame_ids):
            fname = f"{int(vid):04d}.png"
            img16 = (np.clip(d.images[i], 0, 1) * 65535.0).astype(np.uint16)
            c = img16.shape[-1]
            if c not in (1, 3, 4):
                raise ValueError(f"{mod}: a PNG frame holds 1, 3 or 4 channels, not {c}")
            if c > 1 and mod != "rgb":
                img16 = img16[..., [2, 1, 0, 3][:c]]  # cv2's swap of B and R
            write_png16(os.path.join(mod_dir, fname), img16)
            c2w = np.concatenate([d.cameras.camera_to_worlds[i].numpy(), [[0, 0, 0, 1]]], axis=0)
            frames.append({"frame_id": int(vid), "file_name": fname, "camtoworld": c2w.tolist()})
        meta["modalities"][mod] = {
            "fx": float(d.cameras.fx[0]),
            "fy": float(d.cameras.fy[0]),
            "cx": float(d.cameras.cx[0]),
            "cy": float(d.cameras.cy[0]),
            "width": width,
            "height": height,
            "camera_model": "PINHOLE",
            "distortion_params": [0.0] * 6,
            "mosaick_pattern": MOSAICK_PATTERNS[mod].tolist(),
            "frames": frames,
        }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "meta_data.json"), "w") as f:
        json.dump(meta, f)
    return out_dir
