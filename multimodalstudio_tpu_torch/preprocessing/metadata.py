"""Scene preprocessing, an offline host tool (JAX reference:
preprocessing/metadata.py, copied): the region of interest from the
sparse cloud, camera matrices, frame crops, and meta_data.json, the file
data/dataset.py::load_dataset reads. Clustering runs on scipy; OpenCV,
imported only by the functions that undistort and resize, handles those.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from multimodalstudio_tpu_torch.preprocessing.colmap import (
    parse_images_txt,
    parse_points3d_txt,
    qvec_to_rotmat,
)
from multimodalstudio_tpu_torch.utils.meshio import write_ply_points

RDF2RUB = np.diag([1.0, -1.0, -1.0, 1.0])


def cluster_points(points: np.ndarray, radius: float) -> List[np.ndarray]:
    """Connected components under a distance threshold (replaces
    trimesh.grouping.clusters in reference utils.py:82-96)."""
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    pairs = tree.sparse_distance_matrix(tree, radius, output_type="coo_matrix")
    n, labels = connected_components(pairs, directed=False)
    return [np.nonzero(labels == i)[0] for i in range(n)]


def _oriented_rotation(points: np.ndarray) -> np.ndarray:
    """Rotation aligning a point cluster's principal axes with the world
    axes (stand-in for trimesh.bounds.oriented_bounds in reference
    utils.py:126: PCA instead of minimum-volume OBB — identical for the
    planar checkerboard clusters this is applied to)."""
    centered = points - points.mean(0)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    r = vt  # rows = principal axes, descending variance
    if np.linalg.det(r) < 0:
        r[2] *= -1.0
    return r


def generate_bounding_box(
    points: np.ndarray,
    radius: float = 0.5,
    scale: float = 1.0,
    pointcloud_filtering: bool = False,
    reorient_axis: bool = False,
    output_path: Optional[str] = None,
) -> Tuple[np.ndarray, List[List[float]]]:
    """ROI from the sparse cloud: pick the densest compact cluster, normalize
    it into the unit sphere, optionally reorient using the MMS-DATA
    checkerboard planes, re-center (reference utils.py:45-147).
    Returns (gt2w 4x4, aabb)."""
    pointcloud = np.asarray(points) * scale

    clusters = [c for c in cluster_points(pointcloud, radius) if c.shape[0] > 100]
    if clusters:
        idxs = np.argsort([c.shape[0] for c in clusters])[::-1][:2]
        stds = [np.mean(np.std(pointcloud[clusters[i]], axis=0)) for i in idxs]
        pointcloud = pointcloud[clusters[idxs[int(np.argmin(stds))]]]

    if pointcloud_filtering and len(pointcloud) > 300:
        clusters = cluster_points(pointcloud, radius * 0.2)
        order = np.argsort([c.shape[0] for c in clusters])[::-1][:3]
        pointcloud = pointcloud[np.concatenate([clusters[i] for i in order])]

    ab_min, ab_max = pointcloud.min(0), pointcloud.max(0)
    center = (ab_max + ab_min) / 2
    rad = np.max(np.linalg.norm(pointcloud - center, axis=-1))
    transform1 = np.linalg.inv(
        np.diag([rad, rad, rad, 1.0]) + np.pad(center[:, None], ((0, 1), (3, 0)))
    )
    pointcloud = (pointcloud - center) / rad

    transform2 = np.eye(4)
    if reorient_axis:
        # MMS-DATA checkerboard reorientation (reference utils.py:117-136):
        # the two biggest clusters OUTSIDE the unit half-cube are the
        # checkerboards on the ground plane; rotate so they become
        # axis-aligned, then permute axes (x <- z, z <- -x).
        mask = np.any(np.abs(pointcloud) > 0.5, axis=-1)
        if mask.sum() > 10:
            sub = pointcloud[mask]
            clusters = cluster_points(sub, radius * rad * 0.20)
            order = np.argsort([c.shape[0] for c in clusters])[::-1][:2]
            selected = np.concatenate([clusters[i] for i in order])
            rot = np.eye(4)
            rot[:3, :3] = _oriented_rotation(sub[selected])
            permutation = np.array(
                [[0, 0, -1, 0], [0, 1, 0, 0], [1, 0, 0, 0], [0, 0, 0, 1]],
                dtype=np.float64,
            )
            transform2 = permutation @ rot
            pointcloud = pointcloud @ transform2[:3, :3].T

    ab_min, ab_max = pointcloud.min(0), pointcloud.max(0)
    transform3 = np.eye(4)
    transform3[:3, 3] = -(ab_max + ab_min) / 2
    pointcloud = pointcloud + transform3[:3, 3]

    gt2w = transform3 @ transform2 @ transform1
    if output_path is not None:
        write_ply_points(os.path.join(output_path, "pointcloud.ply"), pointcloud)
    return gt2w, [ab_min.tolist(), ab_max.tolist()]


# --------------------------------------------------------- camera processing
def process_camera_matrix(
    modality_data: Dict[str, dict], undistort: bool = False, scale: float = 1.0
) -> Dict[str, dict]:
    """Crop -> (optional) undistort -> scale the camera matrix per modality
    (reference utils.py:255-329)."""
    import cv2

    for data in modality_data.values():
        cam = data["original_camera_matrix"].copy()
        x, y, w, h = data["original_roi"]
        cam[0, 2] -= x
        cam[1, 2] -= y
        data["cropped_camera_matrix"] = cam.copy()
        data["current_camera_matrix"] = cam.copy()
        data["current_roi"] = (0, 0, w, h)

        if undistort:
            und, roi = cv2.getOptimalNewCameraMatrix(
                data["current_camera_matrix"], data["dist_coeffs"], imageSize=(w, h), alpha=1
            )
            data["undistorted_camera_matrix"] = und
            data["undistorted_roi"] = roi
            cur = und.copy()
            cur[0, 2] -= roi[0]
            cur[1, 2] -= roi[1]
            data["current_camera_matrix"] = cur
            data["current_roi"] = roi

        if scale != 1.0:
            cam = data["current_camera_matrix"].copy()
            _, _, w, h = data["current_roi"]
            cam[:2] *= scale
            data["current_camera_matrix"] = cam
            data["current_roi"] = (0, 0, round(w * scale), round(h * scale))
    return modality_data


def adjust_frame(
    frame: np.ndarray,
    data: dict,
    undistort: bool = False,
    scale: float = 1.0,
    demosaick: bool = False,
    demosaicking_fn: Callable = lambda x: x,
) -> np.ndarray:
    """Crop / demosaick / undistort / resize one frame
    (reference utils.py:331-361)."""
    import cv2

    x, y, w, h = data["original_roi"]
    frame = frame[y : y + h, x : x + w]
    if demosaick:
        frame = demosaicking_fn(frame)
    if undistort:
        frame = cv2.undistort(
            frame,
            data["cropped_camera_matrix"],
            data["dist_coeffs"],
            newCameraMatrix=data["undistorted_camera_matrix"],
        )
        x, y, w, h = data["undistorted_roi"]
        frame = frame[y : y + h, x : x + w]
    if scale != 1.0:
        frame = cv2.resize(frame, (0, 0), fx=scale, fy=scale, interpolation=cv2.INTER_AREA)
    return frame


# ------------------------------------------------------------ metadata build
def build_metadata(
    output_path: str,
    images_txt: str,
    modalities: Sequence[str],
    modality_data: Dict[str, dict],
    gt2world: np.ndarray,
    bbox: List[List[float]],
    calibration: Optional[Dict[str, dict]] = None,
    scale: float = 1.0,
    undistorted: bool = False,
    mosaicked: bool = False,
    mosaick_patterns: Optional[Dict[str, list]] = None,
) -> str:
    """Write meta_data.json (reference utils.py:437-571): per-modality camera
    model + intrinsics, per-frame camtoworld chained through the
    camera2reference extrinsics, gt2world normalization and RDF->RUB flip."""
    metadata: dict = {
        "undistorted": undistorted,
        "raw": mosaicked,
        "pixel_offset": 0.0,
        "scene_box": {"aabb": bbox, "collider_type": "sphere", "radius": 1.0},
        "worldtogt": np.linalg.inv(gt2world).tolist(),
        "modalities": {},
    }

    images = parse_images_txt(images_txt)

    for mi, mod in enumerate(modalities):
        data = modality_data[mod]
        _, _, w, h = data["current_roi"]
        cam = data["current_camera_matrix"]
        modality = {
            "camera_model": "PINHOLE" if undistorted else "OPENCV",
            "width": int(w),
            "height": int(h),
            "fx": float(cam[0, 0]),
            "fy": float(cam[1, 1]),
            "cx": float(cam[0, 2]),
            "cy": float(cam[1, 2]),
        }
        if not undistorted:
            modality["distortion_params"] = np.asarray(data["dist_coeffs"]).reshape(-1)[
                :6
            ].tolist()
        if mosaicked and mosaick_patterns is not None:
            modality["mosaick_pattern"] = mosaick_patterns[mod]

        camera2reference = np.eye(4)
        if calibration is not None and mod in calibration:
            camera2reference = np.asarray(calibration[mod]["camera2reference"])

        frames = []
        for name, img in sorted(images.items()):
            if calibration is None and img["camera_id"] != mi + 1:
                continue
            gt2c = np.eye(4)
            gt2c[:3, :3] = qvec_to_rotmat(img["qvec"])
            gt2c[:3, 3] = img["tvec"] * scale
            c2gt = np.linalg.inv(gt2c) @ camera2reference

            c2w = np.eye(4)
            c2w[:4, 3] = gt2world @ c2gt[:4, 3]
            c2w[:3, :3] = (gt2world[:3, :3] @ c2gt[:3, :3]) / np.linalg.norm(
                gt2world[:3, 0]
            )
            c2w = c2w @ RDF2RUB

            stem = os.path.splitext(os.path.basename(name.replace("\\", "/")))[0]
            frame_id = int(stem)
            frames.append(
                {
                    "frame_id": frame_id,
                    "file_name": f"{frame_id:04d}.png",
                    "camtoworld": c2w[:3, :].tolist(),
                }
            )
        modality["frames"] = frames
        metadata["modalities"][mod] = modality

    os.makedirs(output_path, exist_ok=True)
    path = os.path.join(output_path, "meta_data.json")
    with open(path, "w") as f:
        json.dump(metadata, f, indent=4)
    return path


def check_cameras(metadata_path: str, output_path: str) -> str:
    """Export all camera centers as a PLY cloud for visual inspection
    (reference utils.py:573-595)."""
    with open(metadata_path) as f:
        meta = json.load(f)
    centers = []
    for mod in meta["modalities"].values():
        for frame in mod["frames"]:
            centers.append(np.asarray(frame["camtoworld"])[:3, 3])
    path = os.path.join(output_path, "camera_poses.ply")
    write_ply_points(path, np.asarray(centers))
    return path
