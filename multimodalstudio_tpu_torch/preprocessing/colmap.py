"""COLMAP structure-from-motion drivers, offline host tools (JAX
reference: preprocessing/colmap.py, copied): subprocess wrappers for
feature extraction, matching, mapping and model conversion, the text
model's parsers, and metric scale from ArUco markers. COLMAP stays an
external binary; OpenCV is imported only by the functions that use it,
so a machine that prepares a capture needs both, the card's does not.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def colmap_available() -> bool:
    return shutil.which("colmap") is not None


def _run(args: Sequence[str]) -> None:
    subprocess.run(list(args), check=True)


def run_feature_extractor(
    database_path: str, image_path: str, camera_model: str = "OPENCV", single_camera: bool = True
) -> None:
    _run(
        [
            "colmap", "feature_extractor",
            "--database_path", database_path,
            "--image_path", image_path,
            "--ImageReader.camera_model", camera_model,
            "--ImageReader.single_camera", str(int(single_camera)),
        ]
    )


def run_exhaustive_matcher(database_path: str) -> None:
    _run(["colmap", "exhaustive_matcher", "--database_path", database_path])


def run_mapper(database_path: str, image_path: str, output_path: str) -> None:
    os.makedirs(output_path, exist_ok=True)
    _run(
        [
            "colmap", "mapper",
            "--database_path", database_path,
            "--image_path", image_path,
            "--output_path", output_path,
        ]
    )


def run_model_converter(input_path: str, output_path: str, output_type: str = "TXT") -> None:
    _run(
        [
            "colmap", "model_converter",
            "--input_path", input_path,
            "--output_path", output_path,
            "--output_type", output_type,
        ]
    )


def run_sfm_pipeline(work_dir: str, image_path: str, camera_model: str = "OPENCV") -> str:
    """feature_extractor -> exhaustive_matcher -> mapper -> TXT model
    (reference colmap.py:26-132). Returns the TXT model directory."""
    db = os.path.join(work_dir, "database.db")
    sparse = os.path.join(work_dir, "sparse")
    run_feature_extractor(db, image_path, camera_model)
    run_exhaustive_matcher(db)
    run_mapper(db, image_path, sparse)
    model0 = os.path.join(sparse, "0")
    txt = os.path.join(work_dir, "sparse_txt")
    os.makedirs(txt, exist_ok=True)
    run_model_converter(model0, txt, "TXT")
    return txt


# --------------------------------------------------------------- txt parsing
def parse_cameras_txt(path: str) -> Dict[int, dict]:
    """Parse COLMAP cameras.txt into {camera_id: {model, width, height,
    params}} (reference colmap.py:242-313)."""
    cameras = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            cam_id = int(parts[0])
            cameras[cam_id] = {
                "model": parts[1],
                "width": int(parts[2]),
                "height": int(parts[3]),
                "params": np.asarray([float(p) for p in parts[4:]]),
            }
    return cameras


def parse_images_txt(path: str) -> Dict[str, dict]:
    """Parse images.txt into {image_name: {qvec, tvec, camera_id}}."""
    images = {}
    with open(path) as f:
        lines = [l for l in f if not l.startswith("#")]
    for i in range(0, len(lines) - 1, 2):
        parts = lines[i].split()
        if len(parts) < 10:
            continue
        images[parts[9]] = {
            "qvec": np.asarray([float(x) for x in parts[1:5]]),
            "tvec": np.asarray([float(x) for x in parts[5:8]]),
            "camera_id": int(parts[8]),
        }
    return images


def parse_points3d_txt(path: str) -> np.ndarray:
    """Sparse point positions [N, 3] from points3D.txt."""
    pts = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            pts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return np.asarray(pts)


def qvec_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def w2c_to_c2w(qvec: np.ndarray, tvec: np.ndarray) -> np.ndarray:
    """COLMAP world-to-camera -> 4x4 camera-to-world."""
    r = qvec_to_rotmat(qvec)
    c2w = np.eye(4)
    c2w[:3, :3] = r.T
    c2w[:3, 3] = -r.T @ tvec
    return c2w


# ------------------------------------------------------------- metric scale
def compute_aruco_scale(
    frames: Sequence[np.ndarray],
    c2ws: Sequence[np.ndarray],
    intrinsics: np.ndarray,
    marker_size_m: float = 0.036,
) -> Optional[float]:
    """Metric scale from ArUco markers of known size triangulated in two
    views (reference colmap.py:162-240). Returns scale or None if markers
    aren't found in at least two frames."""
    import cv2

    detector = cv2.aruco.ArucoDetector(
        cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_4X4_50)
    )
    observations: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}
    for frame, c2w in zip(frames, c2ws):
        gray = frame if frame.ndim == 2 else cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        corners, ids, _ = detector.detectMarkers(gray)
        if ids is None:
            continue
        for marker_corners, marker_id in zip(corners, ids.reshape(-1)):
            observations.setdefault(int(marker_id), []).append(
                (marker_corners.reshape(4, 2), np.asarray(c2w))
            )

    scales = []
    for obs in observations.values():
        if len(obs) < 2:
            continue
        (ca, c2wa), (cb, c2wb) = obs[0], obs[1]
        pa = _triangulate(ca, cb, c2wa, c2wb, intrinsics)
        side = np.mean(
            [np.linalg.norm(pa[i] - pa[(i + 1) % 4]) for i in range(4)]
        )
        if side > 0:
            scales.append(marker_size_m / side)
    return float(np.median(scales)) if scales else None


def _triangulate(corners_a, corners_b, c2w_a, c2w_b, k) -> np.ndarray:
    import cv2

    w2c_a = np.linalg.inv(np.vstack([c2w_a[:3], [0, 0, 0, 1]]))[:3]
    w2c_b = np.linalg.inv(np.vstack([c2w_b[:3], [0, 0, 0, 1]]))[:3]
    pa = cv2.triangulatePoints(k @ w2c_a, k @ w2c_b, corners_a.T, corners_b.T)
    return (pa[:3] / pa[3]).T
