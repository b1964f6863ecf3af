"""Preprocess a custom multimodal capture into the port's scene layout
(JAX reference: scripts/preprocess_custom_dataset.py, with the same command
line, steps and output files): COLMAP structure from motion over prepared
(demosaicked, 8-bit) frames, an ArUco metric scale where markers are
found, the region of interest's normalization, the camera matrices, the
adjusted frames (PNG, or .npy past 4 channels) and meta_data.json, which
data/dataset.py::load_dataset reads.

A host tool with no device: it runs where a capture is prepared, which
needs the `colmap` binary on PATH and OpenCV (imported by `main`, for the
frames, undistortion, resizing and the markers). The card's machine has
neither, so this script does not run there.

    python -m multimodalstudio_tpu_torch.scripts.preprocess_custom_dataset \\
        --input raw_captures/ --output scenes/my_scene \\
        --modalities rgb mono --undistort --scale 0.5
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from multimodalstudio_tpu_torch.preprocessing import colmap as C
from multimodalstudio_tpu_torch.preprocessing import metadata as M
from multimodalstudio_tpu_torch.preprocessing.demosaick import (
    demosaick_bayer,
    demosaick_multispectral,
    demosaick_polarization,
)

DEMOSAICK_FNS = {
    "rgb": demosaick_bayer,
    "polarization": demosaick_polarization,
    "multispectral": demosaick_multispectral,
    "mono": lambda x: x,
    "infrared": lambda x: x,
}

MOSAICK_PATTERNS = {
    "rgb": [[1, 2], [0, 1]],
    "mono": [[0]],
    "infrared": [[0]],
    "polarization": [[0, 1], [3, 2]],
    "multispectral": [[0, 1, 2], [3, 4, 5], [6, 7, 8]],
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True, help="dir with modalities/<mod>/*.png")
    parser.add_argument("--output", required=True)
    parser.add_argument("--modalities", nargs="+", default=["rgb"])
    parser.add_argument("--undistort", action="store_true")
    parser.add_argument("--mosaicked", action="store_true", help="keep raw frames")
    parser.add_argument("--scale", type=float, default=1.0)
    parser.add_argument("--calibration", default=None, help="JSON with per-modality "
                        "camera_matrix/dist_coeffs/camera2reference")
    parser.add_argument("--aruco_size", type=float, default=0.036)
    parser.add_argument("--reorient_axis", action="store_true",
                        help="reorient via the MMS-DATA checkerboard planes")
    parser.add_argument("--mosaick_patterns_json", default=None,
                        help="JSON {modality: pattern} overriding the built-in patterns")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    patterns = dict(MOSAICK_PATTERNS)
    if args.mosaick_patterns_json:
        with open(args.mosaick_patterns_json) as f:
            patterns.update(json.load(f))

    import cv2

    if not C.colmap_available():
        sys.exit("COLMAP binary not found on PATH — install COLMAP to run SfM.")

    os.makedirs(args.output, exist_ok=True)
    work = os.path.join(args.output, "colmap")
    os.makedirs(work, exist_ok=True)

    # 1. the SfM images: demosaicked, 8-bit, at most 3 channels (of the
    # reference modality alone when a calibration chains the others to it)
    sfm_dir = os.path.join(work, "images")
    calibration = None
    if args.calibration:
        with open(args.calibration) as f:
            calibration = json.load(f)
    reference_mod = args.modalities[0]
    for mod in args.modalities if calibration is None else [reference_mod]:
        mod_dir = os.path.join(sfm_dir, mod) if calibration is None else sfm_dir
        os.makedirs(mod_dir, exist_ok=True)
        src = os.path.join(args.input, "modalities", mod)
        for name in sorted(os.listdir(src)):
            img = cv2.imread(os.path.join(src, name), cv2.IMREAD_UNCHANGED)
            img = DEMOSAICK_FNS[mod](img)
            if img.dtype == np.uint16:
                img = (img / 256).astype(np.uint8)
            if img.ndim == 3 and img.shape[-1] > 3:
                img = img[..., :3]
            cv2.imwrite(os.path.join(mod_dir, name), img)

    # 2. COLMAP SfM
    txt = C.run_sfm_pipeline(work, sfm_dir)

    # 3. metric scale from ArUco markers of known size, best effort: the
    # reference modality's markers triangulated in two views with the
    # COLMAP poses, the scene scaled so a side measures --aruco_size meters
    scale = 1.0
    images_meta = C.parse_images_txt(os.path.join(txt, "images.txt"))
    ref_frames, ref_c2ws = [], []
    ref_dir = os.path.join(sfm_dir, reference_mod) if calibration is None else sfm_dir
    ref_cam_id = None
    for name in sorted(os.listdir(ref_dir)):
        rel = name if calibration is not None else f"{reference_mod}/{name}"
        meta_entry = images_meta.get(rel) or images_meta.get(name)
        if meta_entry is None:
            continue
        ref_frames.append(cv2.imread(os.path.join(ref_dir, name), cv2.IMREAD_GRAYSCALE))
        ref_c2ws.append(C.w2c_to_c2w(meta_entry["qvec"], meta_entry["tvec"]))
        ref_cam_id = meta_entry["camera_id"]
    if ref_frames and ref_cam_id is not None:
        cameras_all = C.parse_cameras_txt(os.path.join(txt, "cameras.txt"))
        if ref_cam_id in cameras_all:
            p = cameras_all[ref_cam_id]["params"]
            k = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1]])
            found = C.compute_aruco_scale(ref_frames, ref_c2ws, k, marker_size_m=args.aruco_size)
            if found is not None:
                scale = found
                print(f"ArUco metric scale: {scale:.6f}")
            else:
                print("no ArUco markers triangulated; keeping scale 1.0")

    # 4. bounding box + gt2w normalization
    points = C.parse_points3d_txt(os.path.join(txt, "points3D.txt"))
    gt2w, bbox = M.generate_bounding_box(points, scale=scale, reorient_axis=args.reorient_axis,
                                         output_path=args.output)

    # 5. camera matrices: the calibration's, else modality i's COLMAP camera
    # i + 1 (the last camera where there are fewer)
    cameras = C.parse_cameras_txt(os.path.join(txt, "cameras.txt"))
    modality_data = {}
    for mi, mod in enumerate(args.modalities):
        if calibration is not None and mod in calibration:
            cam = np.asarray(calibration[mod]["camera_matrix"])
            dist = np.asarray(calibration[mod]["dist_coeffs"], dtype=np.float64)
            w, h = calibration[mod]["width"], calibration[mod]["height"]
        else:
            entry = cameras[min(mi + 1, max(cameras))]
            p = entry["params"]
            cam = np.array([[p[0], 0, p[2]], [0, p[1], p[3]]] + [[0, 0, 1]])
            dist = np.zeros(6) if len(p) < 8 else np.asarray([p[4], p[5], 0.0, 0.0, p[6], p[7]])
            w, h = entry["width"], entry["height"]
        modality_data[mod] = {
            "original_camera_matrix": cam,
            "dist_coeffs": dist,
            "original_roi": (0, 0, w, h),
        }
    modality_data = M.process_camera_matrix(modality_data, args.undistort, args.scale)

    # 6. adjust + save frames
    for mod in args.modalities:
        src = os.path.join(args.input, "modalities", mod)
        dst = os.path.join(args.output, "modalities", mod)
        os.makedirs(dst, exist_ok=True)
        demosaick = not args.mosaicked and mod in ("rgb", "polarization", "multispectral")
        for name in sorted(os.listdir(src)):
            img = cv2.imread(os.path.join(src, name), cv2.IMREAD_UNCHANGED)
            out = M.adjust_frame(img, modality_data[mod], args.undistort, args.scale, demosaick,
                                 DEMOSAICK_FNS[mod])
            stem = os.path.splitext(name)[0]
            if out.ndim == 3 and out.shape[-1] > 4:
                np.save(os.path.join(dst, f"{int(stem):04d}.npy"), out)
            else:
                cv2.imwrite(os.path.join(dst, f"{int(stem):04d}.png"), out)

    # 7. metadata
    M.build_metadata(
        args.output,
        os.path.join(txt, "images.txt"),
        args.modalities,
        modality_data,
        gt2w,
        bbox,
        calibration=calibration,
        scale=scale,
        undistorted=args.undistort,
        mosaicked=args.mosaicked,
        mosaick_patterns=patterns if args.mosaicked else None,
    )
    M.check_cameras(os.path.join(args.output, "meta_data.json"), args.output)
    print(f"scene written to {args.output}")


if __name__ == "__main__":
    main()
