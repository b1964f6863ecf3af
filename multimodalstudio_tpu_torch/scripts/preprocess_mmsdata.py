"""Preprocess an MMS-DATA capture, the paper's 32-scene layout (JAX
reference: scripts/preprocess_mmsdata.py, with the same command line):
preprocess_custom_dataset.py's pipeline with the MMS-DATA conventions
fixed: the five modalities with the capture rig's mosaick patterns
(MMS_MOSAICK_PATTERNS, passed through a temporary JSON file that is
removed afterwards), a per-modality calibration (the camera2reference
chain), the ArUco scale from the 36 mm markers, and the reorientation by
the checkerboard planes.

A host tool with no device, as preprocess_custom_dataset.py is: it needs
the `colmap` binary and OpenCV, which the card's machine lacks.

    python -m multimodalstudio_tpu_torch.scripts.preprocess_mmsdata --input <capture_dir> \\
        --output scenes/<scene> --calibration <calibration.json> [--undistort]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from multimodalstudio_tpu_torch.scripts.preprocess_custom_dataset import main as custom_main

MMS_MODALITIES = ["rgb", "infrared", "mono", "polarization", "multispectral"]

# The capture rig's patterns. The multispectral one maps each 3 x 3 mosaic
# position to its wavelength-sorted band, the inverse of the SILIOS sort
# [5, 4, 3, 6, 0, 1, 2, 8, 7] that demosaicking applies.
MMS_MOSAICK_PATTERNS = {
    "rgb": [[1, 2], [0, 1]],
    "polarization": [[2, 1], [3, 0]],
    "multispectral": [[4, 5, 6], [2, 1, 0], [3, 8, 7]],
    "infrared": [[0]],
    "mono": [[0]],
}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--calibration", required=True)
    parser.add_argument("--undistort", action="store_true")
    parser.add_argument("--mosaicked", action="store_true")
    parser.add_argument("--scale", type=float, default=1.0)
    args = parser.parse_args(argv)

    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as pat_file:
        json.dump(MMS_MOSAICK_PATTERNS, pat_file)
        pat_path = pat_file.name

    forwarded = [
        "--input", args.input,
        "--output", args.output,
        "--calibration", args.calibration,
        "--modalities", *MMS_MODALITIES,
        "--scale", str(args.scale),
        "--aruco_size", "0.036",
        "--reorient_axis",
        "--mosaick_patterns_json", pat_path,
    ]
    if args.undistort:
        forwarded.append("--undistort")
    if args.mosaicked:
        forwarded.append("--mosaicked")
    try:
        custom_main(forwarded)
    finally:
        os.unlink(pat_path)


if __name__ == "__main__":
    main()
