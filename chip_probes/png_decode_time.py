"""Host seconds for utils/images.py::read_png to decode a 2048 x 2048 16-bit
greyscale PNG written by OpenCV (libpng picks each row's filter), against
cv2.imread of the same file. Needs OpenCV; runs on any host, no card:

    python3 chip_probes/png_decode_time.py [REPEATS]
"""
import os
import platform
import sys
import tempfile
import time

import cv2
import numpy as np

sys.path.insert(0, ".")
from multimodalstudio_tpu_torch.utils.images import read_png  # noqa: E402

repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 3
rng = np.random.default_rng(0)
y, x = np.mgrid[0:2048, 0:2048]
img = (20000 + 9000 * np.sin(x / 97.0) * np.cos(y / 61.0)
       + rng.normal(scale=300.0, size=x.shape)).clip(0, 65535).astype(np.uint16)
with tempfile.TemporaryDirectory() as root:
    path = os.path.join(root, "frame.png")
    cv2.imwrite(path, img)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    times, cv_times = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        got = read_png(path)
        times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        cv2.imread(path, cv2.IMREAD_UNCHANGED)
        cv_times.append(time.perf_counter() - t0)
    assert np.array_equal(got, ref)
    print(f"read_png 2048 x 2048 uint16 grey: median {np.median(times):.3f} s of {repeats} "
          f"(cv2.imread {np.median(cv_times):.4f} s), equal to cv2's; host {platform.node()} "
          f"{platform.processor() or platform.machine()}, {os.cpu_count()} CPUs")
