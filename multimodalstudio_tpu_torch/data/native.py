"""The native host data path (JAX reference: data/native.py and
native/mms_native.cpp): threaded uniform pixel-batch sampling in C++
(`csrc/mms_native.cpp`).

The library is built with the host's C++ compiler at first use into
`build/torch_native/` at the repository root, named by a hash of its
source and flags (written to a temporary file, then renamed, so that
processes building at once do not collide), and loaded with ctypes. A
failed build raises. The numpy version (`plain=True`) is the plain
version: taken only when the caller asks for it. Equal (seed, threads)
draw the JAX package's extension's bytes; `threads` 0 means one a CPU core,
as there, so a caller that wants the same batch from a seed on every host
names its thread count (data/sampler.py::THREADS).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "mms_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
FLAGS = ["-O3", "-std=c++17", "-pthread", "-shared", "-fPIC"]  # native/setup.py's, as a library

_lib: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++", "clang++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no C++ compiler found (CXX, c++, g++ or clang++) to build "
                       f"{SOURCE.name}")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libmms_native-{h}.so"


def build() -> Path:
    """Build the library unless it is built; returns its path."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        out = subprocess.run([_compiler(), *FLAGS, "-o", tmp, str(SOURCE)], capture_output=True,
                             text=True)
        if out.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed (exit {out.returncode}):\n"
                               f"{out.stderr}{out.stdout}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i64, u64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64
        lib.mms_sample_pixels.argtypes = [p, i64, i64, i64, i64, p, i64, u64, ctypes.c_int,
                                          ctypes.c_double, p, p, p, p]
        lib.mms_sample_pixels.restype = None
        _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _threads(threads: int) -> int:
    return threads or (os.cpu_count() or 1)


def sample_pixels(images: np.ndarray, mosaick_mask: Optional[np.ndarray], n: int, seed: int,
                  pixel_offset: float = 0.5, threads: int = 0, plain: bool = False):
    """Uniform (frame, y, x) draws and their pixels from a [F, H, W, C]
    frame stack: (frame_idx [n] int32, coords [n, 2] float32, pixels
    [n, C] float32, channels [n] int32). `plain` takes the numpy version
    (one numpy generator of `seed`)."""
    if plain:
        rng = np.random.default_rng(seed)
        f, h, w, _ = images.shape
        fi = rng.integers(0, f, n).astype(np.int32)
        yi = rng.integers(0, h, n)
        xi = rng.integers(0, w, n)
        coords = np.stack([yi, xi], -1).astype(np.float32) + pixel_offset
        pixels = images[fi, yi, xi]
        chan = (mosaick_mask[yi, xi].astype(np.int32) if mosaick_mask is not None
                else np.zeros(n, np.int32))
        return fi, coords, pixels, chan
    lib = load()
    img = np.ascontiguousarray(images, np.float32)
    if img.ndim != 4:
        raise ValueError(f"images must be [F, H, W, C], not {img.shape}")
    f, h, w, c = img.shape
    mask = None if mosaick_mask is None else np.ascontiguousarray(mosaick_mask, np.int8)
    if mask is not None and mask.shape != (h, w):
        raise ValueError(f"the mosaick mask must be [{h}, {w}], not {mask.shape}")
    fi = np.empty(n, np.int32)
    coords = np.empty((n, 2), np.float32)
    pixels = np.empty((n, c), np.float32)
    chan = np.empty(n, np.int32)
    lib.mms_sample_pixels(_ptr(img), f, h, w, c, None if mask is None else _ptr(mask), int(n),
                          int(seed) % (1 << 64), _threads(threads), float(pixel_offset),
                          _ptr(fi), _ptr(coords), _ptr(pixels), _ptr(chan))
    return fi, coords, pixels, chan

