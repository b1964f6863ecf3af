"""Build and load the port's CUDA kernels.

Each library under `csrc/` is built from one or more .cu sources with a
plain C interface (fused_chain: K1 forward and backward, the weight pack
and chain_wgrad; fused_mlp: K1t, the chain with forward tangents, forward
(tangent_fwd.cu) and backward, and K4j, the tangent kernels with the
encoding in front; slot_value: K2 forward; slot_chain_bwd: the backward
pass of K3 and, in its value mode, K2, merged and split; slot_split: the
split backward's table scatter; the slot kernels each for a bf16 and an f32
table (K2f/K3f); sdf_chain: the adjoint forwards of K3, K4 and K5
(adj_fwd.cu) and the backwards of K4 and K5; slot_grid: K6 forward and
backward; every chain kernel on K1's wgmma building blocks, k1.cuh),
compiled by nvcc for sm_90a into `build/torch_kernels/` at the repository
root and loaded with ctypes. The library name carries a hash of every file
in `csrc/`, so an edited source rebuilds and a stale library is never
loaded. `build_all()` starts one nvcc per library at once (the first
import of a kernel builds only its own library).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
LIBRARIES = (
    "fused_chain", "fused_mlp", "slot_value", "slot_split", "slot_chain_bwd", "sdf_chain",
    "slot_grid",
)
# Libraries built from more than one source: each source compiles on its own
# (nvcc -c, at once with every other library's), then the objects link into
# the library. A heavy width class (csrc/k1.cuh WC_DEV) compiles this way
# beside the rest of its library.
PARTS = {"sdf_chain": ("sdf_chain", "sdf_chain_dev", "adj_fwd", "adj_fwd_dev"),
         "fused_mlp": ("fused_mlp", "tangent_fwd")}
MAX_LAYERS = 32  # layers of a chain a kernel takes (csrc/k1.cuh MAXL)
MAX_LEVELS = 32  # grid levels a slot kernel takes (csrc/slot.cuh MAXLV)
ERR_SMEM = -2  # entry point status: the tile needs more shared memory than a CTA has
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no multiply-add contraction: the kernels reproduce the reference's
    # float32 rounding points (and no fast math: sinf/cosf stay accurate)
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


@dataclasses.dataclass
class KernelInfo:
    """A CUDA kernel's identity and its launch count on the current run."""

    name: str
    source: str  # path in the repository
    replaces: str  # file:line of the Pallas TPU kernel
    launches: int = 0


KERNELS: Dict[str, KernelInfo] = {}


def register(name: str, source: str, replaces: str) -> KernelInfo:
    info = KernelInfo(name, source, replaces)
    KERNELS[name] = info
    return info


def reset_launch_counts() -> None:
    for info in KERNELS.values():
        info.launches = 0


def _sources_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_sources_hash()}.so"


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine with the CUDA toolkit")


def _tmp(suffix: str) -> str:
    fd, tmp = tempfile.mkstemp(suffix=suffix, dir=BUILD_DIR)
    os.close(fd)
    return tmp


def _start(name: str):
    """Start nvcc for one library (one process per source); returns
    (processes, their objects or None, tmp path, target) or None when the
    library is already built."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp, parts = _tmp(".so"), PARTS.get(name, (name,))
    if len(parts) == 1:
        cmds, objs = [[_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]], None
    else:
        flags = [f for f in NVCC_FLAGS if f != "-shared"]
        objs = [_tmp(".o") for _ in parts]
        cmds = [[_nvcc(), *flags, "-c", "-o", o, str(CSRC / f"{p}.cu")] for p, o in zip(parts, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    return procs, objs, tmp, target


BUILD_SECONDS: Dict[str, float] = {}  # seconds from the start of build_all to each library's end


def _finish(name: str, started, t0: float) -> None:
    procs, objs, tmp, target = started
    report, failed = [], []
    for proc in procs:
        out, err = proc.communicate()
        report.append(err)
        if proc.returncode != 0:
            failed.append(f"exit {proc.returncode}:\n{err}{out}")
    if not failed and objs:
        link = subprocess.run([_nvcc(), NVCC_FLAGS[0], NVCC_FLAGS[1], "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(f"link exit {link.returncode}:\n{link.stderr}{link.stdout}")
    for o in objs or ():
        os.unlink(o)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    if failed:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name} ({'; '.join(failed)})")
    target.with_suffix(".ptxas.txt").write_text("".join(report))
    os.replace(tmp, target)


def build_all() -> float:
    """Build every library in parallel (one nvcc per source); returns seconds."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in LIBRARIES}
    errors = []
    for n, s in started.items():
        if s is not None:
            try:
                _finish(n, s, t0)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


_LOADED: Dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of one library, built first if needed."""
    if name not in _LOADED:
        started = _start(name)
        if started is not None:
            _finish(name, started, time.perf_counter())
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return _LOADED[name]


_CTYPES = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}


def function(library: str, name: str, *argtypes: str, restype=ctypes.c_int):
    """A C entry point of one library with its argument types declared
    ("ptr", "int" or "float" each); launch entry points return cudaError_t."""
    fn = getattr(load(library), name)
    fn.argtypes = [_CTYPES[t] for t in argtypes]
    fn.restype = restype
    return fn


def check_layers(n_layers: int, what: str) -> None:
    """Raise for a chain deeper than the kernels' parameter structs hold."""
    if n_layers > MAX_LAYERS:
        raise ValueError(f"{what}: at most {MAX_LAYERS} layers (csrc/k1.cuh MAXL)")


def check(status: int, what: str) -> None:
    """Raise on a non-zero status returned by a launch: a cudaError_t, or -1
    (arguments the kernel does not take) or ERR_SMEM."""
    if status == ERR_SMEM:
        raise ValueError(f"{what}: the 64-row tile's buffers need more than the 232,448 bytes "
                         "of shared memory a CTA has")
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with status {status}")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer, or a null pointer for None (an optional
    operand)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def int_array(vals) -> ctypes.Array:
    vals = [int(v) for v in vals]
    return (ctypes.c_int * max(len(vals), 1))(*vals)


def float_array(vals) -> ctypes.Array:
    vals = [float(v) for v in vals]
    return (ctypes.c_float * max(len(vals), 1))(*vals)
