"""Build and load the port's CUDA kernels.

Each library under `csrc/` is one .cu source with a plain C interface
(fused_chain: K1 forward and backward, the weight pack and chain_wgrad, on
wgmma; fused_mlp: K1t, the chain with forward tangents, forward and
backward, and K4j, the tangent kernels with the encoding in front;
slot_value: K2 forward, on K1's wgmma forward; slot_fused: K3 forward;
slot_fused_bwd: K2/K3 merged backward; slot_split: K2s/K3s per-sample passes
and the table scatter of the split backward, the slot kernels each for a bf16
and an f32 table (K2f/K3f); sdf_chain: K4 and K5 forward and
backward; slot_grid: K6 forward and backward),
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
    "fused_chain", "fused_mlp", "slot_value", "slot_fused", "slot_fused_bwd", "slot_split",
    "sdf_chain", "slot_grid",
)
TILE_M = 64  # samples per CTA tile of every kernel (csrc/chain.cuh)
MAX_LAYERS = 32  # layers of a chain a kernel takes (csrc/chain.cuh MAXL)
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


def _start(name: str):
    """Start nvcc for one library; returns (process, tmp path, target) or None
    when the library is already built."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    proc, tmp, target = started
    out, err = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n{err}{out}")
    target.with_suffix(".ptxas.txt").write_text(err)
    os.replace(tmp, target)


def build_all() -> float:
    """Build every library in parallel (one nvcc each); returns seconds."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in LIBRARIES}
    errors = []
    for n, s in started.items():
        if s is not None:
            try:
                _finish(n, s)
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
            _finish(name, started)
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


def persistent_scratch(library: str, slab_fn: str, slab_args, dev: torch.device, n: int):
    """(scratch, max_ctas) for a persistent kernel: one bf16 slab per CTA,
    slab_fn(*slab_args) elements each, for at most two CTAs per SM and one
    per 64-sample tile of n."""
    slab = function(library, slab_fn, *["int"] * len(slab_args), restype=ctypes.c_longlong)
    ctas = max(1, min(-(-n // TILE_M), 2 * torch.cuda.get_device_properties(dev).multi_processor_count))
    scratch = torch.empty(ctas * int(slab(*slab_args)), dtype=torch.bfloat16, device=dev)
    return scratch, ctas


def check_layers(n_layers: int, what: str) -> None:
    """Raise for a chain deeper than the kernels' parameter structs hold."""
    if n_layers > MAX_LAYERS:
        raise ValueError(f"{what}: at most {MAX_LAYERS} layers (csrc/chain.cuh MAXL)")


def check(status: int, what: str) -> None:
    """Raise on a non-zero status returned by a launch: a cudaError_t, or -1
    (arguments the kernel does not take) or ERR_SMEM."""
    if status == ERR_SMEM:
        raise ValueError(f"{what}: the 64-sample tile's buffers need more than the 232,448 bytes "
                         "of shared memory a CTA has (too wide a chain, or too many grid levels)")
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
