"""LPIPS, the perceptual metric of the paper's tables, AlexNet variant (JAX
reference: utils/lpips_jax.py; Zhang et al., CVPR 2018).

The input scaling layer, AlexNet's five conv stages (max-pooling 3x3/2
after the first two), each stage's features unit-normalised over channels,
non-negative 1x1 heads on the squared differences, the spatial mean, and
the sum over stages. The convolutions are `F.conv2d` in float32 with TF32
off (`device.set_reference_precision`).

Weights: `lpips_weights.npz` beside this module (HWIO kernels, as
scripts/vendor_lpips_weights.py writes them for the JAX package: the same
file serves both), the trained metric; else a deterministic random-init
fallback equal to JAX's bit for bit (np.random.RandomState(0), He-normal
kernels, uniform heads), comparable within one table but not with trained
LPIPS values. Every consumer reports `weight_source()`. Nothing is
downloaded.

Inputs: NHWC (or HWC) arrays in [-1, 1] with 3 channels, H, W >= 32;
`lpips` returns one value per image.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from multimodalstudio_tpu_torch.device import resolve_device, set_reference_precision

# (out_ch, kernel, stride, pad) per AlexNet conv stage (torchvision's features layout)
ALEX = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1))
POOL_AFTER = (0, 1)  # a 3x3/2 max-pool follows these stages
# the scaling layer's constants (lpips_jax.py:53-54): ImageNet statistics on [-1, 1] RGB
SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)

WEIGHTS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lpips_weights.npz")


def rand_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """The untrained fallback (lpips_jax.py:59-78): He-normal HWIO kernels
    drawn in stage order from np.random.RandomState(seed), zero biases,
    heads 1 / C."""
    rng = np.random.RandomState(seed)
    params = {"source": "randinit"}
    c_in = 3
    for i, (c_out, k, _, _) in enumerate(ALEX):
        fan_in = c_in * k * k
        params[f"conv{i}_w"] = (rng.standard_normal((k, k, c_in, c_out))
                                * np.sqrt(2.0 / fan_in)).astype(np.float32)
        params[f"conv{i}_b"] = np.zeros((c_out,), np.float32)
        params[f"lin{i}_w"] = np.full((c_out,), 1.0 / c_out, np.float32)
        c_in = c_out
    return params


@functools.lru_cache(maxsize=4)
def load_params(path: Optional[str] = None) -> Dict[str, np.ndarray]:
    """The vendored weights at `path` (default: WEIGHTS_FILE), labelled
    "trained", where the file exists; else `rand_params()`."""
    path = path or WEIGHTS_FILE
    if os.path.exists(path):
        with np.load(path) as z:
            params = {k: z[k] for k in z.files}
        params["source"] = "trained"
        return params
    return rand_params()


def weight_source(path: Optional[str] = None) -> str:
    """"trained" (vendored weights) or "randinit" (the fallback)."""
    return load_params(path)["source"]


def _stages(params: Dict[str, np.ndarray], device):
    """Each stage's (OIHW kernel, bias, non-negative head) on `device`."""
    out = []
    for i in range(len(ALEX)):
        w = torch.as_tensor(np.asarray(params[f"conv{i}_w"], np.float32), device=device)
        out.append((w.permute(3, 2, 0, 1).contiguous(),
                    torch.as_tensor(np.asarray(params[f"conv{i}_b"], np.float32), device=device),
                    torch.as_tensor(np.asarray(params[f"lin{i}_w"], np.float32),
                                    device=device).clamp_min(0.0)))
    return out


def _features(stages, x: torch.Tensor):
    """Each stage's ReLU features, NCHW, of NCHW input in [-1, 1]."""
    shift = torch.as_tensor(SHIFT, device=x.device)[None, :, None, None]
    scale = torch.as_tensor(SCALE, device=x.device)[None, :, None, None]
    x = (x - shift) / scale
    feats = []
    for i, ((w, b, _), (_, _, stride, pad)) in enumerate(zip(stages, ALEX)):
        x = F.relu(F.conv2d(x, w, b, stride=stride, padding=pad))
        feats.append(x)
        if i in POOL_AFTER:
            x = F.max_pool2d(x, kernel_size=3, stride=2)
    return feats


def _unit_normalize(f: torch.Tensor) -> torch.Tensor:
    return f * torch.rsqrt((f * f).sum(dim=1, keepdim=True) + 1e-10)


@torch.no_grad()
def lpips(x0, x1, params: Optional[Dict[str, np.ndarray]] = None, device="cuda") -> torch.Tensor:
    """LPIPS distance per image of x0, x1 ([N, H, W, 3] or [H, W, 3] in
    [-1, 1], numpy or tensors) on `device`: a [N] float32 tensor."""
    dev = resolve_device(device)
    set_reference_precision()
    if params is None:
        params = load_params()
    x0 = torch.as_tensor(np.asarray(x0, np.float32) if not torch.is_tensor(x0) else x0,
                         dtype=torch.float32, device=dev)
    x1 = torch.as_tensor(np.asarray(x1, np.float32) if not torch.is_tensor(x1) else x1,
                         dtype=torch.float32, device=dev)
    if x0.ndim == 3:
        x0, x1 = x0[None], x1[None]
    stages = _stages(params, dev)
    f0 = _features(stages, x0.permute(0, 3, 1, 2))
    f1 = _features(stages, x1.permute(0, 3, 1, 2))
    total = torch.zeros(x0.shape[0], dtype=torch.float32, device=dev)
    for (_, _, head), a, b in zip(stages, f0, f1):
        d = _unit_normalize(a) - _unit_normalize(b)
        total = total + (d * d * head[None, :, None, None]).sum(dim=1).mean(dim=(1, 2))
    return total
