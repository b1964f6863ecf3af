"""Carry parameters from the JAX package's params tree to the port.

The reference's params are nested dicts of arrays,
{"model": {...flax tree...}, "camera_poses": {modality: [K, 6]}}. The
port's module tree mirrors the flax tree (kernels stored [in, out], biases,
weight-norm gains `g`, the slot table [total_rows, 128], the variance `s`),
so each leaf maps to the state-dict key of its dotted path.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from multimodalstudio_tpu_torch.models.model import MMSModel


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out: Dict[str, np.ndarray] = {}
        for key, value in tree.items():
            out.update(_flatten(value, f"{prefix}{key}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def params_from_jax(tree: Dict[str, Any], model: MMSModel) -> Dict[str, Any]:
    """The port's state for `model` from the reference's params tree:
    {"model": state dict, "camera_poses": {modality: [K, 6] tensor}}, on the
    model's device. Raises on a missing or extra key or a shape mismatch;
    load the result with `model.load_state_dict(state["model"])`."""
    if set(tree) != {"model", "camera_poses"}:
        raise KeyError(f"params tree has keys {sorted(tree)}, expected ['camera_poses', 'model']")
    flat = _flatten(tree["model"])
    expected = model.state_dict()
    missing = sorted(set(expected) - set(flat))
    extra = sorted(set(flat) - set(expected))
    if missing or extra:
        raise KeyError(f"params tree mismatch: missing {missing}, extra {extra}")
    state = {}
    for key, ref in expected.items():
        value = flat[key]
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: shape {value.shape} != {tuple(ref.shape)}")
        state[key] = torch.tensor(value, dtype=torch.float32, device=ref.device)
    poses = {
        mod: torch.tensor(np.asarray(v), dtype=torch.float32, device=model.device)
        for mod, v in tree["camera_poses"].items()
    }
    return {"model": state, "camera_poses": poses}
