"""Carry parameters and optimizer state from the JAX package's trees to
the port.

The reference's params are nested dicts of arrays,
{"model": {...flax tree...}, "camera_poses": {modality: [K, 6]}}. The
port's module tree mirrors the flax tree (kernels stored [in, out], biases,
weight-norm gains `g`, the slot table [total_rows, 128], the variance `s`),
so each leaf maps to the state-dict key of its dotted path.

Both functions read numpy trees (dicts, tuples and named tuples of
arrays, as an orbax restore returns them); nothing here imports JAX.
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


def _has(node: Any, name: str) -> bool:
    return name in node if hasattr(node, "keys") else name in getattr(node, "_fields", ())


def _field(node: Any, name: str) -> Any:
    """node[name] for a mapping, node.name for a named tuple."""
    return node[name] if hasattr(node, "keys") else getattr(node, name)


def _leaves(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """The array leaves of a subtree by dotted path; a masked leaf (optax's
    MaskedNode, which holds no array) is dropped."""
    if hasattr(tree, "keys"):
        out: Dict[str, np.ndarray] = {}
        for key in tree.keys():
            out.update(_leaves(tree[key], f"{prefix}{key}."))
        return out
    return {prefix[:-1]: np.asarray(tree)} if hasattr(tree, "shape") else {}


def opt_state_from_jax(opt_state: Any, model: MMSModel) -> Dict[str, Any]:
    """The port's optimizer state from the reference's optax state
    (engine/train.py:53-98: clip_by_global_norm, then multi_transform of one
    adamw, adam or radam chain per group; each chain's first state holds
    the moments, and adam's and radam's have no add_decayed_weights entry
    after it): {"count": int, "mu": {"fields": {state-dict key:
    tensor}, "camera_poses": {modality: tensor}}, "nu": ...}, on the model's
    device, every leaf carried as float32 bit for bit. optax counts updates
    per group (and again in each group's schedule); the port keeps one
    count, so this raises when those counts differ, and on a missing or
    extra leaf or a shape mismatch."""
    inner = _field(opt_state[1], "inner_states")
    groups = {g: _field(_field(inner, g), "inner_state") for g in ("fields", "camera_poses")}
    counts = {(g, i): int(np.asarray(_field(sub, "count")))
              for g, chain in groups.items() for i, sub in enumerate(chain) if _has(sub, "count")}
    if len(set(counts.values())) != 1:
        raise ValueError(f"optax counts differ across groups or schedules: {counts}; the port "
                         "keeps one count")
    names = dict(model.named_parameters())
    out: Dict[str, Any] = {"count": next(iter(counts.values()))}
    for moment in ("mu", "nu"):
        fields = _leaves(_field(groups["fields"][0], moment)["model"])
        poses = _leaves(_field(groups["camera_poses"][0], moment)["camera_poses"])
        missing = sorted(set(names) - set(fields))
        extra = sorted(set(fields) - set(names))
        if missing or extra:
            raise KeyError(f"{moment} tree mismatch: missing {missing}, extra {extra}")
        state = {}
        for key, ref in names.items():
            if tuple(fields[key].shape) != tuple(ref.shape):
                raise ValueError(f"{moment} {key}: shape {fields[key].shape} != {tuple(ref.shape)}")
            state[key] = torch.tensor(fields[key], dtype=torch.float32, device=ref.device)
        out[moment] = {
            "fields": state,
            "camera_poses": {mod: torch.tensor(v, dtype=torch.float32, device=model.device)
                             for mod, v in poses.items()},
        }
    return out
