"""Checkpoints (JAX reference: engine/checkpoints.py): one torch file per
save, `step-%09d.pt`, and auto-resume from the newest.

A file holds plain tensors and ints, so `torch.load(..., weights_only=True)`
reads it:

    {"params": {"model": state dict, "camera_poses": {modality: [K, 6]}},
     "opt_state": {"count": int, "mu": {...}, "nu": {...}},
     "step": int}

with the moments keyed like `engine/train.py::train_params`. A *weights
file* carries no "opt_state": loading it restores params and step and
leaves `state.opt_state` None, which is enough to evaluate; training from
it raises (`engine/trainer.py`). The port keeps the model's parameters in
the module itself, so saving and loading take the model beside the state.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from multimodalstudio_tpu_torch.engine.train import OptState, TrainState
from multimodalstudio_tpu_torch.models.model import MMSModel

_CKPT_RE = re.compile(r"step-(\d+)\.pt")


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step-{step:09d}.pt")


def checkpoint_dict(model: MMSModel, state: TrainState) -> Dict[str, Any]:
    """What `save_checkpoint` writes, on the host; without "opt_state" when
    the state has none."""
    out: Dict[str, Any] = {
        "params": {
            "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "camera_poses": {m: p.detach().cpu() for m, p in state.camera_poses.items()},
        },
        "step": int(state.step),
    }
    if state.opt_state is not None:
        opt = state.opt_state
        out["opt_state"] = {
            "count": int(opt.count),
            **{name: {g: {k: v.detach().cpu() for k, v in group.items()}
                      for g, group in getattr(opt, name).items()} for name in ("mu", "nu")},
        }
    return out


def save_checkpoint(ckpt_dir: str, model: MMSModel, state: TrainState,
                    keep_only_latest: bool = True) -> str:
    """Write step-%09d.pt; with keep_only_latest, remove every other step's
    file (checkpoints.py:28-49)."""
    step = int(state.step)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, step)
    tmp = path + ".tmp"
    torch.save(checkpoint_dict(model, state), tmp)
    os.replace(tmp, path)
    if keep_only_latest:
        for name in os.listdir(ckpt_dir):
            m = _CKPT_RE.fullmatch(name)
            if m and int(m.group(1)) != step:
                os.remove(os.path.join(ckpt_dir, name))
    return path


def latest_checkpoint_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(ckpt_dir) if (m := _CKPT_RE.fullmatch(name))]
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, model: MMSModel, state: TrainState,
                    step: Optional[int] = None) -> Tuple[TrainState, int]:
    """Restore the newest (or the given) step into `model` and `state`, on
    the model's device (checkpoints.py:64-91). Returns (state, next_step);
    with no checkpoint, (state, 0) unchanged. A weights file sets
    state.opt_state to None."""
    step = step if step is not None else latest_checkpoint_step(ckpt_dir)
    if step is None:
        return state, 0
    path = checkpoint_path(ckpt_dir, step)
    dev = model.device
    ckpt = torch.load(path, map_location=dev, weights_only=True)
    model.load_state_dict(ckpt["params"]["model"])
    poses = {m: p.float().to(dev).requires_grad_(True)
             for m, p in ckpt["params"]["camera_poses"].items()}
    opt = ckpt.get("opt_state")
    opt_state = None
    if opt is not None:
        opt_state = OptState(count=int(opt["count"]), mu=opt["mu"], nu=opt["nu"])
    state = TrainState(camera_poses=poses, step=int(ckpt["step"]), opt_state=opt_state)
    return state, int(ckpt["step"]) + 1
