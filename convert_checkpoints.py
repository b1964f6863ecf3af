"""Convert the JAX package's orbax checkpoints into the PyTorch port's
torch checkpoints (multimodalstudio_tpu_torch/engine/checkpoints.py).

    JAX_PLATFORMS=cpu python convert_checkpoints.py                 # every run of rehearsals.py
    JAX_PLATFORMS=cpu python convert_checkpoints.py rehearsal_grid_dense --with-opt-state

Runs on the CPU. For each run it builds the JAX config (load_config on the
run's confs/*.yaml with the run's grid overrides, the channels bound as
launcher.resolve_model_channels binds them) and first checks that
config_to_string of it prints the run's committed config.yaml, apart from
the lines LINES_ADDED lists with a reason. It then restores the orbax
checkpoint into init_train_state's template (num_cameras: the train split
of the 36-view scene, 29 views a modality) with JAX's
engine/checkpoints.py, maps the params through convert.params_from_jax
(and, with --with-opt-state, optax's state through
convert.opt_state_from_jax), and writes checkpoints/step-XXXXXXXXX.pt
beside the orbax directory. Without --with-opt-state the file is a
weights file: params and step, enough to evaluate.

This is the only module of the repo that imports both packages; the port
and chip_smoke.py never import it.
"""

from __future__ import annotations

import argparse
import dataclasses
import difflib
import os
import sys

import numpy as np
import torch

from rehearsals import REHEARSALS, rehearsal_config

# lines a run's JAX config prints today that its committed config.yaml lacks, with the reason
LINES_ADDED = {
    "rehearsal_grid_dense": {
        "            curvature_taps: 2": "a field added to GeometryLossSpec after that run; "
                                         "only training reads it",
    },
}
# the train split of the rehearsals' scene, synthetic_raw:views=36,size=256 (launcher.py:49-56)
TRAIN_VIEWS = sum(1 for i in range(36) if i % 5 != 4)


class _Channels:
    """What launcher.resolve_model_channels reads of a dataset."""

    def __init__(self, modalities):
        from multimodalstudio_tpu.configs.methods import MODALITY_CHANNELS

        self.channels_per_modality = {m: MODALITY_CHANNELS[m] for m in modalities}


def jax_config(name: str):
    """The JAX TrainerConfig of a rehearsal run, channels bound."""
    from multimodalstudio_tpu.configs.config import load_config
    from multimodalstudio_tpu.launcher import resolve_model_channels

    r = REHEARSALS[name]
    cfg = load_config(r["conf"], overrides=r["grid"])
    return resolve_model_channels(cfg, _Channels(cfg.modalities))


def config_diff(name: str, printed: str):
    """(lines of `printed` that the run's config.yaml lacks, lines it has
    that `printed` lacks), LINES_ADDED's lines left out."""
    with open(os.path.join(REHEARSALS[name]["run"], "config.yaml")) as f:
        committed = f.read().splitlines()
    added, removed = [], []
    for line in difflib.unified_diff(committed, printed.splitlines(), lineterm="", n=0):
        if line.startswith(("---", "+++", "@@")):
            continue
        if line.startswith("+") and line[1:] not in LINES_ADDED.get(name, {}):
            added.append(line[1:])
        elif line.startswith("-"):
            removed.append(line[1:])
    return added, removed


def check_config(name: str, cfg) -> None:
    from multimodalstudio_tpu.configs.config import config_to_string

    added, removed = config_diff(name, config_to_string(cfg))
    if added or removed:
        raise ValueError(f"{name}: the JAX config does not print the run's config.yaml: "
                         f"+{added} -{removed}")


def restore(name: str, cfg=None):
    """The JAX TrainState of the run's checkpoint, restored with orbax into
    init_train_state's template."""
    import jax

    from multimodalstudio_tpu.engine import checkpoints
    from multimodalstudio_tpu.engine.train import init_train_state
    from multimodalstudio_tpu.models.model import MMSModel

    r = REHEARSALS[name]
    cfg = cfg or jax_config(name)
    # the template's values are overwritten: built as one compiled program, not op by op
    model = MMSModel(cfg.model)
    template = jax.jit(lambda key: init_train_state(
        cfg, model, key, {m: TRAIN_VIEWS for m in cfg.modalities}))(jax.random.key(0))
    state, _ = checkpoints.load_checkpoint(os.path.join(r["run"], "checkpoints"), template,
                                           r["step"])
    return state


def port_model(name: str):
    """The port's model of the run, on the CPU (rehearsals.rehearsal_config)."""
    from multimodalstudio_tpu_torch.configs.methods import MODALITY_CHANNELS
    from multimodalstudio_tpu_torch.models.model import MMSModel

    cfg = rehearsal_config(name)
    model_spec = dataclasses.replace(
        cfg.model, modalities=tuple((m, MODALITY_CHANNELS[m]) for m in cfg.modalities))
    return MMSModel(model_spec, device="cpu")


def convert_state(state, model, with_opt_state: bool):
    """The port's checkpoint dict of a JAX TrainState (numpy trees only go
    through convert.py)."""
    import jax

    from multimodalstudio_tpu_torch.convert import opt_state_from_jax, params_from_jax

    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    params = params_from_jax(to_np(state.params), model)
    out = {"params": params, "step": int(state.step)}
    if with_opt_state:
        out["opt_state"] = opt_state_from_jax(to_np(state.opt_state), model)
    return out


def convert(name: str, with_opt_state: bool = False) -> str:
    cfg = jax_config(name)
    check_config(name, cfg)
    state = restore(name, cfg)
    ckpt = convert_state(state, port_model(name), with_opt_state)
    path = os.path.join(REHEARSALS[name]["run"], "checkpoints", f"step-{ckpt['step']:09d}.pt")
    torch.save(ckpt, path)
    return path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("runs", nargs="*", default=list(REHEARSALS), help="names in rehearsals.REHEARSALS")
    parser.add_argument("--with-opt-state", action="store_true",
                        help="also carry the optimizer state (a whole checkpoint)")
    args = parser.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    for name in args.runs:
        path = convert(name, args.with_opt_state)
        print(f"{name}: {path} ({os.path.getsize(path) / 1e6:.2f} MB)")


if __name__ == "__main__":
    sys.exit(main())
