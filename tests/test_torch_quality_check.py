"""The quality harness, scripts/quality_check.py, against the JAX repo's:
both build the same config (leaf for leaf, after the scene's channels are
bound) for a few command lines, with each package's Trainer stubbed to
capture it, so nothing trains or compiles (JAX's platform and cache
settings are recorded, not applied). Then a narrow run on the CPU (the
tiny grid_raw_tpu of tests/test_torch_train.py, 0 and 2 steps, its eval
chunks cut to the tiny views) reports JAX's keys, those of the committed
JAX report qc_grid_tpu_r2.json, with finite metrics, and writes the
report to --out.
"""

import dataclasses
import json
import math
import sys
from pathlib import Path

import pytest
import torch

import jax

import multimodalstudio_tpu.engine.trainer as jtrainer
import scripts.quality_check as jqc

import multimodalstudio_tpu_torch.configs.methods as tmethods
import multimodalstudio_tpu_torch.engine.trainer as ttrainer
from multimodalstudio_tpu_torch.scripts import quality_check as tqc

from test_torch_train import TCFG

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SCENE = ["--scene", "synthetic:views=5,size=8"]


class Captured(Exception):
    pass


def capture_trainer(store):
    class Trainer:
        def __init__(self, config, *args, **kwargs):
            store.append(config)
            raise Captured

    return Trainer


@pytest.mark.parametrize("argv", [
    ["--method", "grid_raw_tpu", "--steps", "100", "--modalities", "rgb", "mono"],
    ["--method", "grid_raw_tpu", "--layout", "cell", "--tap-stride", "2", "--grid-rows",
     "1024", "--seed", "3", "--rays", "256", "--steps", "9"],
    ["--method", "grid_raw_tpu", "--layout", "vertex"],
    ["--method", "grid_raw_tpu", "--grid-rows", "2048", "--rays", "2048"],
    ["--method", "mlp_raw_tpu", "--steps", "7", "--rays", "128", "--modalities", "infrared"],
    ["--method", "grid_raw", "--steps", "0", "--tap-stride", "4"],
], ids=["modalities", "every override", "vertex layout", "rows", "mlp",
        "reference method at 0 steps"])
def test_quality_check_builds_jax_config(monkeypatch, argv):
    updates = []
    monkeypatch.setattr(jax.config, "update", lambda *a: updates.append(a))
    configs = []
    monkeypatch.setattr(jtrainer, "Trainer", capture_trainer(configs))
    monkeypatch.setattr(ttrainer, "Trainer", capture_trainer(configs))
    monkeypatch.setattr(sys, "argv", ["quality_check"] + argv + SCENE + ["--cpu"])
    with pytest.raises((Captured, ValueError)) as jraised:
        jqc.main()
    assert ("jax_platforms", "cpu") in updates
    with pytest.raises((Captured, ValueError)) as traised:
        tqc.main(argv + SCENE + ["--cpu"])
    # grid_raw_tpu's packed entries refuse the vertex layout in both packages
    assert traised.type is jraised.type
    assert str(traised.value) == str(jraised.value)
    if traised.type is Captured:
        jcfg, tcfg = configs
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("steps", [0, 2])
def test_quality_check_reports_jax_keys(tmp_path, monkeypatch, steps):
    monkeypatch.setattr(tmethods, "method_configs", lambda: {"grid_raw_tpu": TCFG})
    # the harness's 4096-ray eval chunks, cut to the tiny scene's 16-ray views (a padded
    # chunk took 3 s a view here)
    build = tqc.build_config
    monkeypatch.setattr(tqc, "build_config", lambda args: dataclasses.replace(
        build(args), evaluator=dataclasses.replace(build(args).evaluator,
                                                   eval_num_rays_per_chunk=16)))
    out = tmp_path / "qc.json"
    report = tqc.main(["--method", "grid_raw_tpu", "--steps", str(steps), "--rays", "4",
                       "--scene", "synthetic_raw:views=5,size=8", "--modalities", "rgb", "mono",
                       "--out", str(out), "--cpu"])
    assert json.loads(out.read_text()) == report
    jax_report = json.loads((REPO / "qc_grid_tpu_r2.json").read_text())
    assert report.keys() == jax_report.keys()
    assert report["metrics"].keys() == jax_report["metrics"].keys()
    for mod, vals in report["metrics"].items():
        assert vals.keys() == jax_report["metrics"][mod].keys(), mod
        assert all(math.isfinite(v) for v in vals.values()), (mod, vals)
    assert (report["method"], report["steps"]) == ("grid_raw_tpu", steps)
    assert report["train_seconds"] >= 0 and (report["rays_per_sec"] > 0) == (steps > 0)
