"""The port's paper-metric script (multimodalstudio_tpu_torch/scripts/
evaluate_average_metrics.py) against the JAX package's
(scripts/evaluate_average_metrics.py), on the setup of
tests/test_integration.py's paper-metric test: a 32 x 32 synthetic scene
written by the JAX package's writer, seeded random renders of two views
(rgb and mono) and full accumulation PNGs written by OpenCV, at
rendering_scale 1.0; once raw (the three regimes of a mosaicked frame:
the rgb Bayer demosaicking, mono's identity) and once demosaicked
(full-channel frames). Both JSON files must hold the same keys, PSNR
within 1e-4 dB, SSIM within 1e-5 and LPIPS within rel 1e-5, every value
finite, and the same LPIPS weight source. The port reads its PNGs without
OpenCV and runs on the CPU here."""

import importlib.util
import json
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from multimodalstudio_tpu.data.synthetic import write_synthetic_scene

from multimodalstudio_tpu_torch.scripts import evaluate_average_metrics as port_script

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MODS = ("rgb", "mono")
CHANNELS = {"rgb": 3, "mono": 1}


def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_evaluate_average_metrics", REPO / "scripts" / "evaluate_average_metrics.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax(argv):
    saved = sys.argv
    sys.argv = ["evaluate_average_metrics.py", *argv]
    try:
        jax_script().main()
    finally:
        sys.argv = saved


@pytest.fixture(scope="module", params=[True, False], ids=["raw", "demosaicked"])
def scored(request, tmp_path_factory):
    raw = request.param
    root = tmp_path_factory.mktemp("raw" if raw else "demosaicked")
    scene = write_synthetic_scene(str(root / "scene"), modalities=MODS, num_views=3,
                                  height=32, width=32, raw=raw)
    rng = np.random.default_rng(0)
    for mod in MODS:
        renders = root / "renders" / mod
        renders.mkdir(parents=True)
        for vi in range(2):
            np.save(renders / f"{vi:04d}_render.npy",
                    rng.random((32, 32, CHANNELS[mod]), dtype=np.float32))
            cv2.imwrite(str(renders / f"{vi:04d}_accumulation.png"),
                        np.full((32, 32), 65535, np.uint16))
    argv = ["--renders", str(root / "renders"), "--scene", scene, "--modalities", *MODS,
            "--views", "0", "1", "--rendering_scale", "1.0"]
    run_jax([*argv, "--out", str(root / "jax.json")])
    port_script.main([*argv, "--out", str(root / "port.json"), "--device", "cpu"])
    return (json.loads((root / "jax.json").read_text()),
            json.loads((root / "port.json").read_text()), raw)


def test_both_scripts_write_the_same_json(scored):
    ref, got, raw = scored
    assert set(got) == set(ref) == set(MODS) | {"lpips_weights"}
    assert got["lpips_weights"] == ref["lpips_weights"] in ("trained", "randinit")
    for mod in MODS:
        assert set(got[mod]) == set(ref[mod]), mod
        for key, value in ref[mod].items():
            assert np.isfinite(got[mod][key]), (mod, key)
            if key.startswith("psnr"):
                assert abs(got[mod][key] - value) <= 1e-4, (mod, key, got[mod][key], value)
            elif key.startswith("ssim"):
                assert abs(got[mod][key] - value) <= 1e-5, (mod, key, got[mod][key], value)
            else:
                assert abs(got[mod][key] - value) <= 1e-5 * abs(value), (mod, key)


def test_every_regime_is_scored(scored):
    ref, got, raw = scored
    for regime in ("mosaicked", "demosaicked", "rendered_demosaicked"):
        for metric in ("psnr", "ssim", "lpips"):
            assert f"{metric}_{regime}" in got["rgb"], (regime, metric)
    # the regimes measure different things
    if raw:
        assert got["rgb"]["psnr_mosaicked"] != got["rgb"]["psnr_rendered_demosaicked"]
