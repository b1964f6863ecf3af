"""The port's evaluator, exports, configs and entry points against the JAX
package, on the CPU.

- RawEvaluator.view_metrics of both packages on the same seeded frames at
  rendering_scale 1.0: the mosaicked, demosaicked and rendered-demosaicked
  PSNR and SSIM within 1e-5; at 0.25 both warn and skip the demosaicked
  regimes.
- export_metrics: the same results.txt text, newest block first, apart
  from the timestamps.
- demosaick_grid (and the edge-aware and modality dispatchers) equal to
  JAX's, np.array_equal.
- extract_mesh on an analytic SDF: identical vertices and faces, and the
  same PLY text; export_poses: the same PLY text.
- export_view: every PNG the port writes (utils/images.py, on zlib and
  struct) decodes with cv2.imread(..., IMREAD_UNCHANGED) to the array JAX's
  cv2.imwrite file decodes to, the depth image's viridis included, and the
  .npy renders are equal; the viridis table against matplotlib's.
- config_to_string of every method the port registers equals JAX's, and
  the three rehearsal configs rehearsals.py builds from dicts print their
  runs' committed config.yaml (apart from convert_checkpoints.LINES_ADDED).
- a tiny run of the port's launcher on the CPU: --mode train for 2 steps
  through the Trainer (the tiny grid_raw_tpu of tests/test_torch_train.py
  registered under the method's name), then --mode eval on the same run,
  resuming at the saved step, and with --view_ids from both splits.
- the device cache's frames, quantised and not, equal to JAX's; the
  profiler's traces and timers; the Trainer's abort on a non-finite loss,
  naming the first bad step of the window.
"""

import dataclasses
import glob
import os
import re
import warnings

import cv2
import numpy as np
import pytest
import torch
from matplotlib import pyplot as plt

import jax.numpy as jnp

import convert_checkpoints as cc
import rehearsals
import multimodalstudio_tpu.configs.config as jconfig
import multimodalstudio_tpu.configs.methods as jmethods
import multimodalstudio_tpu.engine.evaluator as jevaluator
import multimodalstudio_tpu.engine.mesh as jmesh
import multimodalstudio_tpu.models.model as jmodel
import multimodalstudio_tpu.preprocessing.demosaick as jdem
import multimodalstudio_tpu.utils.meshio as jmeshio
from multimodalstudio_tpu.data.synthetic import make_synthetic_dataset as jmake_dataset
from multimodalstudio_tpu.engine.train import TrainState as JTrainState

import multimodalstudio_tpu_torch.configs.config as tconfig
import multimodalstudio_tpu_torch.configs.methods as tmethods
import multimodalstudio_tpu_torch.engine.evaluator as tevaluator
import multimodalstudio_tpu_torch.engine.mesh as tmesh
import multimodalstudio_tpu_torch.preprocessing.demosaick as tdem
import multimodalstudio_tpu_torch.utils.meshio as tmeshio
from multimodalstudio_tpu_torch import launcher
from multimodalstudio_tpu_torch.data.synthetic import make_synthetic_dataset as tmake_dataset
from multimodalstudio_tpu_torch.engine import checkpoints as tckpt
from multimodalstudio_tpu_torch.engine.train import TrainState
from multimodalstudio_tpu_torch.models.model import MMSModel
from multimodalstudio_tpu_torch.utils.images import VIRIDIS, viridis

from test_torch_train import JCFG, MODS, TCFG

torch.set_num_threads(1)

DATA = dict(num_views=3, height=12, width=12, raw=True)


def scaled(cfg, scale):
    return dataclasses.replace(cfg, evaluator=dataclasses.replace(cfg.evaluator,
                                                                  rendering_scale=scale))


def evaluators(scale, out_dirs=(None, None)):
    jds = jmake_dataset(MODS, **DATA)
    tds = tmake_dataset(MODS, **DATA, device="cpu")
    jev = jevaluator.RawEvaluator(scaled(JCFG, scale), jmodel.MMSModel(JCFG.model), jds, jds,
                                  out_dirs[0])
    tev = tevaluator.RawEvaluator(scaled(TCFG, scale), MMSModel(TCFG.model, device="cpu"), tds,
                                  tds, out_dirs[1], device="cpu")
    return jev, tev, jds


def frames_of(jds, mod, seed):
    """Seeded frames of one view as render_view returns them: a rendering
    of every channel, raw GT, the mosaick channel, an accumulation mostly
    over the ROI threshold, normals, depth (zero on a fifth of the pixels),
    DoP, AoP and the camera pose."""
    rng = np.random.default_rng(seed)
    h, w = DATA["height"], DATA["width"]
    c = dict(JCFG.model.modalities)[mod]
    normals = rng.normal(size=(h, w, 3))
    depth = rng.uniform(1.0, 3.0, size=(h, w, 1)) * (rng.random((h, w, 1)) > 0.2)
    return {
        mod: rng.random((h, w, c)).astype(np.float32),
        "gt": rng.random((h, w, 1)).astype(np.float32),
        "mosaick_channel": jds.data[mod].mosaick_mask.astype(np.int32),
        "accumulation": rng.uniform(0.7, 1.0, size=(h, w, 1)).astype(np.float32),
        "normals": (normals / np.linalg.norm(normals, axis=-1, keepdims=True)).astype(np.float32),
        "depth": depth.astype(np.float32),
        "dop": rng.random((h, w, 1)).astype(np.float32),
        "aop": rng.random((h, w, 1)).astype(np.float32),
        "c2w": np.asarray(jds.data[mod].cameras.camera_to_worlds[0]),
    }


@pytest.mark.parametrize("mod", MODS)
def test_view_metrics_match_jax_in_all_three_regimes(mod):
    jev, tev, jds = evaluators(1.0)
    for seed in range(2):
        frames = frames_of(jds, mod, seed)
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # no regime is skipped at scale 1
            jm = jev.view_metrics(frames, mod)
            tm = tev.view_metrics(frames, mod)
        assert set(tm) == set(jm)
        want = {"psnr", "ssim"} | ({f"{m}_{r}" for m in ("psnr", "ssim") for r in (
            "mosaicked", "demosaicked", "rendered_demosaicked")} if mod != "mono" else set())
        assert set(tm) == want
        for k in jm:
            assert abs(tm[k] - jm[k]) <= 1e-5, (mod, k, tm[k], jm[k])


def test_view_metrics_at_a_quarter_scale_warn_and_skip_the_demosaicked_regimes():
    jev, tev, jds = evaluators(0.25)
    frames = frames_of(jds, "rgb", 0)
    for ev in (jev, tev):
        with pytest.warns(UserWarning, match="demosaicked-regime metrics skipped: "
                                             "rendering_scale=0.25"):
            out = ev.view_metrics(frames, "rgb")
        assert set(out) == {"psnr", "ssim", "psnr_mosaicked", "ssim_mosaicked"}


def test_export_metrics_writes_the_same_results_txt(tmp_path):
    dirs = (str(tmp_path / "jax"), str(tmp_path / "port"))
    for d in dirs:
        os.makedirs(d)
    jev, tev, _ = evaluators(1.0, dirs)
    rng = np.random.default_rng(3)
    for step in (10, 20):
        results = {m: {"psnr": float(rng.uniform(20, 40)), "ssim": float(rng.random()),
                       "psnr_mosaicked": float(rng.uniform(20, 40))} for m in MODS}
        jev.export_metrics(results, step)
        tev.export_metrics(results, step)
    stamp = re.compile(r" @ \d{4}-\d\d-\d\d \d\d:\d\d:\d\d")
    texts = [stamp.sub(" @ T", open(os.path.join(d, "results.txt")).read()) for d in dirs]
    assert texts[0] == texts[1] and texts[1].startswith("step 20 @ T\n")


def test_demosaicking_matches_jax():
    rng = np.random.default_rng(0)
    for pattern in (np.array([[1, 2], [0, 1]]), np.array([[0, 1], [3, 2]]),
                    np.arange(9).reshape(3, 3)):
        for h, w in ((12, 12), (13, 17)):
            raw = rng.random((h, w, 1)).astype(np.float32)
            assert np.array_equal(tdem.demosaick_grid(raw, pattern),
                                  jdem.demosaick_grid(raw, pattern))
            full = rng.random((h, w, int(pattern.max()) + 1)).astype(np.float32)
            assert np.array_equal(tdem.mosaick(full, pattern), jdem.mosaick(full, pattern))
    raw = rng.random((16, 16, 1)).astype(np.float32)
    for mod, pattern in (("rgb", np.array([[1, 2], [0, 1]])),
                         ("polarization", np.array([[0, 1], [3, 2]])),
                         ("multispectral", np.arange(9).reshape(3, 3))):
        assert np.array_equal(tdem.demosaick_for_modality(raw, pattern, mod),
                              jdem.demosaick_for_modality(raw, pattern, mod)), mod
    assert np.array_equal(tdem.demosaick_multispectral(raw), jdem.demosaick_multispectral(raw))


def test_extract_mesh_and_ply_match_jax(tmp_path):
    def sdf(pts):  # a sphere of radius 0.6 united with a box
        pts = np.asarray(pts)
        box = np.max(np.abs(pts - np.array([0.3, 0.0, 0.0])) - np.array([0.5, 0.2, 0.3]), axis=-1)
        return np.minimum(np.linalg.norm(pts, axis=-1) - 0.6, box).astype(np.float32)

    tv, tf = tmesh.extract_mesh(sdf, resolution=24)
    jv, jf = jmesh.extract_mesh(sdf, resolution=24)
    assert len(tv) > 100 and np.array_equal(tv, jv) and np.array_equal(tf, jf)
    tmeshio.write_ply_mesh(str(tmp_path / "t.ply"), tv, tf)
    jmeshio.write_ply_mesh(str(tmp_path / "j.ply"), jv, jf)
    assert open(tmp_path / "t.ply").read() == open(tmp_path / "j.ply").read()


def test_export_poses_match_jax(tmp_path):
    dirs = (str(tmp_path / "jax"), str(tmp_path / "port"))
    jev, tev, jds = evaluators(1.0, dirs)
    rng = np.random.default_rng(1)
    poses = {m: (0.05 * rng.normal(size=(1, 6))).astype(np.float32) for m in MODS}
    jstate = JTrainState(params={"model": {}, "camera_poses": {m: jnp.asarray(p)
                                                               for m, p in poses.items()}},
                         opt_state=None, step=jnp.asarray(7))
    tstate = TrainState(camera_poses={m: torch.from_numpy(p) for m, p in poses.items()}, step=7)
    jpath, tpath = jev.export_poses(jstate, 7), tev.export_poses(tstate, 7)
    assert os.path.basename(tpath) == os.path.basename(jpath) == "step-000000007.ply"
    jtext, ttext = open(jpath).read().splitlines(), open(tpath).read().splitlines()
    assert len(ttext) == len(jtext) == 10 + 3 * DATA["num_views"] and ttext[:10] == jtext[:10]
    for a, b in zip(ttext[10:], jtext[10:]):  # centres within 2e-6 (float32 pose products), colours equal
        a, b = a.split(), b.split()
        assert a[3:] == b[3:]
        assert np.allclose([float(x) for x in a[:3]], [float(x) for x in b[:3]], atol=2e-6)


@pytest.mark.parametrize("mod", ["rgb", "polarization", "mono"])
def test_export_view_pngs_decode_as_jax_cv2_files(tmp_path, mod):
    dirs = (str(tmp_path / "jax"), str(tmp_path / "port"))
    jev, tev, jds = evaluators(1.0, dirs)
    frames = frames_of(jds, mod, 5)
    jev.export_view(frames, mod, 2, 40)
    tev.export_view(frames, mod, 2, 40)
    jfiles = sorted(os.path.relpath(p, dirs[0]) for p in glob.glob(f"{dirs[0]}/**/*.*",
                                                                      recursive=True))
    tfiles = sorted(os.path.relpath(p, dirs[1]) for p in glob.glob(f"{dirs[1]}/**/*.*",
                                                                      recursive=True))
    assert tfiles == jfiles and any("depth" in f for f in tfiles)
    if mod != "mono":
        assert any("demosaicked" in f for f in tfiles)
    for f in tfiles:
        a, b = (os.path.join(d, f) for d in reversed(dirs))
        if f.endswith(".npy"):
            assert np.array_equal(np.load(a), np.load(b)), f
            continue
        ta, jb = cv2.imread(a, cv2.IMREAD_UNCHANGED), cv2.imread(b, cv2.IMREAD_UNCHANGED)
        assert ta.dtype == jb.dtype == np.uint16 and np.array_equal(ta, jb), f


def test_viridis_is_matplotlibs():
    cmap = plt.get_cmap("viridis")
    assert np.array_equal(VIRIDIS, cmap(np.arange(256) / 255.0)[:, :3])
    x = np.random.default_rng(0).random(4096).astype(np.float32)
    x[:4] = [0.0, 1.0, np.nextafter(np.float32(1.0), np.float32(0.0)), 0.5]
    assert np.array_equal(viridis(x), cmap(x)[..., :3])
    assert np.array_equal(viridis(x.astype(np.float64)), cmap(x.astype(np.float64))[..., :3])


@pytest.mark.parametrize("method", sorted(tmethods.method_configs()))
def test_config_to_string_matches_jax(method):
    assert (tconfig.config_to_string(tmethods.method_configs()[method])
            == jconfig.config_to_string(jmethods.method_configs()[method]))


@pytest.mark.parametrize("name", sorted(rehearsals.REHEARSALS))
def test_rehearsal_configs_print_their_runs_config_yaml(name):
    r = rehearsals.REHEARSALS[name]
    import yaml

    with open(r["conf"]) as f:
        leaves = yaml.safe_load(f)
    assert leaves.pop("method") == r["method"] and leaves == r["leaves"]
    cfg = rehearsals.rehearsal_config(name)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, modalities=tuple((m, tmethods.MODALITY_CHANNELS[m]) for m in cfg.modalities)))
    assert cc.config_diff(name, tconfig.config_to_string(cfg)) == ([], [])


def test_launcher_trains_saves_resumes_and_evaluates(tmp_path, monkeypatch):
    tiny = dataclasses.replace(
        TCFG, max_num_iterations=2, steps_per_eval_batch=2, steps_per_eval_image=2,
        steps_per_eval_all_images=0, steps_per_save=2,
        evaluator=dataclasses.replace(TCFG.evaluator, rendering_scale=1.0, export_mesh=True,
                                      mesh_resolution=12, export_poses=True,
                                      eval_num_rays_per_chunk=64),
        logging=dataclasses.replace(TCFG.logging, steps_per_log=1, steps_per_flush_buffer=2))
    monkeypatch.setattr(tmethods, "method_configs", lambda: {"grid_raw_tpu": tiny})
    args = ["--method", "grid_raw_tpu", "--scene", "synthetic_raw:views=5,size=8",
            "--version", "t", "--output", str(tmp_path), "--device", "cpu"]
    assert launcher.main(["--mode", "train", *args]) is None
    run = tmp_path / "synthetic_raw" / "grid_raw_tpu" / "grid_raw_tpu" / "t"
    ckpt = torch.load(run / "checkpoints" / "step-000000002.pt", weights_only=True)
    assert ckpt["step"] == 2 and ckpt["opt_state"]["count"] == 2
    assert (run / "config.yaml").read_text() == tconfig.config_to_string(
        launcher.resolve_model_channels(tiny, launcher.build_datasets(
            tiny, "synthetic_raw:views=5,size=8", device="cpu")[0]))
    assert glob.glob(str(run / "renders" / "step-000000002" / "rgb" / "0000_sheet.png"))
    assert glob.glob(str(run / "renders" / "step-000000002" / "demosaicked" / "rgb" / "0000.png"))

    results = launcher.main(["--mode", "eval", *args])
    assert set(results) == set(MODS)
    assert all(np.isfinite(v) for m in results.values() for v in m.values())
    assert (run / "results.txt").read_text().startswith("step 2 @ ")
    assert (run / "meshes" / "step-000000002.ply").exists()
    assert (run / "poses" / "step-000000002.ply").exists()
    assert tckpt.latest_checkpoint_step(str(run / "checkpoints")) == 2
    # view ids: 0 is a train view, 4 the eval view (every 5th is held out)
    assert launcher.main(["--mode", "eval", *args, "--view_ids", "0", "4"]) == {}
    for vid in (0, 4):
        assert (run / "renders" / "step-000000002" / "rgb" / f"{vid:04d}_sheet.png").exists()
    with pytest.raises(FileNotFoundError, match="meta_data.json"):
        launcher.build_datasets(tiny, str(tmp_path), device="cpu")


@pytest.mark.parametrize("quantize", [True, False])
def test_device_cache_holds_the_frames_as_jax_does(quantize):
    from multimodalstudio_tpu.data.device_cache import build_device_cache as jcache

    from multimodalstudio_tpu_torch.data.device_cache import build_device_cache as tcache

    jds = jmake_dataset(MODS, **DATA)
    tds = tmake_dataset(MODS, **DATA, device="cpu")
    j, t = jcache(jds, quantize), tcache(tds, quantize, device="cpu")
    for mod in MODS:
        a, b = j.data[mod], t.data[mod]
        assert b.shape == a.shape and b.scale == a.scale
        assert np.array_equal(b.images.numpy(), np.asarray(a.images).astype(b.images.numpy().dtype))
        assert np.array_equal(b.mosaick_mask.numpy(), np.asarray(a.mosaick_mask))
        assert (b.images.dtype == torch.float32) != quantize


def test_profiler_traces_each_configured_step_and_times_functions(tmp_path):
    import json

    from multimodalstudio_tpu_torch.utils import profiler

    prof = profiler.TorchTraceProfiler(str(tmp_path), steps=(2, 4))
    for step in range(6):
        prof.maybe_start(step)
        torch.ones(8).sum()
        prof.maybe_stop(step)
    assert sorted(os.listdir(tmp_path / "torch_trace")) == ["trace-step-2.json",
                                                          "trace-step-4.json"]
    # each trace times the functions its step ran: the sum, with a duration
    for name in ("trace-step-2.json", "trace-step-4.json"):
        with open(tmp_path / "torch_trace" / name) as f:
            events = json.load(f)["traceEvents"]
        sums = [e for e in events if e.get("name") == "aten::sum" and e.get("cat") == "cpu_op"]
        assert sums and all(e["dur"] >= 0 for e in sums)


def test_trainer_aborts_on_a_nonfinite_loss_naming_the_first_bad_step():
    from multimodalstudio_tpu_torch.engine.trainer import Trainer

    cfg = dataclasses.replace(TCFG, logging=dataclasses.replace(TCFG.logging, steps_per_log=4,
                                                                 local_writer=False))
    ds = tmake_dataset(MODS, **DATA, device="cpu")
    trainer = Trainer(cfg, ds, ds, None, device="cpu")
    trainer.setup()

    def aux(total):
        return {"losses": {"total_loss": torch.tensor(total), "rgb": torch.tensor(0.5)},
                "metrics": {"psnr_rgb": torch.tensor(20.0)}}

    trainer._aux_window = [(0, aux(1.0)), (1, aux(float("nan"))), (2, aux(float("inf"))),
                           (3, aux(float("nan")))]
    trainer._host_cadences(3, aux(1.0))  # not a logging step: nothing checked
    with pytest.raises(FloatingPointError, match="first non-finite step: 1"):
        trainer._host_cadences(4, aux(float("nan")))
