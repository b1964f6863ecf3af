"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package (nor OpenCV, matplotlib, PyYAML or convert_checkpoints.py, which
the card's machine lacks or which import JAX), its entry points refuse to
run without a card unless the caller asks for the CPU, and its kernel
wrappers never hand a non-CPU tensor to a plain version."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from multimodalstudio_tpu_torch.cameras.camera_optimizer import CameraOptimizerSpec, init_camera_poses
from multimodalstudio_tpu_torch.configs.config import load_config
from multimodalstudio_tpu_torch.configs.methods import method_configs
from multimodalstudio_tpu_torch.data.synthetic import make_synthetic_dataset
from multimodalstudio_tpu_torch.engine.evaluator import Evaluator, RawEvaluator
from multimodalstudio_tpu_torch.models.model import MMSModel
from multimodalstudio_tpu_torch.ops.kernels import fused_mlp, sdf_chain, slot_fused, slot_grid

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "multimodalstudio_tpu")
# imported only inside the functions that need them (load_config given a YAML path), or
# never (the converter imports JAX; the card's machine has no cv2 and no matplotlib)
NOT_AT_IMPORT = ("cv2", "matplotlib", "yaml", "convert_checkpoints")

PROBE = """
import importlib, json, pkgutil, sys
import multimodalstudio_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke, rehearsals
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
"""


@pytest.fixture(scope="module")
def probe():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _leaked(modules, names):
    # exact names: the port's own package shares the JAX package's prefix
    return [m for m in modules if any(m == f or m.startswith(f + ".") for f in names)]


def test_port_and_chip_smoke_import_no_jax(probe):
    assert "multimodalstudio_tpu_torch.models.model" in probe["imported"]
    assert "multimodalstudio_tpu_torch.ops.kernels.slot_fused" in probe["imported"]
    assert "multimodalstudio_tpu_torch.ops.kernels.sdf_chain" in probe["imported"]
    assert "multimodalstudio_tpu_torch.ops.kernels.slot_grid" in probe["imported"]
    assert "multimodalstudio_tpu_torch.configs.config" in probe["imported"]
    assert "multimodalstudio_tpu_torch.engine.train" in probe["imported"]
    assert "multimodalstudio_tpu_torch.data.device_cache" in probe["imported"]
    assert "rehearsals" in probe["modules"]
    assert _leaked(probe["modules"], FORBIDDEN) == []


def test_data_parallel_lpips_scripts_and_native_import_no_jax(probe):
    """The modules of data-parallel training, LPIPS, the port's scripts and the native
    sampler's loader, and chip_smoke.py's phases D and E that drive them, stand alone."""
    for name in ("parallel.sharding", "utils.lpips", "data.native", "scripts.dist_dryrun",
                 "scripts.dist_dryrun_worker", "scripts.evaluate_average_metrics"):
        assert f"multimodalstudio_tpu_torch.{name}" in probe["imported"], name
    import chip_smoke

    for fn in ("run_data_parallel", "dp_rank_main", "dp_reference", "nccl_all_reduce",
               "score_disk_renders", "time_host_sampler"):
        assert callable(getattr(chip_smoke, fn)), fn
    assert _leaked(probe["modules"], FORBIDDEN + NOT_AT_IMPORT) == []


def test_entry_scripts_import_no_jax_or_opencv_and_need_a_card(probe, monkeypatch):
    """The capture preprocessing scripts import OpenCV inside main (the card's machine has
    none); the step profiler and the quality harness refuse to run without a card unless
    asked for the CPU."""
    from multimodalstudio_tpu_torch.scripts import profile_step, quality_check

    for name in ("preprocess_custom_dataset", "preprocess_mmsdata", "profile_step",
                 "quality_check"):
        assert f"multimodalstudio_tpu_torch.scripts.{name}" in probe["imported"], name
    assert _leaked(probe["modules"], FORBIDDEN + NOT_AT_IMPORT) == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_step.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quality_check.main(["--steps", "0", "--scene", "synthetic_raw:views=2,size=4"])


def test_entry_point_modules_import_no_opencv_matplotlib_yaml_or_converter(probe):
    for name in ("engine.checkpoints", "engine.trainer", "engine.evaluator", "engine.mesh",
                 "launcher", "preprocessing.demosaick", "utils.images", "utils.meshio",
                 "utils.writer", "utils.profiler", "convert", "data.dataset", "data.synthetic",
                 "preprocessing.colmap", "preprocessing.metadata", "models.colliders",
                 "models.volume_rendering", "engine.schedules", "ops.distortion",
                 "ops.polarization"):
        assert f"multimodalstudio_tpu_torch.{name}" in probe["imported"], name
    assert _leaked(probe["modules"], NOT_AT_IMPORT) == []


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs on it")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, alone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


@pytest.mark.parametrize("method", ["grid_raw_tpu", "mlp_raw_tpu", "grid_raw", "mlp_raw"])
def test_entry_points_raise_without_a_card(monkeypatch, method):
    cfg = method_configs()[method]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MMSModel(cfg.model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_synthetic_dataset(("rgb",), num_views=2, height=4, width=4)
    model = MMSModel(cfg.model, device="cpu")
    data = make_synthetic_dataset(("rgb",), num_views=2, height=4, width=4, device="cpu")
    for cls in (Evaluator, RawEvaluator):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(cfg, model, data, data)
    spec = CameraOptimizerSpec(mode="SO3xR3")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_camera_poses(spec, ("rgb",), {"rgb": 2})
    poses = init_camera_poses(spec, ("rgb",), {"rgb": 2}, device="cpu")
    assert poses["rgb"].device.type == "cpu" and tuple(poses["rgb"].shape) == (2, 6)


def test_kernel_wrappers_take_the_plain_version_only_on_the_cpu():
    # a tensor on neither the CPU nor a card must not reach a plain version
    x = torch.empty(8, 16, device="meta")
    ws = [torch.empty(16, 16, device="meta"), torch.empty(16, 4, device="meta")]
    bs = [torch.empty(16, device="meta"), torch.empty(4, device="meta")]
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mlp.fused_chain(x, ws, bs)
    spec = slot_grid.SlotGridSpec(num_levels=2, min_res=4, max_res=8, rows_per_level=64,
                                  layout="cell", feats=2, table_dtype="bf16")
    pos = torch.empty(8, 3, device="meta")
    table = torch.empty(spec.total_rows, 128, device="meta")
    kw = dict(radius=1.0, num_frequencies=2, min_freq_exp=0.0, max_freq_exp=1.0)
    for fn in (slot_fused.fused_slot_sdf_value, slot_fused.fused_slot_sdf_chain):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(pos, table, ws, bs, spec, **kw)
    sws, sbs = _sdf_chain_params(requires_grad=False)
    with pytest.raises(ValueError, match="unsupported device"):
        sdf_chain.fused_sdf_chain(pos, sws, sbs, **SDF_KW)
    with pytest.raises(ValueError, match="unsupported device"):
        sdf_chain.fused_chain_adjoint(torch.empty(8, 15, device="meta"), sws, sbs, skip=(1,))
    for tangents in (False, True):
        with pytest.raises(ValueError, match="unsupported device"):
            slot_grid.slot_grid_lookup(table, pos, spec, with_tangents=tangents)
    # the vertex layout's lookup (K6v)
    vspec = _vertex_spec()
    vtable = torch.empty(vspec.total_rows, 128, device="meta")
    for tangents in (False, True):
        with pytest.raises(ValueError, match="unsupported device"):
            slot_grid.slot_grid_lookup(vtable, pos, vspec, with_tangents=tangents)


def _vertex_spec():
    return slot_grid.SlotGridSpec(num_levels=2, min_res=4, max_res=8, rows_per_level=64,
                                  layout="vertex", feats=16, table_dtype="f32")


SDF_KW = dict(num_frequencies=2, min_freq_exp=0.0, max_freq_exp=1.0, skip=(1,))


def _sdf_chain_params(requires_grad):
    """An SDF chain on 3 + 6 * 2 = 15 encoded inputs, skip at layer 1."""
    dims = [(15, 16), (31, 16), (16, 5)]
    ws = [torch.empty(*d, device="meta", requires_grad=requires_grad) for d in dims]
    bs = [torch.empty(d[1], device="meta", requires_grad=requires_grad) for d in dims]
    return ws, bs


def test_differentiable_kernels_and_backward_launchers_refuse_other_devices():
    """With grad the wrappers go through their autograd Functions, and the
    backward launchers (what a CUDA tensor's backward calls) take only
    card tensors: nothing but a CPU tensor reaches a plain version."""
    ws = [torch.empty(16, 16, device="meta", requires_grad=True),
          torch.empty(16, 4, device="meta", requires_grad=True)]
    bs = [torch.empty(16, device="meta", requires_grad=True),
          torch.empty(4, device="meta", requires_grad=True)]
    x = torch.empty(8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mlp.fused_chain(x, ws, bs)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mlp._launch_bwd(x, torch.empty(8, 4, device="meta"), ws, bs, (), "ReLU", 100.0)
    spec = slot_grid.SlotGridSpec(num_levels=2, min_res=4, max_res=8, rows_per_level=64,
                                  layout="cell", feats=2, table_dtype="bf16")
    pos = torch.empty(8, 3, device="meta", requires_grad=True)
    table = torch.empty(spec.total_rows, 128, device="meta")
    kw = dict(radius=1.0, num_frequencies=2, min_freq_exp=0.0, max_freq_exp=1.0)
    for fn in (slot_fused.fused_slot_sdf_value, slot_fused.fused_slot_sdf_chain):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(pos, table, ws, bs, spec, **kw)
    pe = slot_fused.pe_scales(2, 0.0, 1.0)
    mask = torch.ones(4, device="meta")
    z = torch.empty(1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        slot_fused._launch_value_bwd(pos, table, ws, bs, spec, 2, 1.0, pe, "ReLU", 100.0, mask,
                                     z, torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        slot_fused._launch_chain_bwd(pos, table, ws, bs, spec, 1.0, pe, "ReLU", 100.0, mask, z,
                                     z, torch.empty(8, 19, device="meta"),
                                     torch.empty(8, device="meta"),
                                     torch.empty(8, 3, device="meta"),
                                     torch.empty(8, 3, device="meta"))
    sws, sbs = _sdf_chain_params(requires_grad=True)
    with pytest.raises(ValueError, match="unsupported device"):
        sdf_chain.fused_sdf_chain(pos, sws, sbs, **SDF_KW)
    with pytest.raises(ValueError, match="unsupported device"):
        sdf_chain._launch_bwd(pos, sws, sbs, (1,), "SoftplusQuad", 100.0, pe,
                              torch.empty(8, device="meta"), torch.empty(8, 4, device="meta"),
                              torch.empty(8, 3, device="meta"))
    x5 = torch.empty(8, 15, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="unsupported device"):
        sdf_chain.fused_chain_adjoint(x5, sws, sbs, skip=(1,))
    with pytest.raises(ValueError, match="unsupported device"):
        sdf_chain._launch_adj_bwd(x5, sws, sbs, (1,), "SoftplusQuad", 100.0, 0,
                                  torch.empty(8, 5, device="meta"), torch.empty(8, 15, device="meta"))
    table = torch.empty(spec.total_rows, 128, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="unsupported device"):
        slot_grid.slot_grid_lookup(table, pos, spec, with_tangents=True)
    idx = torch.zeros(8, 2, dtype=torch.long, device="meta")
    w, dw = torch.empty(8, 16, device="meta"), torch.empty(8, 48, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        slot_grid._launch_bwd(table, idx, w, dw, torch.empty(8, 4, device="meta"),
                              torch.empty(8, 12, device="meta"), 2, True)
    vspec = _vertex_spec()
    vtable = torch.empty(vspec.total_rows, 128, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="unsupported device"):
        slot_grid.slot_grid_lookup(vtable, pos, vspec, with_tangents=True)
    vidx = torch.zeros(8, 16, dtype=torch.long, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        slot_grid._launch_vertex_fwd(vtable, vidx, w, dw)
    with pytest.raises(ValueError, match="unsupported device"):
        slot_grid._launch_vertex_bwd(vtable, vidx, w, dw, torch.empty(8, 32, device="meta"),
                                     torch.empty(8, 96, device="meta"))


def test_split_launchers_refuse_other_devices(monkeypatch):
    """The split backward's launchers (the per-sample passes and the table
    scatter) take only card tensors, and under MMS_SLOT_BWD_SPLIT=1 the
    differentiable wrappers still refuse other devices."""
    monkeypatch.setenv("MMS_SLOT_BWD_SPLIT", "1")
    ws = [torch.empty(16, 16, device="meta", requires_grad=True),
          torch.empty(16, 4, device="meta", requires_grad=True)]
    bs = [torch.empty(16, device="meta", requires_grad=True),
          torch.empty(4, device="meta", requires_grad=True)]
    spec = slot_grid.SlotGridSpec(num_levels=2, min_res=4, max_res=8, rows_per_level=64,
                                  layout="cell", feats=2, table_dtype="bf16")
    pos = torch.empty(8, 3, device="meta", requires_grad=True)
    table = torch.empty(spec.total_rows, 128, device="meta")
    kw = dict(radius=1.0, num_frequencies=2, min_freq_exp=0.0, max_freq_exp=1.0)
    for fn in (slot_fused.fused_slot_sdf_value, slot_fused.fused_slot_sdf_chain):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(pos, table, ws, bs, spec, **kw)
    pe = slot_fused.pe_scales(2, 0.0, 1.0)
    mask = torch.ones(4, device="meta")
    z = torch.empty(1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        slot_fused._launch_value_bwd_sample(pos, table, ws, bs, spec, 2, 1.0, pe, "ReLU", 100.0,
                                            mask, z, torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        slot_fused._launch_chain_bwd_sample(pos, table, ws, bs, spec, 1.0, pe, "ReLU", 100.0,
                                            mask, z, z, torch.empty(8, 19, device="meta"),
                                            torch.empty(8, device="meta"),
                                            torch.empty(8, 3, device="meta"),
                                            torch.empty(8, 3, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        slot_fused._launch_table_scatter(pos, torch.empty(8, 2, 16, dtype=torch.bfloat16,
                                                          device="meta"), spec, 1.0)


def test_contraction_path_raises_without_a_card(monkeypatch):
    """mlp_raw_tpu with a scene contraction (the K1t route) through
    load_config: the model refuses to start without a card unless asked
    for the CPU, where its SDF gradients take the plain versions."""
    cfg = load_config(method="mlp_raw_tpu",
                      overrides={"model": {"surface": {"contraction_order": float("inf")}}})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MMSModel(cfg.model)
    assert MMSModel(cfg.model, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("requires_grad", [False, True])
def test_tangent_kernels_refuse_other_devices(monkeypatch, requires_grad):
    """K1t and K4j (fused_chain with tangents, fused_sdf_chain in jvp mode,
    also through MMS_SDF_CHAIN_MODE) and their backward launchers take only
    card tensors: nothing but a CPU tensor reaches a plain version."""
    ws = [torch.empty(16, 16, device="meta", requires_grad=requires_grad),
          torch.empty(16, 4, device="meta", requires_grad=requires_grad)]
    bs = [torch.empty(16, device="meta", requires_grad=requires_grad),
          torch.empty(4, device="meta", requires_grad=requires_grad)]
    x, tx = torch.empty(8, 16, device="meta"), torch.empty(3, 8, 16, device="meta")
    for channel in (0, None):
        with pytest.raises(ValueError, match="unsupported device"):
            fused_mlp.fused_chain(x, ws, bs, tangents=tx, tangent_out_channel=channel)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mlp._launch_tangent_bwd(x, tx, torch.empty(8, 4, device="meta"),
                                      torch.empty(8, 3, device="meta"), ws, bs, (), "ReLU",
                                      100.0, 0)
    sws, sbs = _sdf_chain_params(requires_grad)
    pos = torch.empty(8, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sdf_chain.fused_sdf_chain(pos, sws, sbs, mode="jvp", **SDF_KW)
    monkeypatch.setenv("MMS_SDF_CHAIN_MODE", "jvp")
    with pytest.raises(ValueError, match="unsupported device"):
        sdf_chain.fused_sdf_chain(pos, sws, sbs, **SDF_KW)
    with pytest.raises(ValueError, match="unsupported device"):
        sdf_chain._launch_jvp_bwd(pos, sws, sbs, (1,), "SoftplusQuad", 100.0,
                                  slot_fused.pe_scales(2, 0.0, 1.0),
                                  torch.empty(8, device="meta"), torch.empty(8, 4, device="meta"),
                                  torch.empty(8, 3, device="meta"))


def test_trainer_and_launcher_raise_without_a_card(monkeypatch):
    from multimodalstudio_tpu_torch import launcher
    from multimodalstudio_tpu_torch.engine.trainer import Trainer

    cfg = method_configs()["grid_raw_tpu"]
    data = make_synthetic_dataset(("rgb",), num_views=2, height=4, width=4, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, data, data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.build_datasets(cfg, "synthetic_raw:views=2,size=4")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--method", "grid_raw_tpu", "--scene", "synthetic_raw:views=2,size=4",
                       "--output", "unused"])
    # n_devices counts the processes of the group: without one, only 0 or 1
    import dataclasses

    for n in (2, 8):
        with pytest.raises(ValueError, match=f"n_devices={n} but the process group has 1 "):
            Trainer(dataclasses.replace(cfg, n_devices=n), data, data, device="cpu")


def test_scenes_on_disk_need_no_opencv(tmp_path, monkeypatch):
    """The card's machine has no cv2: with `import cv2` failing, the port
    still writes the synthetic scene, loads it and splits it through the
    launcher (PNG frames through utils/images.py)."""
    from multimodalstudio_tpu_torch import launcher
    from multimodalstudio_tpu_torch.data.dataset import load_dataset
    from multimodalstudio_tpu_torch.data.synthetic import write_synthetic_scene

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2  # noqa: F401
    mods = ("rgb", "polarization", "mono")
    scene = write_synthetic_scene(str(tmp_path / "scene"), mods, num_views=6, height=8, width=8,
                                  raw=True)
    ds = load_dataset(scene, mods, {m: [0, 3] for m in mods}, raw=True, device="cpu")
    ref = make_synthetic_dataset(mods, num_views=6, height=8, width=8, raw=True, view_ids=[0, 3],
                                 device="cpu")
    for m in mods:  # the writer truncates to uint16, as the reference's does: one step
        assert abs(ds.data[m].images - ref.data[m].images).max() <= 1 / 65535 + 1e-7
    cfg = load_config(method="grid_raw_tpu", overrides={"datamanager": {
        "eval_image_indices": [1, 4]}})
    import dataclasses

    train, evald = launcher.build_datasets(dataclasses.replace(cfg, modalities=mods), scene,
                                           device="cpu")
    assert list(train.data["rgb"].frame_ids) == [0, 2, 3, 5]
    assert list(evald.data["mono"].frame_ids) == [1, 4]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_dataset(scene, mods, {m: [0] for m in mods}, raw=True)
