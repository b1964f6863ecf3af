"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, its entry points refuse to run without a card unless the caller
asks for the CPU, and its kernel wrappers never hand a non-CPU tensor to a
plain version."""

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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "multimodalstudio_tpu")

PROBE = """
import importlib, json, pkgutil, sys
import multimodalstudio_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
"""


def test_port_and_chip_smoke_import_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True)
    probe = json.loads(out.stdout.strip().splitlines()[-1])
    assert "multimodalstudio_tpu_torch.models.model" in probe["imported"]
    assert "multimodalstudio_tpu_torch.ops.kernels.slot_fused" in probe["imported"]
    assert "multimodalstudio_tpu_torch.ops.kernels.sdf_chain" in probe["imported"]
    assert "multimodalstudio_tpu_torch.ops.kernels.slot_grid" in probe["imported"]
    assert "multimodalstudio_tpu_torch.configs.config" in probe["imported"]
    assert "multimodalstudio_tpu_torch.engine.train" in probe["imported"]
    assert "multimodalstudio_tpu_torch.data.device_cache" in probe["imported"]
    # exact names: the port's own package shares the JAX package's prefix
    leaked = [m for m in probe["modules"]
              if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
    assert leaked == []


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


@pytest.mark.parametrize("method", ["grid_raw_tpu", "mlp_raw_tpu"])
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
