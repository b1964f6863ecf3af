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

from multimodalstudio_tpu_torch.configs.methods import method_configs
from multimodalstudio_tpu_torch.data.synthetic import make_synthetic_dataset
from multimodalstudio_tpu_torch.engine.evaluator import Evaluator, RawEvaluator
from multimodalstudio_tpu_torch.models.model import MMSModel
from multimodalstudio_tpu_torch.ops.kernels import fused_mlp, slot_fused, slot_grid

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


def test_entry_points_raise_without_a_card(monkeypatch):
    cfg = method_configs()["grid_raw_tpu"]
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

