"""The step profiler's pieces: configs/config.py::apply_env_grid_overrides
against the JAX package's (the BENCH_GRID_* knobs onto the slot grid's
encoding, leaf for leaf, each alone and all five together, and the config
itself when none is set), and scripts/profile_step.py run on the CPU at the
tiny grid_raw_tpu of tests/test_torch_train.py: its trace and op_stats.json
(each op's name, count and self ms), with utils/profiler.py::device_op_stats
on a profile of known nesting.
"""

import dataclasses
import json

import pytest
import torch

import multimodalstudio_tpu.configs.config as jconfig
import multimodalstudio_tpu.configs.methods as jmethods

import multimodalstudio_tpu_torch.configs.config as tconfig
import multimodalstudio_tpu_torch.configs.methods as tmethods
import multimodalstudio_tpu_torch.data.synthetic as tsynthetic
from multimodalstudio_tpu_torch.scripts import profile_step
from multimodalstudio_tpu_torch.utils.profiler import device_op_stats

from test_torch_train import MODS, TCFG

torch.set_num_threads(1)

KNOBS = {"FEATS": "16", "ENTRIES": "512", "DTYPE": "f32", "LEVELS": "8", "MAXRES": "1024"}
FIELDS = {"FEATS": "feats", "ENTRIES": "rows_per_level", "DTYPE": "table_dtype",
          "LEVELS": "num_levels", "MAXRES": "max_res"}


def _value(knob):
    return KNOBS[knob] if knob == "DTYPE" else int(KNOBS[knob])


def _grid(cfg):
    return cfg.model.surface.surface_field.field.grid


@pytest.mark.parametrize("knobs", [[k] for k in KNOBS] + [list(KNOBS)],
                         ids=[k for k in KNOBS] + ["all five"])
@pytest.mark.parametrize("prefix", ["BENCH_GRID_", "OTHER_"])
def test_grid_overrides_match_jax(monkeypatch, knobs, prefix):
    for k in knobs:
        monkeypatch.setenv(prefix + k, KNOBS[k])
    for method in ("grid_raw_tpu", "mlp_raw_tpu"):
        j = jconfig.apply_env_grid_overrides(jmethods.method_configs()[method], prefix=prefix)
        t = tconfig.apply_env_grid_overrides(tmethods.method_configs()[method], prefix=prefix)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        if method == "mlp_raw_tpu":
            # no grid: as in JAX, the encoding's dict lands on the None field as pairs
            assert _grid(t) == (("encoding", {FIELDS[k]: _value(k) for k in knobs}),)
            continue
        enc = _grid(t).encoding
        for k in knobs:
            assert getattr(enc, FIELDS[k]) == _value(k)
            assert type(getattr(enc, FIELDS[k])) is type(_value(k))


def test_grid_overrides_without_a_variable_return_the_config(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv("BENCH_GRID_" + k, raising=False)
    monkeypatch.setenv("OTHER_FEATS", "16")  # another prefix's knob
    for method in ("grid_raw_tpu", "mlp_raw_tpu"):
        cfg = tmethods.method_configs()[method]
        assert tconfig.apply_env_grid_overrides(cfg) is cfg
        jcfg = jmethods.method_configs()[method]
        assert jconfig.apply_env_grid_overrides(jcfg) is jcfg


def test_op_stats_sum_self_time_by_name():
    """The host's operators nest (aten::linear runs aten::addmm): each one's
    self ms is its duration less its children's, so the self ms of all ops
    sum to at most the profile's wall time and every op keeps its count."""
    from torch.profiler import ProfilerActivity, profile

    x, w = torch.randn(64, 32), torch.randn(16, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            torch.nn.functional.linear(x, w).relu()
    ops = {op["name"]: op for op in device_op_stats(prof, "cpu")}
    assert ops["aten::linear"]["count"] == ops["aten::relu"]["count"] == 3
    total = {}
    for e in prof.profiler.kineto_results.events():
        total[e.name()] = total.get(e.name(), 0) + e.duration_ns() / 1e6
    assert 0 <= ops["aten::linear"]["self_ms"] < total["aten::linear"]
    assert all(op["self_ms"] >= 0 for op in ops.values())
    ms = [op["self_ms"] for op in device_op_stats(prof, "cpu")]
    assert ms == sorted(ms, reverse=True)
    assert device_op_stats(prof, "cuda") == []


def test_profile_step_writes_its_trace_and_op_stats(tmp_path, monkeypatch):
    monkeypatch.setattr(profile_step, "ROOT", tmp_path)
    monkeypatch.setattr(tmethods, "method_configs", lambda: {"grid_raw_tpu": TCFG})
    make = tsynthetic.make_synthetic_dataset
    monkeypatch.setattr(tsynthetic, "make_synthetic_dataset",
                        lambda mods, **kw: make(mods, **{**kw, "height": 8, "width": 8}))
    for k, v in {"PROF_METHOD": "grid_raw_tpu", "PROF_RAYS": "4", "PROF_MICROBATCH": "2",
                 "PROF_MODS": ",".join(MODS), "PROF_TAG": "cpu", "BENCH_GRID_ENTRIES": "32"}.items():
        monkeypatch.setenv(k, v)
    out = profile_step.main(["--device", "cpu"])
    assert out == str(tmp_path / "prof_grid_raw_tpu_4_2_cpu")
    trace = json.loads((tmp_path / "prof_grid_raw_tpu_4_2_cpu" / "trace.json").read_text())
    assert trace["traceEvents"]
    stats = json.loads((tmp_path / "prof_grid_raw_tpu_4_2_cpu" / "op_stats.json").read_text())
    assert (stats["method"], stats["rays"], stats["microbatch"], stats["steps"]) == (
        "grid_raw_tpu", 4, 2, 3)
    assert stats["modalities"] == list(MODS) and stats["device"] == "cpu"
    assert stats["launches"] == {}  # the CPU runs the plain versions
    ops = stats["ops"]
    assert ops and all(op["count"] > 0 and op["self_ms"] >= 0 for op in ops)
    assert [op["self_ms"] for op in ops] == sorted((op["self_ms"] for op in ops), reverse=True)
    names = {op["name"] for op in ops}
    assert {"aten::mm", "aten::index_select"} & names
    assert stats["busy_ms"] == pytest.approx(sum(op["self_ms"] for op in ops))
