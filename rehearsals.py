"""The committed rehearsal runs whose checkpoints the port renders.

Each run was trained and scored by the JAX package on the 36-view, 256 x 256
raw scene; its directory under output/ holds its config.yaml, its results.txt
and its orbax checkpoints, and beside them the port's weights file (params
and step, multimodalstudio_tpu_torch/engine/checkpoints.py) converted on the
CPU by convert_checkpoints.py.

For each run: the registered method, the YAML it was launched with, the
leaves that YAML sets (beside `method`) as a dict, so the port builds the
config without PyYAML, the run's grid overrides (its config.yaml, lines
64-72 for rehearsal_grid_dense: the f32 table), its directory, the step of
the converted checkpoint, and the step of the results.txt block printed
beside the port's metrics: the checkpoint's own step where results.txt
scores the same weights, else its last block.

chip_smoke.py renders these checkpoints on the card; convert_checkpoints.py
and the tests read the same catalog. This module imports nothing of JAX.
"""

from __future__ import annotations

LEAVES = {  # confs/rehearsal_*.yaml, less `method`
    "max_num_iterations": 100000, "steps_per_eval_batch": 1000, "steps_per_eval_image": 5000,
    "steps_per_eval_all_images": 5000, "steps_per_export_mesh": 25000,
    "steps_per_export_poses": 25000, "steps_per_save": 5000,
    "modalities": ["rgb", "infrared", "mono", "polarization", "multispectral"],
    "evaluator": {"eval_num_rays_per_chunk": 4096, "rendering_scale": 1.0, "export_mesh": True,
                  "export_poses": True},
    "logging": {"steps_per_log": 500, "steps_per_flush_buffer": 1000},
    "datamanager": {"num_rays_per_modality": 2048, "microbatch_rays": 512,
                    "camera_optimizer": {"mode": "off"}},
}
# 6 levels of 512 entries, F = 16, an f32 table
F32_GRID = {"model": {"surface": {"surface_field": {"field": {"grid": {"encoding": {
    "rows_per_level": 512, "feats": 16, "table_dtype": "f32"}}}}}}}

REHEARSALS = {
    "rehearsal_mlp_dense": dict(
        method="mlp_raw_tpu", conf="confs/rehearsal_mlp_dense.yaml", leaves=LEAVES,
        grid=None, run="output/synthetic_raw/mlp_raw_tpu/rehearsal_mlp_dense/r3rehearsal",
        step=99999, jax_step=99999),
    "rehearsal_grid_dense": dict(
        method="grid_raw_tpu", conf="confs/rehearsal_grid_dense.yaml", leaves=LEAVES,
        grid=F32_GRID, run="output/synthetic_raw/grid_raw_tpu/rehearsal_grid_dense/r3rehearsal",
        step=99999, jax_step=99999),
    # trained on past its last eval: results.txt ends at step 59999
    "rehearsal_grid_packed_confirm": dict(
        method="grid_raw_tpu", conf="confs/rehearsal_grid_packed_confirm.yaml",
        leaves={**LEAVES, "steps_per_eval_all_images": 10000, "steps_per_export_mesh": 50000,
                "steps_per_export_poses": 50000, "steps_per_save": 2500},
        grid=None,
        run="output/synthetic_raw/grid_raw_tpu/rehearsal_grid_packed_confirm/packed_confirm",
        step=62499, jax_step=59999),
}
SCENE = "synthetic_raw:views=36,size=256"  # confs/rehearsal_*.yaml:3-5


def merge(a, b):
    """Nested dicts a and b merged, b's leaves winning."""
    out = dict(a)
    for k, v in (b or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def rehearsal_config(name):
    """The port's config of a rehearsal run, through load_config with a dict, before the
    dataset binds the model's channels."""
    from multimodalstudio_tpu_torch.configs.config import load_config

    r = REHEARSALS[name]
    return load_config(method=r["method"], overrides=merge(r["leaves"], r["grid"]))
