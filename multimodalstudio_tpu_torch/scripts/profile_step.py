"""Profile training steps and attribute device time by op (JAX reference:
scripts/profile_step.py, with the same environment contract):

    PROF_METHOD      registered method (default mlp_raw_tpu)
    PROF_RAYS        rays per modality a step (default 2048)
    PROF_MICROBATCH  rays per modality a microbatch (default 1024)
    PROF_MODS        comma-separated modalities (default all five)
    PROF_TAG         suffix of the trace directory (default none)
    BENCH_GRID_*     the slot grid's geometry (configs/config.py::apply_env_grid_overrides)

The method trains on the 10-view, 256 x 256 raw synthetic scene from the
device cache (engine/train.py::make_train_steps): 3 warm-up steps, then
torch.profiler over 3 steps. The trace directory is
prof_<method>_<rays>_<microbatch>[_<tag>] at the repository's root. It
receives the Chrome trace (trace.json, for Perfetto or chrome://tracing)
and op_stats.json: each op's name, count and self ms over the 3 steps, by
self ms (utils/profiler.py::device_op_stats), with the kernel wrappers'
launches of the 6 steps. On the card the profile records the card's
activity alone, so its ops are kernels, copies and fills; with
`--device cpu` it records the host's operators.

    python -m multimodalstudio_tpu_torch.scripts.profile_step [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
WARMUP_STEPS = 3
PROFILED_STEPS = 3
TOP = 12


def trace_dir_name(method: str, n_rays: int, micro: int, tag: str) -> str:
    return f"prof_{method}_{n_rays}_{micro}{('_' + tag) if tag else ''}"


def main(argv=None) -> str:
    """Train, profile and write the trace directory; returns its path."""
    from torch.profiler import ProfilerActivity, profile

    from multimodalstudio_tpu_torch.cameras.camera_optimizer import init_camera_poses
    from multimodalstudio_tpu_torch.configs.config import apply_env_grid_overrides
    from multimodalstudio_tpu_torch.configs.methods import method_configs
    from multimodalstudio_tpu_torch.data.device_cache import build_device_cache
    from multimodalstudio_tpu_torch.data.synthetic import make_synthetic_dataset
    from multimodalstudio_tpu_torch.device import resolve_device, set_reference_precision
    from multimodalstudio_tpu_torch.engine.train import init_train_state, make_train_steps
    from multimodalstudio_tpu_torch.models.model import MMSModel
    from multimodalstudio_tpu_torch.ops.kernels import build
    from multimodalstudio_tpu_torch.utils.profiler import device_op_stats

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    method = os.environ.get("PROF_METHOD", "mlp_raw_tpu")
    n_rays = int(os.environ.get("PROF_RAYS", "2048"))
    micro = int(os.environ.get("PROF_MICROBATCH", "1024"))
    modalities = tuple(os.environ.get(
        "PROF_MODS", "rgb,infrared,mono,polarization,multispectral").split(","))

    set_reference_precision()
    cfg = method_configs()[method]
    cfg = dataclasses.replace(
        cfg, modalities=modalities, max_num_iterations=100000,
        datamanager=dataclasses.replace(cfg.datamanager, num_rays_per_modality=n_rays,
                                        microbatch_rays=micro))
    cfg = apply_env_grid_overrides(cfg)
    ds = make_synthetic_dataset(modalities, num_views=10, height=256, width=256, raw=True,
                                device=dev)
    cache = build_device_cache(ds, device=dev)
    cams = {m: ds.data[m].cameras for m in modalities}
    model = MMSModel(cfg.model, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    poses = init_camera_poses(cfg.datamanager.camera_optimizer, modalities,
                              {m: 10 for m in modalities}, device=dev)
    state = init_train_state(cfg, model, poses)
    train_steps = make_train_steps(cfg, model, cams)
    gen = torch.Generator(device=dev).manual_seed(1)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    build.reset_launch_counts()
    for _ in range(WARMUP_STEPS):
        state, aux = train_steps(state, cache, gen, 1)
    sync()

    trace_dir = ROOT / trace_dir_name(method, n_rays, micro, os.environ.get("PROF_TAG", ""))
    trace_dir.mkdir(parents=True, exist_ok=True)
    activity = ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        for _ in range(PROFILED_STEPS):
            state, aux = train_steps(state, cache, gen, 1)
        sync()
    prof.export_chrome_trace(str(trace_dir / "trace.json"))
    print("trace written to", trace_dir, flush=True)

    ops = device_op_stats(prof, dev.type)
    stats = {
        "method": method, "rays": n_rays, "microbatch": micro, "modalities": list(modalities),
        "device": dev.type, "steps": PROFILED_STEPS,
        "busy_ms": sum(op["self_ms"] for op in ops),
        "launches": {k: info.launches for k, info in build.KERNELS.items() if info.launches},
        "ops": ops,
    }
    out = trace_dir / "op_stats.json"
    out.write_text(json.dumps(stats, indent=1))
    print("op stats written to", out, flush=True)
    print(f"{dev.type} busy {stats['busy_ms']:.3f} ms over {PROFILED_STEPS} steps, "
          f"{sum(op['count'] for op in ops)} ops; the top {TOP}:")
    for op in ops[:TOP]:
        print(f"  {op['self_ms']:10.3f} ms {op['count']:7d}x {op['name'][:100]}")
    return str(trace_dir)


if __name__ == "__main__":
    main()
