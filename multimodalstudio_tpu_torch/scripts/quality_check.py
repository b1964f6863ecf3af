"""Quality harness: train a method briefly and report eval PSNR/SSIM (JAX
reference: scripts/quality_check.py, with the same command line, config
overrides and JSON report).

Compares training recipes (the reference-faithful `grid_raw` numerical
gradients against `grid_raw_tpu`'s analytic ones, a table layout, a tap
stride, a grid's rows) on the built-in synthetic scene or a scene
directory, through the port's launcher.build_datasets, Trainer and
evaluator. `--steps 0` reports the initial state's metrics. Runs on the
card unless `--cpu` is given:

    python -m multimodalstudio_tpu_torch.scripts.quality_check --method grid_raw_tpu \\
        --steps 2000 --scene synthetic --modalities rgb mono [--out report.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--method", default="grid_raw_tpu")
    parser.add_argument("--scene", default="synthetic")
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--modalities", nargs="+", default=None)
    parser.add_argument("--rays", type=int, default=512)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    parser.add_argument("--out", default=None)
    parser.add_argument("--layout", default=None, choices=["vertex", "cell"],
                        help="override the slot-grid table layout (grid methods)")
    parser.add_argument("--tap-stride", type=int, default=None,
                        help="override surface.curvature_tap_stride")
    parser.add_argument("--grid-rows", type=int, default=None,
                        help="override slot-grid rows_per_level")
    parser.add_argument("--seed", type=int, default=None,
                        help="override config.seed (trajectory-variance estimates)")
    return parser.parse_args(argv)


def build_config(args):
    """The registered method with the harness's overrides (quality_check.py:63-112)."""
    from multimodalstudio_tpu_torch.configs.config import load_config

    config = load_config(None, method=args.method)
    config = dataclasses.replace(
        config, max_num_iterations=args.steps, steps_per_eval_batch=0, steps_per_eval_image=0,
        steps_per_eval_all_images=0, steps_per_save=args.steps, steps_per_export_mesh=0,
        steps_per_export_poses=0)
    if args.seed is not None:
        config = dataclasses.replace(config, seed=args.seed)
    if args.modalities:
        config = dataclasses.replace(config, modalities=tuple(args.modalities))
    config = dataclasses.replace(
        config,
        datamanager=dataclasses.replace(
            config.datamanager, num_rays_per_modality=args.rays,
            microbatch_rays=min(config.datamanager.microbatch_rays or args.rays, args.rays)),
        evaluator=dataclasses.replace(config.evaluator, eval_num_rays_per_chunk=4096,
                                      rendering_scale=0.5, export_mesh=False,
                                      export_poses=False),
        logging=dataclasses.replace(config.logging, steps_per_log=max(args.steps // 10, 1)),
    )
    if args.layout or args.tap_stride or args.grid_rows:
        surface = config.model.surface
        if args.tap_stride:
            surface = dataclasses.replace(surface, curvature_tap_stride=args.tap_stride)
        if args.layout or args.grid_rows:
            sf = surface.surface_field
            enc = sf.field.grid.encoding
            enc = dataclasses.replace(enc, layout=args.layout or enc.layout,
                                      rows_per_level=args.grid_rows or enc.rows_per_level)
            grid = dataclasses.replace(sf.field.grid, encoding=enc)
            surface = dataclasses.replace(surface, surface_field=dataclasses.replace(
                sf, field=dataclasses.replace(sf.field, grid=grid)))
        config = dataclasses.replace(config, model=dataclasses.replace(config.model,
                                                                       surface=surface))
    return config


def main(argv=None) -> dict:
    """Train, evaluate, print the report (and write it to --out); returns it."""
    from multimodalstudio_tpu_torch.engine.trainer import Trainer
    from multimodalstudio_tpu_torch.launcher import build_datasets, resolve_model_channels

    args = parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    config = build_config(args)
    train_ds, eval_ds = build_datasets(config, args.scene, device=device)
    config = resolve_model_channels(config, train_ds)

    trainer = Trainer(config, train_ds, eval_ds, output_dir=None, device=device)
    trainer.setup()
    t0 = time.time()
    trainer.train()
    train_time = time.time() - t0

    results = trainer.evaluator.render_all_eval_views(trainer.state)
    report = {
        "method": args.method,
        "steps": args.steps,
        "train_seconds": round(train_time, 1),
        "rays_per_sec": round(args.steps * args.rays * len(config.modalities) / train_time),
        "metrics": {m: {k: round(v, 3) for k, v in r.items()} for m, r in results.items()},
    }
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
