"""One process of the data-parallel dry run (started by dist_dryrun.py, or
by hand with the process group's environment, parallel/sharding.py):

    MMS_COORDINATOR=127.0.0.1:<port> MMS_NUM_PROCESSES=2 MMS_PROCESS_ID=<rank> \\
        python -m multimodalstudio_tpu_torch.scripts.dist_dryrun_worker --device cpu --out <dir>

Joins the group (gloo on the CPU, nccl on a card), trains a narrow
grid_raw_tpu on a small synthetic raw scene through the port's Trainer with
n_devices = the world size (the device cache, each step's global batch
split over the ranks), then prints `FINAL_LOSS <loss>`,
`PARAMS_SHA256 <digest of every parameter's bytes>` and `SAVES <the
checkpoints this rank wrote>`: dist_dryrun.py holds the first two equal
across the ranks, and the run's one checkpoint to rank 0.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import os
from typing import List, Optional

import torch

MODS = ("rgb", "polarization", "mono")


def tiny_config(steps: int = 4, rays: int = 8, microbatch: int = 4):
    """grid_raw_tpu cut to CPU size: a 3-level slot grid of 64 rows, hidden
    widths 128, 8 + 8 NeuS and 4 background samples, 3 modalities, `rays`
    per modality in microbatches of `microbatch`, no host cadence but the
    log and the final save."""
    from multimodalstudio_tpu_torch.configs.methods import method_configs
    from multimodalstudio_tpu_torch.models import samplers
    from multimodalstudio_tpu_torch.ops.kernels.slot_grid import SlotGridSpec

    rp = dataclasses.replace
    cfg = method_configs()["grid_raw_tpu"]
    m = cfg.model

    def narrow(mlp):
        return rp(mlp, hidden_dim=128) if mlp.hidden_dim == 256 else mlp

    sf = m.surface.surface_field
    grid = rp(sf.field.grid, encoding=SlotGridSpec(
        num_levels=3, min_res=4, max_res=16, rows_per_level=64, layout="cell", feats=2,
        table_dtype="bf16"))
    surface = rp(m.surface, sampler_levels=2,
                 surface_field=rp(sf, geo_feature_dim=64, field=rp(sf.field, grid=grid)))
    rf = m.radiance.radiance_field
    radiance = rp(m.radiance, radiance_feature_dim=128, radiance_field=rp(
        rf, base_field=rp(rf.base_field, mlp=narrow(rf.base_field.mlp))))
    bf = m.background.field
    background = rp(m.background, field=rp(
        bf, base_output_dim=128, base_field=rp(bf.base_field, mlp=narrow(bf.base_field.mlp))))
    model = rp(
        m, modalities=tuple((k, c) for k, c in m.modalities if k in MODS),
        heads=tuple((k, rp(h, mlp=narrow(h.mlp))) for k, h in m.heads),
        surface=surface, radiance=radiance, background=background,
        ray_sampler=samplers.NeuSSamplerSpec(num_samples=8, num_samples_importance=8,
                                             num_upsample_steps=2),
        background_ray_sampler=samplers.SpacedSamplerSpec(num_samples=4,
                                                          spacing="lin_disparity"),
    )
    return rp(cfg, model=model, modalities=MODS, max_num_iterations=steps,
              datamanager=rp(cfg.datamanager, num_rays_per_modality=rays,
                             microbatch_rays=microbatch),
              steps_per_eval_batch=0, steps_per_eval_image=0, steps_per_eval_all_images=0,
              steps_per_save=0, steps_per_export_mesh=0, steps_per_export_poses=0,
              logging=rp(cfg.logging, steps_per_log=2, steps_per_flush_buffer=0,
                         local_writer=False, vis="none"))


def params_digest(trainer) -> str:
    """sha256 of every parameter's and camera pose's bytes, in name order."""
    h = hashlib.sha256()
    tensors = dict(trainer.model.named_parameters())
    tensors.update({f"camera_poses.{k}": v for k, v in trainer.state.camera_poses.items()})
    for name in sorted(tensors):
        h.update(name.encode())
        h.update(tensors[name].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def counting_saves():
    """The checkpoints this process writes inside the block, as a list of their paths."""
    from multimodalstudio_tpu_torch.engine import checkpoints

    saves: List[str] = []
    real = checkpoints.save_checkpoint

    def counted(*args, **kwargs):
        saves.append(args[0])
        return real(*args, **kwargs)

    checkpoints.save_checkpoint = counted
    try:
        yield saves
    finally:
        checkpoints.save_checkpoint = real


def train(out_dir: Optional[str], device, config=None, datasets=None):
    """The Trainer on `datasets` (train, eval), by default a 3-view 8 x 8 raw scene of
    the config's modalities; returns it trained and the checkpoints this rank wrote."""
    from multimodalstudio_tpu_torch.data.synthetic import make_synthetic_dataset
    from multimodalstudio_tpu_torch.engine.trainer import Trainer

    config = config or tiny_config()
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
    if datasets is None:
        kw = dict(num_views=3, height=8, width=8, raw=True, device=device)
        datasets = (make_synthetic_dataset(config.modalities, **kw),
                    make_synthetic_dataset(config.modalities, view_ids=[0], **kw))
    trainer = Trainer(config, *datasets, out_dir, device=device)
    trainer.setup()
    with counting_saves() as saves:
        trainer.train()
    return trainer, saves


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="one process of the data-parallel dry run")
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    parser.add_argument("--out", default=None, help="the run's output directory")
    args = parser.parse_args(argv)

    from multimodalstudio_tpu_torch.parallel import sharding

    if not sharding.initialize_distributed(device=args.device):
        raise SystemExit("MMS_COORDINATOR, MMS_NUM_PROCESSES and MMS_PROCESS_ID must name a "
                         "group of more than one process")
    torch.set_num_threads(1)
    try:
        device = sharding.bind_device(args.device)
        trainer, saves = train(args.out, device)
        loss = float(trainer.last_aux["losses"]["total_loss"])
        print(f"FINAL_LOSS {loss:.9g}", flush=True)
        print(f"PARAMS_SHA256 {params_digest(trainer)}", flush=True)
        print(f"SAVES {len(saves)}", flush=True)
        print(f"rank {sharding.process_index()} done at step {trainer.state.step}", flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
