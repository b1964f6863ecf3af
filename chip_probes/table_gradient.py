"""Where a label's microbatch gradients part card and CPU: chip_smoke's 64-ray microbatch
after the label's timed training, through the kernels on the card, through their plain
versions on the card (chip_smoke.plain_kernel_calls) and through the plain versions on the
CPU; rel-L2 of each gradient group between the three, and the CPU run against itself with
its parameters moved by 1e-5 and 1e-4.

On a card, from the repository root; labels are chip_smoke.CONFIGS's:

    python3 chip_probes/table_gradient.py [LABEL ...]  (grid_raw_tpu and VOLSDF_LABEL by default)
"""
import dataclasses
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as C  # noqa: E402
from multimodalstudio_tpu_torch.configs.methods import FIVE_MODALITIES  # noqa: E402
from multimodalstudio_tpu_torch.data.device_cache import sample_pixel_batch  # noqa: E402
from multimodalstudio_tpu_torch.device import set_reference_precision  # noqa: E402
from multimodalstudio_tpu_torch.engine import train as T  # noqa: E402
from multimodalstudio_tpu_torch.models.model import MMSModel  # noqa: E402
from multimodalstudio_tpu_torch.ops.kernels import build  # noqa: E402

set_reference_precision()
card = C.card_line()
print(card)
print(f"built kernels in {build.build_all():.1f} s")
dev = torch.device("cuda")


def to_cpu(tree):
    return {k: dataclasses.replace(v, **{f.name: getattr(v, f.name).cpu()
                                         for f in dataclasses.fields(v)}) for k, v in tree.items()}


for label in sys.argv[1:] or ("grid_raw_tpu", C.VOLSDF_LABEL):
    with C.config_env(label):
        (cfg, model, cams, state, cache, gen, _), _ = C.timed_training(dev, card, label)
        small = dataclasses.replace(cfg, datamanager=dataclasses.replace(
            cfg.datamanager, num_rays_per_modality=64, microbatch_rays=0))
        batch = sample_pixel_batch(cache, gen, 64, FIVE_MODALITIES)
        sched = T.make_schedules(small, state.step)
        cpu_model = MMSModel(cfg.model, device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        if cfg.model.background_color == "random":
            C.fixed_background_colours(model, cpu_model)
        cpu_cams = {m: dataclasses.replace(c, **{k: getattr(c, k).cpu() for k in
                                                 ("fx", "fy", "cx", "cy", "camera_to_worlds")})
                    for m, c in cams.items()}
        cpu_poses = {m: p.detach().cpu().requires_grad_(True)
                     for m, p in state.camera_poses.items()}
        runs = {"kernels": T.batch_loss_and_grads(small, model, cams, state.camera_poses, batch,
                                                  state.step, sched)}
        with C.plain_kernel_calls():
            runs["plain, card"] = T.batch_loss_and_grads(small, model, cams, state.camera_poses,
                                                         batch, state.step, sched)
        cpu_batch = to_cpu(batch)
        runs["plain, CPU"] = T.batch_loss_and_grads(small, cpu_model, cpu_cams, cpu_poses,
                                                    cpu_batch, state.step, sched)
        saved = {k: v.clone() for k, v in cpu_model.state_dict().items()}
        for move in (1e-5, 1e-4):
            noise = torch.Generator().manual_seed(C.SEED)
            cpu_model.load_state_dict({k: v * (1 + move * torch.randn(v.shape, generator=noise))
                                       for k, v in saved.items()})
            runs[f"CPU moved {move:g}"] = T.batch_loss_and_grads(
                small, cpu_model, cpu_cams, cpu_poses, cpu_batch, state.step, sched)
        cpu_model.load_state_dict(saved)
    groups = C._param_groups(runs["plain, CPU"][3]["fields"])
    groups["camera_poses"] = None

    def flat(run, keys):
        vals = (run[3]["camera_poses"].values() if keys is None
                else [run[3]["fields"][k] for k in keys])
        return torch.cat([g.reshape(-1).float().cpu() for g in vals])

    pairs = (("kernels", "plain, CPU"), ("plain, card", "plain, CPU"), ("kernels", "plain, card"),
             ("CPU moved 1e-05", "plain, CPU"), ("CPU moved 0.0001", "plain, CPU"))
    print(f"{label} at step {state.step}: rel-L2 of each gradient group ({card})")
    for name, keys in groups.items():
        ref = flat(runs["plain, CPU"], keys)
        print(f"  {name} (norm {float(ref.norm()):.3e}): " + ", ".join(
            f"{a} vs {b} {C.rel_l2(flat(runs[a], keys), flat(runs[b], keys)):.3e}"
            for a, b in pairs))
print("done")
