"""Noise of the reference labels' training microbatch: the card against itself (3 runs),
the CPU against itself under 1e-6 parameter moves (8 draws), and the card against the CPU.

On a card, from the repository root; labels are chip_smoke.CONFIGS's:

    python3 chip_probes/microbatch_noise.py LABEL [LABEL ...]
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

set_reference_precision()
card = C.card_line()
print(card)
dev = torch.device("cuda")
for label in sys.argv[1:]:
    (cfg, model, cams, state, cache, gen, _), stats = C.timed_training(dev, card, label, 1)
    small = dataclasses.replace(cfg, datamanager=dataclasses.replace(
        cfg.datamanager, num_rays_per_modality=64, microbatch_rays=0))
    batch = sample_pixel_batch(cache, gen, 64, FIVE_MODALITIES)
    sched = T.make_schedules(small, state.step)
    run = lambda m, c, p, b: T.batch_loss_and_grads(small, m, c, p, b, state.step, sched)  # noqa
    gpu = [run(model, cams, state.camera_poses, batch) for _ in range(3)]
    cpu_model = MMSModel(cfg.model, device="cpu")
    saved = {k: v.cpu() for k, v in model.state_dict().items()}
    cpu_model.load_state_dict(saved)
    cpu_cams = {m: dataclasses.replace(c, **{k: getattr(c, k).cpu() for k in
                                             ("fx", "fy", "cx", "cy", "camera_to_worlds")})
                for m, c in cams.items()}
    cpu_poses = {m: p.detach().cpu().requires_grad_(True) for m, p in state.camera_poses.items()}
    cpu_batch = {m: dataclasses.replace(b, **{f.name: getattr(b, f.name).cpu()
                                              for f in dataclasses.fields(b)})
                 for m, b in batch.items()}
    cpu = run(cpu_model, cpu_cams, cpu_poses, cpu_batch)
    noise = torch.Generator().manual_seed(0)
    moved = []
    for _ in range(8):
        cpu_model.load_state_dict({k: v * (1 + 1e-6 * torch.randn(v.shape, generator=noise))
                                   for k, v in saved.items()})
        moved.append(run(cpu_model, cpu_cams, cpu_poses, cpu_batch))
    groups = C._param_groups(cpu[3]["fields"])
    groups["camera_poses"] = None

    def flat(r, keys):
        return torch.cat([g.reshape(-1).cpu() for g in (
            r[3]["camera_poses"].values() if keys is None else [r[3]["fields"][k] for k in keys])])

    for name, keys in groups.items():
        c = flat(cpu, keys)
        print(f"{label} {name}: card-cpu {C.rel_l2(flat(gpu[0], keys), c):.3e}, card-card "
              f"{max(C.rel_l2(flat(g, keys), flat(gpu[0], keys)) for g in gpu[1:]):.3e}, "
              "cpu moved " + " ".join(f"{C.rel_l2(flat(m, keys), c):.2e}" for m in moved))
    print(f"{label} loss: card {float(gpu[0][0])!r} {float(gpu[1][0])!r} cpu {float(cpu[0])!r}")
