"""Card against CPU on one training microbatch of a reference label, with the CPU run given
the card's NeuS samples (so no importance sample can move), and without.

On a card, from the repository root; labels are chip_smoke.CONFIGS's:

    python3 chip_probes/sampler_replay.py LABEL [LABEL ...]
"""
import dataclasses
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as C  # noqa: E402
import multimodalstudio_tpu_torch.models.model as model_mod  # noqa: E402
from multimodalstudio_tpu_torch.configs.methods import FIVE_MODALITIES  # noqa: E402
from multimodalstudio_tpu_torch.data.device_cache import sample_pixel_batch  # noqa: E402
from multimodalstudio_tpu_torch.device import set_reference_precision  # noqa: E402
from multimodalstudio_tpu_torch.engine import train as T  # noqa: E402
from multimodalstudio_tpu_torch.models.model import MMSModel  # noqa: E402
from multimodalstudio_tpu_torch.core.rays import samples_from_bins  # noqa: E402
from multimodalstudio_tpu_torch.models.samplers import spacing_to_euclidean  # noqa: E402

set_reference_precision()
card = C.card_line()
print(card)
dev = torch.device("cuda")
orig = model_mod.neus_sampling
recorded = []
mode = {"m": "plain"}


def sampling(*args, **kw):
    out = orig(*args, **kw)
    if mode["m"] == "record":
        recorded.append(out)
    elif mode["m"] == "replay":
        rec = recorded[0]
        rays = args[0]
        bins = torch.cat([rec.spacing_starts, rec.spacing_ends[:, -1:]], -1).detach().cpu()
        out = samples_from_bins(rays, spacing_to_euclidean(bins, rays.nears, rays.fars,
                                                           "uniform"), bins)
    return out


model_mod.neus_sampling = sampling
for label in sys.argv[1:]:
    (cfg, model, cams, state, cache, gen, _), stats = C.timed_training(dev, card, label, 1)
    small = dataclasses.replace(cfg, datamanager=dataclasses.replace(
        cfg.datamanager, num_rays_per_modality=64, microbatch_rays=0))
    batch = sample_pixel_batch(cache, gen, 64, FIVE_MODALITIES)
    sched = T.make_schedules(small, state.step)
    run = lambda m, c, p, b: T.batch_loss_and_grads(small, m, c, p, b, state.step, sched)  # noqa
    mode["m"] = "record"
    gpu = run(model, cams, state.camera_poses, batch)
    cpu_model = MMSModel(cfg.model, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_cams = {m: dataclasses.replace(c, **{k: getattr(c, k).cpu() for k in
                                             ("fx", "fy", "cx", "cy", "camera_to_worlds")})
                for m, c in cams.items()}
    cpu_poses = {m: p.detach().cpu().requires_grad_(True) for m, p in state.camera_poses.items()}
    cpu_batch = {m: dataclasses.replace(b, **{f.name: getattr(b, f.name).cpu()
                                              for f in dataclasses.fields(b)})
                 for m, b in batch.items()}
    mode["m"] = "replay"
    replay = run(cpu_model, cpu_cams, cpu_poses, cpu_batch)
    saved = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    noise = torch.Generator().manual_seed(0)
    moved = []
    for _ in range(3):
        cpu_model.load_state_dict({k: v * (1 + 1e-6 * torch.randn(v.shape, generator=noise))
                                   for k, v in saved.items()})
        moved.append(run(cpu_model, cpu_cams, cpu_poses, cpu_batch))
    cpu_model.load_state_dict(saved)
    recorded.clear()
    mode["m"] = "plain"
    cpu = run(cpu_model, cpu_cams, cpu_poses, cpu_batch)
    pf = lambda r: torch.cat([v.reshape(-1).cpu() for v in r[3]["camera_poses"].values()])  # noqa
    print(f"{label} poses: card-cpu {C.rel_l2(pf(gpu), pf(cpu)):.3e}, on the card's bins "
          f"{C.rel_l2(pf(gpu), pf(replay)):.3e}, moved on the card's bins "
          + " ".join(f"{C.rel_l2(pf(m), pf(replay)):.3e}" for m in moved))
    print(f"{label} loss: card {float(gpu[0])!r} cpu {float(cpu[0])!r} on the card's bins "
          f"{float(replay[0])!r}")
    for m in FIVE_MODALITIES:
        g = gpu[3]["camera_poses"][m].cpu()
        print(f"{label} poses {m}: card-cpu {C.rel_l2(g, cpu[3]['camera_poses'][m]):.3e}, card-cpu "
              f"on the card's samples {C.rel_l2(g, replay[3]['camera_poses'][m]):.3e}, per camera "
              + " ".join(f"{float((g - cpu[3]['camera_poses'][m])[i].norm()):.2e}/"
                         f"{float(g[i].norm()):.2e}" for i in range(g.shape[0])))
    groups = C._param_groups(cpu[3]["fields"])
    for name, keys in groups.items():
        f = lambda r: torch.cat([r[3]["fields"][k].reshape(-1).cpu() for k in keys])  # noqa
        print(f"{label} {name}: card-cpu {C.rel_l2(f(gpu), f(cpu)):.3e}, on the card's samples "
              f"{C.rel_l2(f(gpu), f(replay)):.3e}, moved "
              + " ".join(f"{C.rel_l2(f(m), f(replay)):.2e}" for m in moved))
