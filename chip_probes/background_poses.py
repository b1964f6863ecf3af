"""Where the card and the CPU part on a reference label's camera-pose gradient: the same
microbatch with the background off, and the background NeRF field alone on one microbatch's
background samples (gradients with respect to its positions and directions).

On a card, from the repository root; labels are chip_smoke.CONFIGS's:

    python3 chip_probes/background_poses.py LABEL
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
from multimodalstudio_tpu_torch.ops.math import scene_contraction  # noqa: E402

set_reference_precision()
card = C.card_line()
print(card)
dev = torch.device("cuda")
label = sys.argv[1]
(cfg, model, cams, state, cache, gen, _), stats = C.timed_training(dev, card, label, 1)
small = dataclasses.replace(cfg, datamanager=dataclasses.replace(
    cfg.datamanager, num_rays_per_modality=64, microbatch_rays=0))
batch = sample_pixel_batch(cache, gen, 64, FIVE_MODALITIES)
sched = T.make_schedules(small, state.step)
cpu_cams = {m: dataclasses.replace(c, **{k: getattr(c, k).cpu() for k in
                                         ("fx", "fy", "cx", "cy", "camera_to_worlds")})
            for m, c in cams.items()}
cpu_batch = {m: dataclasses.replace(b, **{f.name: getattr(b, f.name).cpu()
                                          for f in dataclasses.fields(b)})
             for m, b in batch.items()}
pf = lambda r: torch.cat([v.reshape(-1).cpu() for v in r[3]["camera_poses"].values()])  # noqa
recorded = []
for use_bg in (True, False):
    c2 = dataclasses.replace(small, model=dataclasses.replace(small.model, use_background=use_bg))
    m_card = MMSModel(c2.model, device=dev)
    m_card.load_state_dict(model.state_dict(), strict=False)
    m_cpu = MMSModel(c2.model, device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, strict=False)
    if use_bg:
        orig = m_card._background_forward

        def rec(samples, segments, aligned, _o=orig):
            recorded.append(samples)
            return _o(samples, segments, aligned)
        m_card._background_forward = rec
    poses = {m: p.detach().clone().requires_grad_(True) for m, p in state.camera_poses.items()}
    g = T.batch_loss_and_grads(c2, m_card, cams, poses, batch, state.step, sched)
    poses_c = {m: p.detach().cpu().requires_grad_(True) for m, p in state.camera_poses.items()}
    c = T.batch_loss_and_grads(c2, m_cpu, cpu_cams, poses_c, cpu_batch, state.step, sched)
    print(f"{label} use_background={use_bg}: poses card-cpu {C.rel_l2(pf(g), pf(c)):.3e}; " +
          " ".join(f"{m} {C.rel_l2(g[3]['camera_poses'][m].cpu(), c[3]['camera_poses'][m]):.2e}"
                   for m in FIVE_MODALITIES))

s = recorded[0]
pos = s.start_positions().reshape(-1, 3).detach()
n, k = s.num_rays, s.num_samples
dirs = s.directions[:, None, :].expand(n, k, 3).reshape(-1, 3).detach()
gen2 = torch.Generator().manual_seed(0)
outs = {}
for where in ("card", "cpu"):
    mdl = MMSModel(cfg.model, device=dev if where == "card" else "cpu")
    mdl.load_state_dict({kk: v.to(mdl.device) for kk, v in model.state_dict().items()})
    p = pos.to(mdl.device).clone().requires_grad_(True)
    d = dirs.to(mdl.device).clone().requires_grad_(True)
    q = scene_contraction(p, cfg.model.background.contraction_order)
    dens, feat = mdl.background_field(q, d)
    torch.manual_seed(1)
    r1 = torch.randn(dens.shape, generator=gen2.manual_seed(1)).to(mdl.device)
    r2 = torch.randn(feat.shape, generator=gen2.manual_seed(2)).to(mdl.device)
    ((dens * r1).sum() + (feat * r2).sum()).backward()
    outs[where] = (dens.detach().cpu(), feat.detach().cpu(), p.grad.cpu(), d.grad.cpu(),
                   q.detach().cpu())
a, b = outs["card"], outs["cpu"]
for name, x, y in zip(("density", "feature", "d pos", "d dir", "contracted"), a, b):
    per = (x - y).norm(dim=-1) / y.norm(dim=-1).clamp_min(1e-30)
    print(f"bg field {name}: rel_l2 {C.rel_l2(x, y):.3e}, worst sample {float(per.max()):.3e} "
          f"at {int(per.argmax())}, |pos| there {float(pos[int(per.argmax())].abs().max()):.4f}")
