"""Where in the model VOLSDF_LABEL's slot-table gradient parts card and CPU: chip_smoke's
64-ray microbatch after the label's timed training, through the plain versions on the card
and on the CPU given the card's NeuS bins, and on the CPU with its parameters moved by 1e-5
(on the same bins). Records the model's intermediate tensors (the box collider's nears and
fars, the SDF field's sdf, features, gradients and hessians, the Laplace densities, the
weights, each modality's radiance) and the gradient of the loss reaching each, and prints
rel-L2 card against CPU beside the moved CPU against CPU for each, and the same for every
gradient group.

On a card, from the repository root:

    python3 chip_probes/volsdf_table_localize.py
"""
import dataclasses
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as C  # noqa: E402
import multimodalstudio_tpu_torch.models.model as model_mod  # noqa: E402
from multimodalstudio_tpu_torch.configs.methods import FIVE_MODALITIES  # noqa: E402
from multimodalstudio_tpu_torch.core.rays import samples_from_bins  # noqa: E402
from multimodalstudio_tpu_torch.data.device_cache import sample_pixel_batch  # noqa: E402
from multimodalstudio_tpu_torch.device import set_reference_precision  # noqa: E402
from multimodalstudio_tpu_torch.engine import train as T  # noqa: E402
from multimodalstudio_tpu_torch.models.model import MMSModel  # noqa: E402
from multimodalstudio_tpu_torch.models.samplers import spacing_to_euclidean  # noqa: E402
from multimodalstudio_tpu_torch.ops.kernels import build  # noqa: E402

set_reference_precision()
card = C.card_line()
print(card)
print(f"built kernels in {build.build_all():.1f} s")
dev = torch.device("cuda")
label = C.VOLSDF_LABEL
rec = {"on": None, "bins": None}
vals, grads = {}, {}


def keep(name, t):
    """Record t's value, and the gradient reaching it, under the current run's name."""
    run = rec["on"]
    if run is None or not torch.is_tensor(t):
        return
    vals.setdefault(run, {})[name] = t.detach().float().cpu()
    if t.requires_grad:
        t.register_hook(lambda g: grads.setdefault(run, {}).__setitem__(name, g.float().cpu()))


def wrap(fn, names):
    def call(*args, **kw):
        out = fn(*args, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        for n, o in zip(names, outs):
            keep(n, o)
        return out
    return call


orig_sampling, orig_box = model_mod.neus_sampling, model_mod.box_collide


def sampling(rays, *args, **kw):
    out = orig_sampling(rays, *args, **kw)
    if rec["on"] is None:  # the timed training
        return out
    if rec["bins"] is None:
        rec["bins"] = torch.cat([out.spacing_starts, out.spacing_ends[:, -1:]], -1).detach()
    b = rec["bins"].to(rays.origins.device)
    return samples_from_bins(rays, spacing_to_euclidean(b, rays.nears, rays.fars, "uniform"), b)


def box(rays, aabb):
    collided, mask = orig_box(rays, aabb)
    keep("nears", collided.nears)
    keep("fars", collided.fars)
    keep("mask", mask.float())
    return collided, mask


model_mod.neus_sampling = sampling
model_mod.box_collide = box
model_mod.laplace_density = wrap(model_mod.laplace_density, ["density"])
model_mod.weights_from_densities = wrap(model_mod.weights_from_densities, ["weights"])


def instrument(model):
    model.sdf_gradients = wrap(model.sdf_gradients, ["sdf", "geo", "gradients", "hessians"])
    radiance = model._radiance_forward

    def radiance_forward(*args, **kw):
        out = radiance(*args, **kw)
        for m, v in out.items():
            keep(f"radiance {m}", v)
        return out
    model._radiance_forward = radiance_forward


with C.config_env(label):
    (cfg, model, cams, state, cache, gen, _), _ = C.timed_training(dev, card, label)
    small = dataclasses.replace(cfg, datamanager=dataclasses.replace(
        cfg.datamanager, num_rays_per_modality=64, microbatch_rays=0))
    batch = sample_pixel_batch(cache, gen, 64, FIVE_MODALITIES)
    sched = T.make_schedules(small, state.step)
    cpu_model = MMSModel(cfg.model, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    C.fixed_background_colours(model, cpu_model)
    instrument(model)
    instrument(cpu_model)
    cpu_cams = {m: dataclasses.replace(c, **{k: getattr(c, k).cpu() for k in
                                             ("fx", "fy", "cx", "cy", "camera_to_worlds")})
                for m, c in cams.items()}
    cpu_poses = {m: p.detach().cpu().requires_grad_(True) for m, p in state.camera_poses.items()}
    cpu_batch = {m: dataclasses.replace(b, **{f.name: getattr(b, f.name).cpu()
                                              for f in dataclasses.fields(b)})
                 for m, b in batch.items()}
    runs = {}
    rec["on"] = "card"
    with C.plain_kernel_calls():
        runs["card"] = T.batch_loss_and_grads(small, model, cams, state.camera_poses, batch,
                                              state.step, sched)
    rec["on"] = "CPU"
    runs["CPU"] = T.batch_loss_and_grads(small, cpu_model, cpu_cams, cpu_poses, cpu_batch,
                                         state.step, sched)
    noise = torch.Generator().manual_seed(C.SEED)
    cpu_model.load_state_dict({k: v * (1 + 1e-5 * torch.randn(v.shape, generator=noise))
                               for k, v in cpu_model.state_dict().items()})
    rec["on"] = "moved"
    runs["moved"] = T.batch_loss_and_grads(small, cpu_model, cpu_cams, cpu_poses, cpu_batch,
                                           state.step, sched)
    rec["on"] = None

print(f"{label} at step {state.step}, the plain versions, the card's bins on both "
      f"({card}): rel-L2 card vs CPU | CPU moved 1e-5 vs CPU | max |card - CPU| at")
for kind, table in (("value", vals), ("gradient", grads)):
    for name, ref in table["CPU"].items():
        a, m = table["card"].get(name), table["moved"].get(name)
        if a is None or a.shape != ref.shape:
            print(f"  {kind} of {name}: card {None if a is None else tuple(a.shape)}, "
                  f"CPU {tuple(ref.shape)}")
            continue
        d = (a - ref).abs()
        at = tuple(int(i) for i in torch.unravel_index(d.argmax(), d.shape))
        print(f"  {kind} of {name} {tuple(ref.shape)} (norm {float(ref.norm()):.3e}): "
              f"{C.rel_l2(a, ref):.3e} | {C.rel_l2(m, ref):.3e} | {float(d.max()):.3e} at {at} "
              f"(card {float(a[at]):.6g}, CPU {float(ref[at]):.6g})")
groups = C._param_groups(runs["CPU"][3]["fields"])
for name, keys in groups.items():
    f = lambda r: torch.cat([r[3]["fields"][k].reshape(-1).float().cpu() for k in keys])  # noqa
    print(f"  gradient group {name}: {C.rel_l2(f(runs['card']), f(runs['CPU'])):.3e} | "
          f"{C.rel_l2(f(runs['moved']), f(runs['CPU'])):.3e}")
table = [k for k in runs["CPU"][3]["fields"] if k.endswith("table")][0]
a, b = runs["card"][3]["fields"][table].float().cpu(), runs["CPU"][3]["fields"][table].float()
d = (a - b).abs().sum(-1)
rows = torch.argsort(d, descending=True)[:8]
print(f"  table {table} {tuple(b.shape)}: {int((b.abs().sum(-1) > 0).sum())} rows with a "
      f"gradient; the rows parting most: " + ", ".join(
          f"{int(r)} (|d| {float(d[r]):.2e}, |CPU row| {float(b[r].abs().sum()):.2e})"
          for r in rows))
print(f"  losses card vs CPU: " + ", ".join(
    f"{k} {float(runs['card'][1][k]):.8g}/{float(runs['CPU'][1][k]):.8g}" for k in runs["CPU"][1]))
print("done")
