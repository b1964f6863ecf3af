"""What parts VOLSDF_LABEL's slot-table gradient between card and CPU: chip_smoke's 64-ray
microbatch after the label's timed training (the same state as chip_smoke's), run through
the kernels and through their plain versions on the card, each twice (the table gradients
are sums by atomics); through the plain versions on the card with torch's deterministic
algorithms; on the CPU at its default thread count and at one thread; on the CPU given the
card's NeuS bins (so no sample moves); and the CPU with its parameters moved by 1e-5. Prints
rel-L2 of every gradient group for each pair, and the largest move of the bins. Ends with
chip_smoke.time_capture_decode.

On a card, from the repository root:

    python3 chip_probes/volsdf_table_cause.py
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
print(f"built kernels in {build.build_all():.1f} s; CPU threads {torch.get_num_threads()}")
dev = torch.device("cuda")
label = C.VOLSDF_LABEL
orig = model_mod.neus_sampling
bins = {}
mode = {"record": None, "replay": None}


def sampling(rays, *args, **kw):
    out = orig(rays, *args, **kw)
    if mode["record"]:
        bins[mode["record"]] = torch.cat([out.spacing_starts, out.spacing_ends[:, -1:]], -1)
    if mode["replay"]:
        b = bins[mode["replay"]].detach().to(rays.origins.device)
        out = samples_from_bins(rays, spacing_to_euclidean(b, rays.nears, rays.fars, "uniform"), b)
    return out


model_mod.neus_sampling = sampling


def to_cpu(tree):
    return {k: dataclasses.replace(v, **{f.name: getattr(v, f.name).cpu()
                                         for f in dataclasses.fields(v)}) for k, v in tree.items()}


with C.config_env(label):
    (cfg, model, cams, state, cache, gen, _), _ = C.timed_training(dev, card, label)
    small = dataclasses.replace(cfg, datamanager=dataclasses.replace(
        cfg.datamanager, num_rays_per_modality=64, microbatch_rays=0))
    batch = sample_pixel_batch(cache, gen, 64, FIVE_MODALITIES)
    sched = T.make_schedules(small, state.step)
    cpu_model = MMSModel(cfg.model, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    C.fixed_background_colours(model, cpu_model)
    cpu_cams = {m: dataclasses.replace(c, **{k: getattr(c, k).cpu() for k in
                                             ("fx", "fy", "cx", "cy", "camera_to_worlds")})
                for m, c in cams.items()}
    cpu_poses = {m: p.detach().cpu().requires_grad_(True) for m, p in state.camera_poses.items()}
    cpu_batch = to_cpu(batch)

    def on_card(record=None):
        mode["record"] = record
        out = T.batch_loss_and_grads(small, model, cams, state.camera_poses, batch, state.step,
                                     sched)
        mode["record"] = None
        return out

    def on_cpu(record=None, replay=None):
        mode["record"], mode["replay"] = record, replay
        out = T.batch_loss_and_grads(small, cpu_model, cpu_cams, cpu_poses, cpu_batch, state.step,
                                     sched)
        mode["record"] = mode["replay"] = None
        return out

    runs = {"kernels": on_card("kernels"), "kernels again": on_card()}
    with C.plain_kernel_calls():
        runs["plain, card"] = on_card("plain, card")
        runs["plain, card again"] = on_card()
        torch.use_deterministic_algorithms(True, warn_only=True)
        runs["plain, card, deterministic"] = on_card()
        torch.use_deterministic_algorithms(False)
    runs["CPU"] = on_cpu("CPU")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    runs["CPU, 1 thread"] = on_cpu()
    torch.set_num_threads(threads)
    runs["CPU on the plain card bins"] = on_cpu(replay="plain, card")
    runs["CPU on the kernels' bins"] = on_cpu(replay="kernels")
    saved = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    noise = torch.Generator().manual_seed(C.SEED)
    cpu_model.load_state_dict({k: v * (1 + 1e-5 * torch.randn(v.shape, generator=noise))
                               for k, v in saved.items()})
    runs["CPU moved 1e-5"] = on_cpu()
    runs["CPU moved 1e-5 on the plain card bins"] = on_cpu(replay="plain, card")
    cpu_model.load_state_dict(saved)

for a in ("kernels", "plain, card"):
    print(f"bins of {a} against the CPU's: max |difference| "
          f"{float((bins[a].cpu() - bins['CPU']).abs().max()):.3e}")
groups = C._param_groups(runs["CPU"][3]["fields"])
groups["camera_poses"] = None


def flat(run, keys):
    vals = (run[3]["camera_poses"].values() if keys is None
            else [run[3]["fields"][k] for k in keys])
    return torch.cat([g.reshape(-1).float().cpu() for g in vals])


pairs = (("kernels", "kernels again"), ("plain, card", "plain, card again"),
         ("plain, card, deterministic", "plain, card"), ("plain, card", "CPU"),
         ("plain, card, deterministic", "CPU"), ("CPU, 1 thread", "CPU"),
         ("plain, card", "CPU on the plain card bins"), ("kernels", "CPU on the kernels' bins"),
         ("kernels", "CPU"), ("CPU on the plain card bins", "CPU"), ("CPU moved 1e-5", "CPU"),
         ("CPU moved 1e-5 on the plain card bins", "CPU on the plain card bins"))
print(f"{label} at step {state.step}: rel-L2 of each gradient group ({card})")
for name, keys in groups.items():
    ref = flat(runs["CPU"], keys)
    print(f"  {name} (norm {float(ref.norm()):.3e}): " + ", ".join(
        f"{a} vs {b} {C.rel_l2(flat(runs[a], keys), flat(runs[b], keys)):.3e}" for a, b in pairs))
C.time_capture_decode(card)
print("done")
