"""Whether VOLSDF_LABEL's slot-table gradient parts card and CPU inside the slot SDF's
backward or in what reaches it: chip_smoke's 64-ray microbatch after the label's timed
training, through the plain versions on the card and on the CPU, recording every call of
the slot wrappers (fused_slot_sdf_chain, fused_slot_sdf_value) with its inputs and the
cotangents its outputs receive. Each call's table gradient is then recomputed by autograd
through the plain version from the card's inputs and cotangents on the card and on the CPU
(the operations alone), and on the CPU from the card's inputs with the CPU's cotangents and
from the CPU's inputs with the card's cotangents. Prints rel-L2 of each against the CPU
run's own, per call and summed over the calls.

On a card, from the repository root:

    python3 chip_probes/volsdf_table_replay.py
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

SLOT = ("fused_slot_sdf_chain", "fused_slot_sdf_value")


def recording_plain(calls):
    """The slot wrappers' plain versions, each call recorded as [name, args, kw, the
    cotangents of its outputs (filled in by hooks)]."""

    def plain(name, _):
        fn = C.plain_version(name)

        def call(*args, **kw):
            kw.pop("mode", None)
            out = fn(*args, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            entry = [name, args, kw, [None] * len(outs)]
            for i, o in enumerate(outs):
                if torch.is_tensor(o) and o.requires_grad:
                    o.register_hook(lambda g, i=i: entry[3].__setitem__(i, g.detach()))
            calls.append(entry)
            return out
        return call

    return C.wrappers_replaced(plain, SLOT)


def table_grad(name, args, kw, cots, device):
    """d table of one call through its plain version, its inputs and cotangents on device."""
    mv = lambda v: v.detach().to(device) if torch.is_tensor(v) else v  # noqa: E731
    args = [[mv(w) for w in a] if isinstance(a, (list, tuple)) else mv(a) for a in args]
    args[1] = args[1].clone().requires_grad_(True)
    kw = {k: mv(v) for k, v in kw.items()}
    out = C.plain_version(name)(*args, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    pairs = [(o, mv(g)) for o, g in zip(outs, cots) if g is not None and o.requires_grad]
    (g,) = torch.autograd.grad([o for o, _ in pairs], [args[1]], [g for _, g in pairs],
                               allow_unused=True)
    return torch.zeros_like(args[1]).float().cpu() if g is None else g.float().cpu()


def main():
    set_reference_precision()
    card = C.card_line()
    print(card)
    print(f"built kernels in {build.build_all():.1f} s")
    dev = torch.device("cuda")
    label = C.VOLSDF_LABEL
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
        cpu_poses = {m: p.detach().cpu().requires_grad_(True)
                     for m, p in state.camera_poses.items()}
        cpu_batch = {m: dataclasses.replace(b, **{f.name: getattr(b, f.name).cpu()
                                                  for f in dataclasses.fields(b)})
                     for m, b in batch.items()}
        on_card, on_cpu = [], []
        with recording_plain(on_card):
            gpu = T.batch_loss_and_grads(small, model, cams, state.camera_poses, batch,
                                         state.step, sched)
        with recording_plain(on_cpu):
            cpu = T.batch_loss_and_grads(small, cpu_model, cpu_cams, cpu_poses, cpu_batch,
                                         state.step, sched)

    key = [k for k in cpu[3]["fields"] if k.endswith("table")][0]
    whole_card, whole_cpu = gpu[3]["fields"][key].float().cpu(), cpu[3]["fields"][key].float()
    print(f"{label} at step {state.step} ({card}): the whole table gradient card vs CPU "
          f"{C.rel_l2(whole_card, whole_cpu):.3e} (norm {float(whole_cpu.norm()):.3e}); "
          f"{len(on_card)} slot calls on the card, {len(on_cpu)} on the CPU: "
          f"{[c[0] for c in on_card]}")
    sums = {k: torch.zeros_like(whole_cpu) for k in ("own card", "ops card", "ops CPU", "CPU",
                                                     "inputs card", "cotangents card")}
    for i, (cc, hc) in enumerate(zip(on_card, on_cpu)):
        name = cc[0]
        if hc[0] != name:
            print(f"  call {i}: {name} on the card, {hc[0]} on the CPU")
            continue
        got = {
            "own card": table_grad(name, cc[1], cc[2], cc[3], dev),
            "ops CPU": table_grad(name, cc[1], cc[2], cc[3], "cpu"),
            "CPU": table_grad(name, hc[1], hc[2], hc[3], "cpu"),
            "inputs card": table_grad(name, cc[1], cc[2], hc[3], "cpu"),
            "cotangents card": table_grad(name, hc[1], hc[2], cc[3], "cpu"),
        }
        got["ops card"] = got["own card"]
        for k, v in got.items():
            sums[k] += v.reshape(sums[k].shape)
        ref = got["CPU"]
        cot = ", ".join(f"{C.rel_l2(a.float().cpu(), b.float()):.2e}"
                        for a, b in zip(cc[3], hc[3]) if a is not None and b is not None)
        print(f"  call {i} {name} (d table norm {float(ref.norm()):.3e}; cotangents card vs CPU "
              f"{cot}): card's inputs and cotangents on the card vs on the CPU "
              f"{C.rel_l2(got['own card'], got['ops CPU']):.3e}; against the CPU's own: all card "
              f"{C.rel_l2(got['ops CPU'], ref):.3e}, card inputs "
              f"{C.rel_l2(got['inputs card'], ref):.3e}, card cotangents "
              f"{C.rel_l2(got['cotangents card'], ref):.3e}")
    print(f"  summed over the calls: CPU calls vs the CPU's table gradient "
          f"{C.rel_l2(sums['CPU'], whole_cpu):.3e}; against the CPU's: card on the card "
          f"{C.rel_l2(sums['own card'], sums['CPU']):.3e}, card on the CPU "
          f"{C.rel_l2(sums['ops CPU'], sums['CPU']):.3e}, card inputs "
          f"{C.rel_l2(sums['inputs card'], sums['CPU']):.3e}, card cotangents "
          f"{C.rel_l2(sums['cotangents card'], sums['CPU']):.3e}")
    print("done")


if __name__ == "__main__":
    main()
