"""Why a label's slot-table gradient follows the last bit of its sample positions, on the
CPU (no card): the label (a chip_smoke.CONFIGS label, VOLSDF_LABEL by default) trains 7
steps on a small synthetic scene at 128 rays a modality, then one 64-ray microbatch records
the slot SDF chain's call (chip_probes/volsdf_table_replay.py). Counts the samples that sit
exactly on a cell plane of the grid's first level, and recomputes the table gradient with the
positions moved by one float32 ulp (each way): of every sample, of the samples on a cell
plane only, and of the others only. Prints rel-L2 of each against the unmoved gradient.

From the repository root (about a minute on one core):

    python3 chip_probes/box_cell_planes.py [LABEL]
"""
import dataclasses
import sys

import torch

sys.path.insert(0, ".")
sys.path.insert(0, "chip_probes")
import chip_smoke as C  # noqa: E402
from volsdf_table_replay import recording_plain, table_grad  # noqa: E402
from multimodalstudio_tpu_torch.cameras.camera_optimizer import init_camera_poses  # noqa: E402
from multimodalstudio_tpu_torch.configs.methods import FIVE_MODALITIES  # noqa: E402
from multimodalstudio_tpu_torch.data.device_cache import build_device_cache  # noqa: E402
from multimodalstudio_tpu_torch.data.device_cache import sample_pixel_batch  # noqa: E402
from multimodalstudio_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from multimodalstudio_tpu_torch.engine import train as T  # noqa: E402
from multimodalstudio_tpu_torch.models.model import MMSModel  # noqa: E402

torch.set_num_threads(4)
label = sys.argv[1] if len(sys.argv) > 1 else C.VOLSDF_LABEL
cfg = C.load(label)
cfg = dataclasses.replace(cfg, datamanager=dataclasses.replace(
    cfg.datamanager, num_rays_per_modality=128, microbatch_rays=0))
data = make_synthetic_dataset(FIVE_MODALITIES, num_views=4, height=64, width=64,
                              raw=cfg.datamanager.raw, device="cpu")
gen = torch.Generator().manual_seed(C.SEED)
model = MMSModel(cfg.model, device="cpu").init(gen)
cams = {m: data.data[m].cameras for m in FIVE_MODALITIES}
poses = init_camera_poses(cfg.datamanager.camera_optimizer, FIVE_MODALITIES,
                          {m: c.camera_to_worlds.shape[0] for m, c in cams.items()}, device="cpu")
state = T.init_train_state(cfg, model, poses)
cache = build_device_cache(data, device="cpu")
steps = T.make_train_steps(cfg, model, cams)
for _ in range(7):
    state, _ = steps(state, cache, gen, 1)
small = dataclasses.replace(cfg, datamanager=dataclasses.replace(
    cfg.datamanager, num_rays_per_modality=64, microbatch_rays=0))
batch = sample_pixel_batch(cache, gen, 64, FIVE_MODALITIES)
if cfg.model.background_color == "random":
    C.fixed_background_colours(model)
calls = []
with recording_plain(calls):
    T.batch_loss_and_grads(small, model, cams, state.camera_poses, batch, state.step,
                           T.make_schedules(small, state.step))
name, args, kw, cots = next(c for c in calls if c[0] == "fused_slot_sdf_chain")
pos, gspec, radius = args[0].detach(), args[4], kw["radius"]
cells = (pos + radius) / (2 * radius) * float(gspec.resolutions[0])
plane = ((cells == torch.round(cells)) & (cells > 0) & (cells < gspec.resolutions[0])).any(-1)
base = table_grad(name, args, kw, cots, "cpu")
print(f"{label} at step {state.step}, collider {cfg.model.collider_type}: {int(plane.sum())} of "
      f"{pos.shape[0]} samples on a cell plane of level 0 (resolution {gspec.resolutions[0]}); "
      f"table gradient norm {float(base.norm()):.3e}")
for what, sel in (("every sample", torch.ones_like(plane)), ("the samples on a cell plane", plane),
                  ("the others", ~plane)):
    moves = []
    for end in (float("inf"), -float("inf")):
        moved = torch.where(sel[:, None], torch.nextafter(pos, torch.full_like(pos, end)), pos)
        got = table_grad(name, [moved, *args[1:]], kw, cots, "cpu")
        moves.append(f"{C.rel_l2(got, base):.3e}")
    print(f"  one ulp up / down on {what}: the table gradient moves {' / '.join(moves)}")
