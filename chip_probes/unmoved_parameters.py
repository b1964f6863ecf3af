"""Which parameter of a reference label ends chip_smoke's training phase where it started
(no net change after the warm-up and timed steps), and why: its shape and magnitude, a
512-ray-per-modality batch's gradient of it, and its Adam moments.

On a card, from the repository root; labels are chip_smoke.CONFIGS's:

    python3 chip_probes/unmoved_parameters.py LABEL [LABEL ...]
"""
import dataclasses
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as C  # noqa: E402
import multimodalstudio_tpu_torch.models.model as M  # noqa: E402
from multimodalstudio_tpu_torch.configs.methods import FIVE_MODALITIES  # noqa: E402
from multimodalstudio_tpu_torch.data.device_cache import sample_pixel_batch  # noqa: E402
from multimodalstudio_tpu_torch.device import set_reference_precision  # noqa: E402
from multimodalstudio_tpu_torch.engine import train as T  # noqa: E402

set_reference_precision()
card = C.card_line()
dev = torch.device("cuda")
initial = {}
init = M.MMSModel.init


def init_and_keep(self, gen):
    """The model's init, keeping a copy of the drawn parameters."""
    out = init(self, gen)
    initial.update({k: p.detach().clone() for k, p in self.named_parameters()})
    return out


M.MMSModel.init = init_and_keep
for label in sys.argv[1:]:
    (cfg, model, cams, state, cache, gen, stepped), stats = C.timed_training(dev, card, label, 5)
    params = dict(model.named_parameters())
    still = [k for k, p in params.items() if torch.equal(p, initial[k])]
    print(label, "unmoved:", still, "changed in no checked step:", sorted(set(params) - stepped))
    small = dataclasses.replace(cfg, datamanager=dataclasses.replace(
        cfg.datamanager, num_rays_per_modality=512, microbatch_rays=0))
    batch = sample_pixel_batch(cache, gen, 512, FIVE_MODALITIES)
    out = T.batch_loss_and_grads(small, model, cams, state.camera_poses, batch, state.step,
                                 T.make_schedules(small, state.step))
    for k in still:
        p, g = params[k].detach(), out[3]["fields"][k]
        mu, nu = state.opt_state.mu["fields"][k], state.opt_state.nu["fields"][k]
        print(f"  {k}: shape {tuple(p.shape)} |p| {float(p.abs().min()):.3e}.."
              f"{float(p.abs().max()):.3e} grad norm {float(g.norm()):.3e} nonzero "
              f"{int((g != 0).sum())}, mu {float(mu.abs().max()):.3e} nu {float(nu.abs().max()):.3e}")
