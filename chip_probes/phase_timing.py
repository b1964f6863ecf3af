"""Where a reference label's render and training phases spend their seconds.

On a card, from the repository root; labels are chip_smoke.CONFIGS's:

    python3 chip_probes/phase_timing.py LABEL [LABEL ...]
"""
import sys
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as C  # noqa: E402
from multimodalstudio_tpu_torch.device import set_reference_precision  # noqa: E402

set_reference_precision()
card = C.card_line()
print(card, "threads", torch.get_num_threads())
dev = torch.device("cuda")
marks = []


def wrap(mod, name):
    orig = getattr(mod, name)

    def timed(*a, **k):
        t = time.perf_counter()
        out = orig(*a, **k)
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter() - t))
        return out
    setattr(mod, name, timed)


import multimodalstudio_tpu_torch.engine.train as T  # noqa: E402
import multimodalstudio_tpu_torch.models.model as M  # noqa: E402
wrap(C, "profile_device")
wrap(C, "time_hash_grids")
wrap(T, "batch_loss_and_grads")
orig_init = M.MMSModel.init


def init(self, gen):
    t = time.perf_counter()
    out = orig_init(self, gen)
    marks.append(("MMSModel.init", time.perf_counter() - t))
    return out


M.MMSModel.init = init
for label in sys.argv[1:]:
    for phase, fn in (("render", C.run_slice), ("training", C.run_training)):
        marks.clear()
        t0 = time.perf_counter()
        fn(dev, card, label)
        total = time.perf_counter() - t0
        print(f"TIMING {label} {phase}: {total:.1f} s; " + ", ".join(f"{n} {s:.1f}" for n, s in marks))
