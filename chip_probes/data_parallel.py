"""Phases D and E of chip_smoke.py alone, after building the kernels: the scene from disk
with its paper metrics (the port's evaluate_average_metrics, LPIPS on the card against the
CPU) and the native host sampler against numpy, then data parallel over two processes on
one card (gloo), the Trainer at n_devices = 2 and a world-1 NCCL group.

On a card, from the repository root:

    python3 chip_probes/data_parallel.py
"""
import sys
import tempfile
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as C  # noqa: E402
from multimodalstudio_tpu_torch.device import set_reference_precision  # noqa: E402
from multimodalstudio_tpu_torch.ops.kernels import build  # noqa: E402

set_reference_precision()
card = C.card_line()
print(card)
print(f"torch {torch.__version__} cuda {torch.version.cuda}")
print(f"built kernels in {build.build_all():.1f} s")
dev = torch.device("cuda")
t0 = time.perf_counter()
with tempfile.TemporaryDirectory() as root:
    _, disk = C.run_disk_scene(dev, card, root)
print(f"phase scene from disk: {time.perf_counter() - t0:.1f} s")
t0 = time.perf_counter()
with tempfile.TemporaryDirectory() as root:
    launches, dp = C.run_data_parallel(dev, card, root)
print(f"phase data parallel: {time.perf_counter() - t0:.1f} s")
print(f"grid_raw_tpu on disk: train rays/s {disk['rays_per_s']:.1f}, step {disk['step_ms']:.2f} ms; "
      f"data parallel: global rays/s {dp['rays_per_s']:.1f}, step {dp['step_ms']:.2f} ms; "
      f"launches {dict((k, launches.get(k, 0)) for k in C.K123)} ({card})")
print("done")
