"""Phase D of chip_smoke.py (a scene from disk) and its late labels, beside grid_raw_tpu's
training on the synthetic scene in the same process, after building the kernels.

On a card, from the repository root; labels are chip_smoke.CONFIGS's:

    python3 chip_probes/disk_and_late_labels.py [LABEL ...]  (chip_smoke.VOLSDF_LABEL by default)
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
with C.config_env("grid_raw_tpu"):
    _, ref = C.timed_training(dev, card, "grid_raw_tpu")
print(f"phase grid_raw_tpu training on the synthetic scene: {time.perf_counter() - t0:.1f} s")
t0 = time.perf_counter()
with tempfile.TemporaryDirectory() as root:
    launches, disk = C.run_disk_scene(dev, card, root)
print(f"phase scene from disk: {time.perf_counter() - t0:.1f} s")
for label in sys.argv[1:] or (C.VOLSDF_LABEL,):
    t0 = time.perf_counter()
    with C.config_env(label):
        print(f"render ({label}):")
        _, rays = C.run_slice(dev, card, label)
        t1 = time.perf_counter()
        print(f"phase render {label}: {t1 - t0:.1f} s")
        print(f"training ({label}):")
        t = C.run_training(dev, card, label)
    print(f"phase training {label}: {time.perf_counter() - t1:.1f} s")
    print(f"{label}: eval rays/s {rays:.1f}, train rays/s {t['rays_per_s']:.1f}, step "
          f"{t['step_ms']:.2f} ms, busy {t['busy_ms']:.2f} ms ({100 * t['busy']:.1f}%), peak "
          f"{t['peak_gib']:.2f} GiB ({card})")
for name, r in (("grid_raw_tpu, synthetic", ref), ("grid_raw_tpu, disk", disk)):
    print(f"{name}: train rays/s {r['rays_per_s']:.1f}, step {r['step_ms']:.2f} ms, busy "
          f"{r['busy_ms']:.2f} ms ({100 * r['busy']:.1f}%), {r['ops']} device ops ({card})")
print("done")
