"""The reference labels of chip_smoke.py alone (no kernel build: they launch none).

On a card, from the repository root; labels are chip_smoke.CONFIGS's:

    python3 chip_probes/reference_labels.py [LABEL ...]  (chip_smoke.REFERENCE_LABELS by default)
"""
import sys
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as C  # noqa: E402
from multimodalstudio_tpu_torch.device import set_reference_precision  # noqa: E402

set_reference_precision()
card = C.card_line()
print(card)
print(f"torch {torch.__version__} cuda {torch.version.cuda} tf32 "
      f"{torch.backends.cuda.matmul.allow_tf32} {torch.get_float32_matmul_precision()}")
dev = torch.device("cuda")
labels = sys.argv[1:] or C.REFERENCE_LABELS
for label in labels:
    t0 = time.perf_counter()
    print(f"render ({label}):")
    _, rays = C.run_slice(dev, card, label)
    t1 = time.perf_counter()
    print(f"phase render {label}: {t1 - t0:.1f} s")
    print(f"training ({label}):")
    t = C.run_training(dev, card, label)
    print(f"phase training {label}: {time.perf_counter() - t1:.1f} s")
    print(f"{label}: eval rays/s {rays:.1f}, train rays/s {t['rays_per_s']:.1f}, step "
          f"{t['step_ms']:.2f} ms, busy {100 * t['busy']:.1f}%, peak {t['peak_gib']:.2f} GiB, "
          f"index {t.get('index_ms', 0):.2f} of {t['busy_ms']:.2f} ms, hash {t.get('hash_grid')} "
          f"({card})")
print("done")
