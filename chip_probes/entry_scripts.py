"""Phase F of chip_smoke.py alone, after building the kernels: scripts/profile_step.py in its
default environment and under the BENCH_GRID_* f32 table, then scripts/quality_check.py
untrained and after QUALITY_STEPS steps. A failed check is printed and the probe goes on to
the next; it exits non-zero if any failed.

On a card, from the repository root:

    python3 chip_probes/entry_scripts.py
"""
import sys
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as C  # noqa: E402
from multimodalstudio_tpu_torch.device import set_reference_precision  # noqa: E402
from multimodalstudio_tpu_torch.ops.kernels import build  # noqa: E402

failed = []


def record(msg):
    print(f"entry_scripts: FAILED: {msg}")
    failed.append(msg)


C.fail = record
set_reference_precision()
card = C.card_line()
print(card)
print(f"torch {torch.__version__} cuda {torch.version.cuda}")
print(f"built kernels in {build.build_all():.1f} s")
dev = torch.device("cuda")
t0 = time.perf_counter()
_, profiles, errs = C.run_profiles(torch.Generator(device=dev).manual_seed(C.SEED), dev, card)
print("max_abs by wrapper: " + " ".join(f"{n}={e:.3e}" for n, e in errs.items()))
print(f"phase step profiles: {time.perf_counter() - t0:.1f} s")
t0 = time.perf_counter()
_, quality = C.run_quality(dev, card)
print(f"phase quality harness: {time.perf_counter() - t0:.1f} s")
for what, (busy_ms, top) in profiles.items():
    print(f"{what}: busy {busy_ms:.3f} ms over 3 steps ({card}); top ops:")
    for op in top:
        print(f"  {op['self_ms']:10.3f} ms {op['count']:6d}x {op['name'][:110]}")
print("done" if not failed else f"{len(failed)} checks failed")
sys.exit(1 if failed else 0)
