"""The grid_raw_tpu slice of tests/test_torch_train.py on the native host
sampler's draws (UniformPixelSampler as it runs) in place of its plain
version's numpy draws, which the test's fixed 3e-2 limits were written on:
each gradient group's rel-L2 between the port and JAX, beside the port's
distance to itself over three runs with every parameter moved by a
relative 1e-6 (tests/test_torch_mlp_raw.py::moved_runs), and each loss's
relative distance. On the CPU, from the repository root:

    JAX_PLATFORMS=cpu python cpu_probes/native_draw_noise.py [seed ...]   # default 5 6
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, ROOT)
import conftest  # noqa: E402,F401  (JAX on the CPU)
import test_torch_train as T  # noqa: E402
from test_torch_mlp_raw import moved_runs  # noqa: E402

from multimodalstudio_tpu_torch.data.sampler import UniformPixelSampler  # noqa: E402


def native(dataset, rays, seed):
    return UniformPixelSampler(dataset, rays, seed=seed).sample()


def main(seeds):
    for seed in seeds:
        r = T.run_slice(native, seed)
        (jtotal, jlo, _, jgrads), (ttotal, tlo, _, tgrads) = r["j"], r["t"]
        cfg, model, state = T.TCFG, r["model"], r["state"]

        def port():
            return T.ttrain.batch_loss_and_grads(cfg, model, r["tcams"], state.camera_poses,
                                                 r["tbatch"], T.STEP,
                                                 T.ttrain.make_schedules(cfg, T.STEP))

        moved = moved_runs(model, port)
        print(f"seed {seed}: losses, relative to JAX's:")
        for k in sorted(jlo):
            ref = float(jlo[k])
            print(f"  {k:20s} {abs(float(tlo[k]) - ref) / max(abs(ref), 1e-30):.3e}")
        print(f"seed {seed}: gradient groups, rel-L2 to JAX's (limit 3e-2), and the port's "
              "to itself over three 1e-6 moves:")
        jflat = T._flatten(jgrads["model"])
        groups = {name: (np.concatenate([jflat[k].ravel() for k in keys]),
                         lambda g, keys=keys: np.concatenate(
                             [g["fields"][k].numpy().ravel() for k in keys]))
                  for name, keys in T._groups(jflat).items()}
        groups.update({f"camera poses {m}": (np.asarray(jgrads["camera_poses"][m]),
                                             lambda g, m=m: g["camera_poses"][m].numpy())
                       for m in T.MODS})
        for name, (ref, of) in sorted(groups.items()):
            got = of(tgrads)
            self_ = [T.rel_l2(of(m), got) for m in moved]
            print(f"  {name:40s} {T.rel_l2(got, ref):.3e}   moved {min(self_):.3e}-{max(self_):.3e}")


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [5, 6])
