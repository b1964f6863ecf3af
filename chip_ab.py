"""Run chip_smoke.py's kernel checks for one or more checkouts of the port on
one card, each checkout in a process of its own, in the order given.

    python3 chip_ab.py TREE [TREE ...] [--checks NAME[,NAME...]] [--train LABEL[;LABEL...]]

TREE is a directory that holds a checkout (the repository root is "."). For
a paired comparison of two commits unpack the other one into a directory
that .gitignore lists (git archive) and give parent, change, change,
parent. Each tree builds its own kernels, seeds a CUDA generator with 0 and
calls the named check functions of its own chip_smoke.py in turn (default:
the six grid_raw_tpu kernel checks), which print their agreement with the
plain versions; then one line `AB <tree> {"<check>": ms, ...}` with each
check's kernel time (CUDA events, median of 15; a check that returns a
forward and a backward gives "<check>[0]" and "<check>[1]"; a check named
"<check>:<arg>=<EXPR>" is called with EXPR, evaluated in chip_smoke's
namespace, as the keyword argument <arg>, e.g.
check_chain_adjoint_bwd:dims=VERTEX_DIMS or check_slot_value:gspec=f32_spec()
for the f32 table's K2f; beside it
"<check> kernel" for its kernels alone, without the wrapper, "<check>
standalone" for K1's backward packing its own images, and "<check> library"
for the library call and "<check> ops" for the device ops of one wrapper
call, where the check measures them). --train times chip_smoke's
timed_training for each label of its CONFIGS (2 warm-up steps, 5 timed, one
profiled) and records "train <label> step_ms", "busy_ms", "ops" (the device
ops of the profiled step) and "rays_per_s"; --checks "" runs no check.
Giving one tree several
times repeats its checks in processes of their own: readings of one call to
set a difference against. Needs one card.
"""

import argparse
import subprocess
import sys

DEFAULT_CHECKS = ("check_fused_chain,check_slot_value,check_slot_chain,check_fused_chain_bwd,"
                  "check_slot_value_bwd,check_slot_chain_bwd")

CODE = r'''
import inspect, json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as c
from multimodalstudio_tpu_torch.device import set_reference_precision
from multimodalstudio_tpu_torch.ops.kernels import build
from multimodalstudio_tpu_torch.ops.kernels.slot_grid import SlotGridSpec
set_reference_precision()
print(f"built kernels in {build.build_all():.1f} s", flush=True)
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
gspec = SlotGridSpec(num_levels=6, min_res=16, max_res=512, rows_per_level=4096, layout="cell",
                     feats=2, table_dtype="bf16")
out = {}
for name in filter(None, sys.argv[2].split(",")):
    fname, _, arg = name.partition(":")
    fn = getattr(c, fname)
    kw = {"gspec": gspec} if "gspec" in inspect.signature(fn).parameters else {}
    if arg:
        key, value = arg.split("=")
        kw[key] = eval(value, vars(c))
    r = fn(gen, dev, **kw)
    for i, part in enumerate(r if isinstance(r, tuple) else (r,)):
        if isinstance(part, dict):
            key = name if not isinstance(r, tuple) else f"{name}[{i}]"
            out[key] = round(part["ms"], 4)
            for what in ("kernel", "standalone", "library"):
                if part.get(what + "_ms") is not None:
                    out[f"{key} {what}"] = round(part[what + "_ms"], 4)
            if part.get("ops") is not None:
                out[f"{key} ops"] = part["ops"]
card = c.card_line()
for label in filter(None, sys.argv[3].split(";")):
    with c.config_env(label):
        t = c.timed_training(dev, card, label)[1]
    for what in ("step_ms", "busy_ms", "ops", "rays_per_s"):
        out[f"train {label} {what}"] = round(t[what], 2)
print("AB", sys.argv[1], json.dumps(out), flush=True)
'''


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--checks", default=DEFAULT_CHECKS)
    ap.add_argument("--train", default="")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    for tree in args.trees:
        r = subprocess.run([sys.executable, "-c", CODE, tree, args.checks, args.train], cwd=tree)
        if r.returncode:
            sys.exit(r.returncode)


if __name__ == "__main__":
    main()
