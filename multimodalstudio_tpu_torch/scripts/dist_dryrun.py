"""Data-parallel dry run (JAX reference: scripts/dist_dryrun.py): starts
two processes of dist_dryrun_worker.py through the process group's
environment (parallel/sharding.py; a free port of this host chosen at run
time), each training the narrow grid_raw_tpu through the port's Trainer
with n_devices = 2, and checks that both report the same loss and the same
parameters bit for bit, and that rank 0 alone wrote the run's checkpoint.
A process that fails ends the others.

    python -m multimodalstudio_tpu_torch.scripts.dist_dryrun --device cpu
    python -m multimodalstudio_tpu_torch.scripts.dist_dryrun --device cuda:0   # both ranks on one card
    python -m multimodalstudio_tpu_torch.scripts.dist_dryrun                   # rank r on card r

Exits 0 when the ranks agree.
"""

from __future__ import annotations

import argparse
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv_for_rank, world: int, timeout: float, env: Optional[Dict[str, str]] = None,
              cwd: Optional[str] = None) -> List[subprocess.CompletedProcess]:
    """Run `world` processes, rank r's command `argv_for_rank(r)`, in one
    group on a free local port (MMS_DIST_TIMEOUT bounds each collective);
    when one fails or `timeout` seconds pass, the others are killed.
    Returns each rank's CompletedProcess (stdout and stderr merged)."""
    port = free_port()
    procs, logs = [], []
    for rank in range(world):
        penv = dict(os.environ, **(env or {}), MMS_COORDINATOR=f"127.0.0.1:{port}",
                    MMS_NUM_PROCESSES=str(world), MMS_PROCESS_ID=str(rank))
        penv.setdefault("MMS_DIST_TIMEOUT", str(int(timeout)))
        logs.append(tempfile.TemporaryFile("w+"))  # a pipe left unread could stall a rank
        procs.append(subprocess.Popen(argv_for_rank(rank), env=penv, cwd=cwd, text=True,
                                      stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    out = []
    for p, log in zip(procs, logs):
        log.seek(0)
        out.append(subprocess.CompletedProcess(p.args, p.returncode, log.read(), None))
        log.close()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="two-process data-parallel dry run")
    parser.add_argument("--device", default="cuda", help="cuda (rank r on card r), cuda:N or cpu")
    parser.add_argument("--timeout", type=float, default=600.0)
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="mms_dist_dryrun_") as out_dir:
        cmd = [sys.executable, "-m", "multimodalstudio_tpu_torch.scripts.dist_dryrun_worker",
               "--device", args.device, "--out", out_dir]
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        results = run_ranks(lambda rank: cmd, 2, args.timeout, cwd=root)
    found, saved = {}, {}
    for rank, r in enumerate(results):
        if r.returncode != 0:
            print(f"--- rank {rank} failed (exit {r.returncode}):\n{r.stdout}")
            return 1
        loss = re.search(r"FINAL_LOSS (\S+)", r.stdout)
        digest = re.search(r"PARAMS_SHA256 (\S+)", r.stdout)
        saves = re.search(r"SAVES (\d+)", r.stdout)
        found[rank] = (loss and float(loss.group(1)), digest and digest.group(1))
        saved[rank] = saves and int(saves.group(1))
        print(f"rank {rank}: loss={found[rank][0]} params={found[rank][1]} saves={saved[rank]}")
    if None in found[0] or found[0] != found[1]:
        print(f"the ranks disagree: {found}")
        return 1
    if saved != {0: 1, 1: 0}:
        print(f"the checkpoints were not rank 0's alone: {saved}")
        return 1
    print("data-parallel dry run OK: both ranks hold the same loss and parameters, and rank 0 "
          "alone wrote the checkpoint")
    return 0


if __name__ == "__main__":
    sys.exit(main())
