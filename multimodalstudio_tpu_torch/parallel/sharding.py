"""Data-parallel training over processes (JAX reference: parallel/sharding.py).

JAX drives every device from one controller: a 1-D `data` mesh, batches
sharded along their ray axis, parameters replicated, and XLA's gradient
all-reduce. Here each process drives one device and holds a whole replica
of the parameters (broadcast from rank 0 at set-up). Every process draws
the same global pixel batch, takes its own contiguous rows of each ray
microbatch, and the summed gradients are averaged over the processes with
one all-reduce a step, so every rank takes the same update: the step is
the one-process step on the same global batch, up to the order of the sums.

The process group comes from JAX's environment contract:

    MMS_COORDINATOR    host:port of rank 0's store (required to enable)
    MMS_NUM_PROCESSES  the number of processes (the world size)
    MMS_PROCESS_ID     this process's rank

Host work that ends in files (checkpoints, config.yaml, the writer,
evaluations, exports) is rank 0's (`is_main_process`). JAX's `to_host`,
which pulls the replicated global arrays to one process's host so that
rank-0-only work issues no collective, has no counterpart: each process's
replica is whole on its own device.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 1800.0  # a collective's limit; MMS_DIST_TIMEOUT overrides it


def timeout_seconds() -> float:
    return float(os.environ.get("MMS_DIST_TIMEOUT", DEFAULT_TIMEOUT_S))


def default_backend(device) -> str:
    """nccl for a CUDA device, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(backend: Optional[str] = None, device="cuda") -> bool:
    """Join the process group named by the MMS_* environment (module
    docstring); True when the world has more than one process. Without
    MMS_COORDINATOR, or when the group exists already, nothing is started.
    `backend` defaults to `default_backend(device)`; every collective of
    the group raises after `timeout_seconds()` rather than wait on a rank
    that is gone."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coord = os.environ.get("MMS_COORDINATOR")
    if not coord:
        return False
    world = int(os.environ["MMS_NUM_PROCESSES"])
    rank = int(os.environ["MMS_PROCESS_ID"])
    dist.init_process_group(
        backend=backend or default_backend(device), init_method=f"tcp://{coord}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_seconds()))
    return world > 1


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def broadcast_object(obj, src: int = 0):
    """Rank `src`'s picklable `obj` on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def rank_device(device="cuda") -> torch.device:
    """This rank's device: a bare "cuda" is card `rank` of this host (it
    raises where the host has fewer cards than ranks); an indexed card or
    the CPU is taken as given, so two ranks share a card only when the
    caller names that card for both."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None or world_size() == 1:
        return dev
    rank, n = process_index(), torch.cuda.device_count()
    if rank >= n:
        raise RuntimeError(f"rank {rank} has no card of its own ({n} on this host): name the "
                           "card each rank runs on, e.g. device='cuda:0'")
    return torch.device("cuda", rank)


def bind_device(device="cuda") -> torch.device:
    """`rank_device(device)`, made the current CUDA device where it is a card
    (NCCL's barrier and communicators use the current device)."""
    dev = rank_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return dev


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """The ranks a step is split over: rank `rank` of `world` takes the
    rows [rank * n / world, (rank + 1) * n / world) of each ray microbatch
    of n rays per modality."""

    rank: int
    world: int

    @staticmethod
    def current() -> Optional["DataParallel"]:
        """The process group's ranks, or None with one process."""
        return DataParallel(process_index(), world_size()) if world_size() > 1 else None

    def rows(self, n: int) -> slice:
        if n % self.world:
            raise ValueError(f"{n} rays do not split over {self.world} processes")
        size = n // self.world
        return slice(self.rank * size, (self.rank + 1) * size)

    def all_reduce_mean(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over ranks of each tensor, in one all-reduce of their
        flattened concatenation (float32)."""
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat = flat / self.world
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
            i += t.numel()
        return out

    def all_reduce_min(self, tensor: torch.Tensor) -> torch.Tensor:
        out = tensor.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MIN)
        return out


def shard_batch(batch: Dict, dp: Optional[DataParallel]) -> Dict:
    """This rank's contiguous rows of every leaf of a {modality: PixelBatch}
    batch (sharding.py::shard_batch); the batch itself with one process."""
    if dp is None:
        return batch
    out = {}
    for mod, b in batch.items():
        fields = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
        rows = dp.rows(next(iter(fields.values())).shape[0])
        out[mod] = type(b)(**{k: v[rows] for k, v in fields.items()})
    return out


def replicate(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Broadcast every tensor from rank `src` in place (at set-up, so that
    every replica starts from rank 0's parameters)."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t, src=src)

