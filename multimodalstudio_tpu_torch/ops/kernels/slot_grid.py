"""Slot-hash grid geometry (JAX reference: ops/pallas/slot_grid.py).

The table is [total_rows, 128] f32. In the cell layout one ENTRY holds the
8 corners of one grid cell at one level, F features each: feature f of
corner p sits at lane group * 8F + f * 8 + p of its physical row, and one
128-lane row packs P = 128 / (8F) entries. The entry of a cell is its dense
index when res^3 fits the level's entry budget, else the XOR hash of the
cell coordinate; physical row = level offset + (entry >> log2 P), group =
entry & (P - 1).

`slot_geometry` is the plain version of the geometry that the fused slot
kernels compute in-kernel (slot_fused.py). The lookup kernel K6
(slot_grid_lookup) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

LANE = 128
NSLOT = 8
FEAT = LANE // NSLOT  # 16 features per vertex
PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class SlotGridSpec:
    """Static geometry of a slot-hash grid (slot_grid.py:87-207)."""

    num_levels: int = 6
    min_res: int = 16
    max_res: int = 512
    rows_per_level: int = 2048  # ENTRY budget per level (power of two)
    hash_init_scale: float = 1e-4
    interpolation: str = "Smoothstep"  # Smoothstep | Linear
    layout: str = "vertex"  # vertex | cell
    feats: int = FEAT  # features per entry
    table_dtype: str = "f32"  # f32 | bf16
    gather: str = "auto"  # auto | copy | onehot

    def __post_init__(self):
        if self.rows_per_level & (self.rows_per_level - 1):
            raise ValueError("rows_per_level must be a power of two")
        if self.layout not in ("vertex", "cell"):
            raise ValueError(f"unknown slot-grid layout {self.layout!r}")
        if self.gather not in ("auto", "copy", "onehot"):
            raise ValueError(f"unknown slot-grid gather {self.gather!r}")
        if self.gather == "onehot" and self.layout != "cell":
            raise ValueError("gather='onehot' requires layout='cell'")
        if self.feats not in (2, 4, 8, 16):
            raise ValueError("feats must be one of 2, 4, 8, 16")
        if self.feats != FEAT and (self.layout != "cell" or self.resolved_gather != "onehot"):
            raise ValueError("packed entries (feats<16) need layout='cell' onehot")
        if self.table_dtype not in ("f32", "bf16"):
            raise ValueError(f"unknown table_dtype {self.table_dtype!r}")
        if self.table_dtype == "bf16" and self.resolved_gather != "onehot":
            raise ValueError("table_dtype='bf16' requires the onehot gather")
        if self.rows_per_level < self.entries_per_row:
            raise ValueError("rows_per_level must be >= entries per row")

    @property
    def resolved_gather(self) -> str:
        if self.gather == "auto":
            return "onehot" if self.layout == "cell" else "copy"
        return self.gather

    @property
    def entries_per_row(self) -> int:
        return LANE // (NSLOT * self.feats)

    @property
    def features_per_level(self) -> int:
        return self.feats

    @property
    def growth_factor(self) -> float:
        if self.num_levels == 1:
            return 1.0
        return float(
            np.exp((np.log(self.max_res) - np.log(self.min_res)) / (self.num_levels - 1))
        )

    @property
    def resolutions(self) -> np.ndarray:
        levels = np.arange(self.num_levels)
        return np.floor(self.min_res * self.growth_factor**levels).astype(np.int32)

    @property
    def level_entries(self) -> np.ndarray:
        if self.layout == "cell":
            dense = self.resolutions.astype(np.int64) ** 3
        else:
            dense = (self.resolutions // 2 + 1).astype(np.int64) ** 3
        return np.where(dense <= self.rows_per_level, dense, self.rows_per_level).astype(np.int64)

    @property
    def level_rows(self) -> np.ndarray:
        p = self.entries_per_row
        return (self.level_entries + p - 1) // p

    @property
    def level_offsets(self) -> np.ndarray:
        # every level starts on an 8-row boundary
        aligned = ((self.level_rows + 7) // 8) * 8
        return np.concatenate([[0], np.cumsum(aligned)[:-1]]).astype(np.int64)

    @property
    def total_rows(self) -> int:
        return int((((self.level_rows + 7) // 8) * 8).sum())

    @property
    def out_dim(self) -> int:
        return self.num_levels * self.feats


def make_table_init(spec: SlotGridSpec):
    """Uniform(-1, 1) * hash_init_scale over [total_rows, 128]
    (slot_grid.py:952-959)."""

    def init(gen: torch.Generator) -> torch.Tensor:
        u = torch.rand((spec.total_rows, LANE), generator=gen, device=gen.device)
        return (u * 2.0 - 1.0) * spec.hash_init_scale

    return init


def slot_geometry(x: torch.Tensor, spec: SlotGridSpec, num_levels: Optional[int] = None):
    """Cell-layout entry indices and trilerp weights (slot_grid.py:212-319).

    x [N, 3] in [0, 1]. Returns idx [N, K] int64 ABSOLUTE entry indices
    (level row offset * P + entry), w [N, K*8] f32 (column l*8 + p, corner
    offset bits p = dx + 2 dy + 4 dz) and dw [N, 3*K*8] f32 with column
    t*K*8 + c = d w[:, c] / d x[:, t]. The hash runs in int64 masked to 32
    bits, the uint32 arithmetic of the reference."""
    if spec.layout != "cell":
        raise NotImplementedError("only the cell layout is ported")
    k = spec.num_levels if num_levels is None else min(num_levels, spec.num_levels)
    n = x.shape[0]
    dev = x.device
    res = spec.resolutions[:k]
    resf = torch.as_tensor(res.astype(np.float32), device=dev)
    scaled = x[:, None, :] * resf[None, :, None]  # [N, K, 3]
    base = torch.floor(scaled)
    t = scaled - base
    if spec.interpolation == "Smoothstep":
        s = t * t * (3.0 - 2.0 * t)
        ds = 6.0 * t * (1.0 - t) * resf[None, :, None]
    elif spec.interpolation == "Linear":
        s = t
        ds = resf[None, :, None].expand_as(t)
    else:
        raise ValueError(f"unknown interpolation {spec.interpolation}")
    resi = torch.as_tensor(res.astype(np.int64), device=dev)
    b = torch.minimum(base.long().clamp_min(0), (resi - 1)[None, :, None])  # [N, K, 3]
    h = b[..., 0] * PRIMES[0]
    h = torch.bitwise_xor(h, (b[..., 1] * PRIMES[1]) & 0xFFFFFFFF)
    h = torch.bitwise_xor(h, (b[..., 2] * PRIMES[2]) & 0xFFFFFFFF)
    ents = torch.as_tensor(spec.level_entries[:k], device=dev)
    row_hash = h & (ents - 1)[None, :]
    row_dense = b[..., 0] + (b[..., 1] + b[..., 2] * resi[None, :]) * resi[None, :]
    dense = torch.as_tensor(res.astype(np.int64) ** 3 <= spec.rows_per_level, device=dev)
    row = torch.where(dense[None, :], row_dense, row_hash)
    offs = torch.as_tensor(spec.level_offsets[:k] * spec.entries_per_row, device=dev)
    idx = row + offs[None, :]

    bits = torch.tensor([[p & 1, (p >> 1) & 1, (p >> 2) & 1] for p in range(NSLOT)],
                        dtype=x.dtype, device=dev)  # [8, 3]
    s4 = s[:, :, None, :]
    wa = bits * s4 + (1.0 - bits) * (1.0 - s4)  # [N, K, 8, 3]
    dwa = (2.0 * bits - 1.0) * ds[:, :, None, :]
    w = (wa[..., 0] * wa[..., 1] * wa[..., 2]).reshape(n, k * NSLOT)
    dw = torch.cat(
        [
            (dwa[..., 0] * wa[..., 1] * wa[..., 2]).reshape(n, k * NSLOT),
            (wa[..., 0] * dwa[..., 1] * wa[..., 2]).reshape(n, k * NSLOT),
            (wa[..., 0] * wa[..., 1] * dwa[..., 2]).reshape(n, k * NSLOT),
        ],
        dim=-1,
    )
    return idx, w, dw
