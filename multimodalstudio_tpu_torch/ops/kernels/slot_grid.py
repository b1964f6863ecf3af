"""Slot-hash grid geometry (JAX reference: ops/pallas/slot_grid.py).

The table is [total_rows, 128] f32. In the cell layout one ENTRY holds the
8 corners of one grid cell at one level, F features each: feature f of
corner p sits at lane group * 8F + f * 8 + p of its physical row, and one
128-lane row packs P = 128 / (8F) entries. The entry of a cell is its dense
index when res^3 fits the level's entry budget, else the XOR hash of the
cell coordinate; physical row = level offset + (entry >> log2 P), group =
entry & (P - 1).

In the vertex layout (exact C0) one row holds ONE grid vertex's features
at one level, and the 8 corners of a cell read 8 rows: vertices are
grouped 2 x 2 x 2, the group of vertex g being g >> 1 per axis, and the
8 vertices of a group share a row, vertex parity p (bits g & 1) owning
lanes f * 8 + p. A cell's 8 corners have 8 distinct parities, so corner
slot p of a sample is the corner whose parity is p; its row is the
group's dense index when (res // 2 + 1)^3 fits the budget, else the XOR
hash of the group coordinate. F = 16 and an f32 table only.

`slot_geometry` is the plain version of the geometry that the fused slot
kernels compute in-kernel (slot_fused.py) in the cell layout, and the
vertex layout's; it is plain tensor code, so autograd carries position
gradients (second order included) through its trilerp weights w and their
derivatives dw.

`slot_grid_lookup` is kernel K6: from (table, idx, w[, dw]) it gathers each
sample's entry per level and returns the encoding enc [N, K*F] (and its
spatial tangents, lane-folded [N, 3*K*F] inside the op). On the card it is
the CUDA kernel pair of csrc/slot_grid.cu, replacing the Pallas TPU
kernels multimodalstudio_tpu/ops/pallas/slot_grid.py::_fwd_kernel (:415)
and _bwd_kernel (:536), reached through slot_grid_lookup (:890) and
_lookup_fn's custom VJP (:768-884). The TPU gathers rows by one-hot
matrix products and keeps the gathered rows `comp` [N, K*128] f32 as the
backward's residual; the card gathers the sample's 8F values directly, in
the forward and again in the backward, and keeps no residual. The
backward returns d_table (a scatter-add by f32 vector reductions, whose
order changes from run to run), d_w [N, K*8] and d_dw [N, 3*K*8].

Cast points of the bf16-table mode (_fwd_kernel :509-523, _bwd_kernel
:578-629): enc = sum_p bf16(bf16(T) * bf16(w_p)) and tenc_t the same with
bf16(dw_t), the 8-corner sum in f32; backward gt = bf16(genc), gtk =
bf16(gtenc_t); d_w[p] = sum_f bf16(bf16(T) * gt), d_dw the same with gtk;
u = gt * bf16(w) + sum_t gtk * bf16(dw_t) in f32, rounded to bf16 before
the f32 scatter-sum into d_table. Only the sample's own entry (its 8F
lanes) receives anything. The f32 table runs the same arithmetic without
the roundings (the TPU's hi/lo split reaches f32 to about 2^-16).

K6v is the vertex layout's lookup, a kernel pair of its own in
csrc/slot_grid.cu replacing the vertex branches of the same two Pallas
kernels (_fwd_kernel :487-507, _bwd_kernel :645-662): T[n, l, f, p] =
table[idx[n, l*8 + p], f*8 + p], the parity-p lanes of corner p's row,
then enc and tenc by the cell formula in exact f32 (the TPU's copy gather
and its float32 dots); the backward adds u[n, l, f, p] into those lanes
of d_table. The plain versions gather by flat element index (row * 128 +
lane), never whole rows.

Bound on an H100: per (sample, level) the forward reads 8 + 24 f32
weights, an index and 8F table values (L2-resident: 1.5 MB at the
flagship size) and writes 4F floats; about 8F multiply-adds per output:
the bytes bound it. The backward adds F + 3F cotangents and writes 32 f32
weight cotangents; it needs the index and weights only where the
cotangents are not all zero. K6's forward runs a thread per (sample,
level) in memory order, so that every operand is read and written in
contiguous runs; its backward gives a lane group of 2F lanes (16 bytes of
the entry each) a run of up to 32 consecutive samples at one level: the
group reads its entry only when it moves, skips a level (and a sample)
whose cotangents are all zero and adds a kept entry's table cotangent by
one vector reduction a lane when the entry moves. K6v's corner spans all
16 sectors of its 512-byte row, so what bounds it is the L2 sectors of the
distinct rows a sample reads (3.4 of 8 on average at uniform positions),
the device bytes of idx, w, dw and the outputs, the instructions a warp
spends a sample, and in the backward the atomics on the dense coarse
level. Its kernels give a warp a run of up to 32 consecutive samples at
one level, staged in shared memory: each distinct row of the slots that
moved is read once, 32 lanes x 16 bytes, and a slot whose row did not
move (along a ray a corner keeps its parity) keeps its values; the
backward skips samples whose cotangents are all zero (the masked levels)
and sums a kept row's table cotangent in registers, adding it by vector
reductions when the row moves.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from multimodalstudio_tpu_torch.ops.kernels import build

LANE = 128
NSLOT = 8
FEAT = LANE // NSLOT  # 16 features per vertex
PRIMES = (1, 2654435761, 805459861)
CLIP_HI = float(np.float32(1.0 - 1e-6))  # grid coordinates are clamped to [0, CLIP_HI]

KERNEL = build.register(
    "slot_grid_lookup",
    source="multimodalstudio_tpu_torch/csrc/slot_grid.cu",
    replaces="multimodalstudio_tpu/ops/pallas/slot_grid.py:415",
)
BWD_KERNEL = build.register(
    "slot_grid_lookup_bwd",
    source="multimodalstudio_tpu_torch/csrc/slot_grid.cu",
    replaces="multimodalstudio_tpu/ops/pallas/slot_grid.py:536",
)
VERTEX_KERNEL = build.register(
    "slot_grid_lookup_vertex",
    source="multimodalstudio_tpu_torch/csrc/slot_grid.cu",
    replaces="multimodalstudio_tpu/ops/pallas/slot_grid.py:415",
)
VERTEX_BWD_KERNEL = build.register(
    "slot_grid_lookup_vertex_bwd",
    source="multimodalstudio_tpu_torch/csrc/slot_grid.cu",
    replaces="multimodalstudio_tpu/ops/pallas/slot_grid.py:536",
)


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


def _grid_coords(x: torch.Tensor, spec: SlotGridSpec, k: int):
    """Per level of the first k: the smoothstep (or linear) factor s of the
    in-cell offset and its first and second derivatives in x (the
    resolution chain rule included), each [N, k, 3], and the clamped cell
    coordinate b [N, k, 3] int64."""
    dev = x.device
    res = spec.resolutions[:k]
    resf = torch.as_tensor(res.astype(np.float32), device=dev)
    scaled = x[:, None, :] * resf[None, :, None]  # [N, K, 3]
    base = torch.floor(scaled)
    t = scaled - base
    if spec.interpolation == "Smoothstep":
        s = t * t * (3.0 - 2.0 * t)
        ds = 6.0 * t * (1.0 - t) * resf[None, :, None]
        dds = (6.0 - 12.0 * t) * resf[None, :, None] * resf[None, :, None]
    elif spec.interpolation == "Linear":
        s = t
        ds = resf[None, :, None].expand_as(t)
        dds = torch.zeros_like(t)
    else:
        raise ValueError(f"unknown interpolation {spec.interpolation}")
    resi = torch.as_tensor(res.astype(np.int64), device=dev)
    b = torch.minimum(base.long().clamp_min(0), (resi - 1)[None, :, None])  # [N, K, 3]
    return s, ds, dds, b


def _hash(c: torch.Tensor) -> torch.Tensor:
    """XOR hash of integer coordinates c [..., 3] in uint32 arithmetic
    (int64 masked to 32 bits)."""
    h = c[..., 0] * PRIMES[0]
    h = torch.bitwise_xor(h, (c[..., 1] * PRIMES[1]) & 0xFFFFFFFF)
    return torch.bitwise_xor(h, (c[..., 2] * PRIMES[2]) & 0xFFFFFFFF)


def _corner_bits(dev) -> torch.Tensor:
    """Offset bits [8, 3] of corner p = dx + 2 dy + 4 dz."""
    return torch.tensor([[p & 1, (p >> 1) & 1, (p >> 2) & 1] for p in range(NSLOT)],
                        dtype=torch.int64, device=dev)


def _axis_factors(d8: torch.Tensor, s, ds, dds, dtype):
    """Per-axis trilerp factors of the corners with offset bits d8 [.., 8,
    3] and their first and second derivatives, each [N, K, 8, 3]."""
    df = d8.to(dtype)
    s4 = s[:, :, None, :]
    wa = df * s4 + (1.0 - df) * (1.0 - s4)
    sgn = 2.0 * df - 1.0
    return wa, sgn * ds[:, :, None, :], sgn * dds[:, :, None, :]


def cell_factors(x: torch.Tensor, spec: SlotGridSpec, num_levels: Optional[int] = None):
    """Cell-layout entry indices and per-axis trilerp factors.

    x [N, 3] in [0, 1]. Returns idx [N, K] int64 ABSOLUTE entry indices
    (level row offset * P + entry) and wa, dwa, ddwa [N, K, 8, 3]: for
    corner p (offset bits p = dx + 2 dy + 4 dz) and axis t, the factor
    (bit ? s : 1 - s) and its first and second derivatives in x_t (the
    resolution chain rule included; slot_fused.py::_geom_weights). The
    fused slot kernels run on these; the vertex layout has none."""
    if spec.layout != "cell":
        raise NotImplementedError(
            f"cell_factors: the {spec.layout} layout has no cell entries (cell layout only)")
    k = spec.num_levels if num_levels is None else min(num_levels, spec.num_levels)
    dev = x.device
    s, ds, dds, b = _grid_coords(x, spec, k)
    res = spec.resolutions[:k]
    resi = torch.as_tensor(res.astype(np.int64), device=dev)
    ents = torch.as_tensor(spec.level_entries[:k], device=dev)
    row_hash = _hash(b) & (ents - 1)[None, :]
    row_dense = b[..., 0] + (b[..., 1] + b[..., 2] * resi[None, :]) * resi[None, :]
    dense = torch.as_tensor(res.astype(np.int64) ** 3 <= spec.rows_per_level, device=dev)
    row = torch.where(dense[None, :], row_dense, row_hash)
    offs = torch.as_tensor(spec.level_offsets[:k] * spec.entries_per_row, device=dev)
    idx = row + offs[None, :]
    bits = _corner_bits(dev)[None, None].expand(x.shape[0], k, NSLOT, 3)
    return (idx, *_axis_factors(bits, s, ds, dds, x.dtype))


def _vertex_factors(x: torch.Tensor, spec: SlotGridSpec, num_levels: Optional[int] = None):
    """Vertex-layout rows and per-axis trilerp factors (slot_grid.py:288-303).

    x [N, 3] in [0, 1]. Returns idx [N, K*8] int64 absolute rows (column
    l*8 + p: the row of the corner whose PARITY is p) and wa, dwa [N, K, 8,
    3]. With group coordinate gb = b >> 1 and parity par = b & 1, slot p's
    corner has offset bits d8 = par ^ bits(p) and group gb + (par & d8),
    whose row is its dense index over (res // 2 + 1)^3 groups when that
    fits rows_per_level, else its hash masked to the level's rows."""
    k = spec.num_levels if num_levels is None else min(num_levels, spec.num_levels)
    n, dev = x.shape[0], x.device
    s, ds, dds, b = _grid_coords(x, spec, k)
    par, gb = b & 1, b >> 1
    d8 = torch.bitwise_xor(par[:, :, None, :], _corner_bits(dev)[None, None])  # [N, K, 8, 3]
    g8 = gb[:, :, None, :] + (par[:, :, None, :] & d8)
    gdims = spec.resolutions[:k].astype(np.int64) // 2 + 1
    gd = torch.as_tensor(gdims, device=dev)[None, :, None]
    row_dense = g8[..., 0] + (g8[..., 1] + g8[..., 2] * gd) * gd  # [N, K, 8]
    ents = torch.as_tensor(spec.level_entries[:k], device=dev)
    row_hash = _hash(g8) & (ents - 1)[None, :, None]
    dense = torch.as_tensor(gdims**3 <= spec.rows_per_level, device=dev)
    row8 = torch.where(dense[None, :, None], row_dense, row_hash)
    offs = torch.as_tensor(spec.level_offsets[:k], device=dev)
    idx = (row8 + offs[None, :, None]).reshape(n, k * NSLOT)
    wa, dwa, _ = _axis_factors(d8, s, ds, dds, x.dtype)
    return idx, wa, dwa


def slot_geometry(x: torch.Tensor, spec: SlotGridSpec, num_levels: Optional[int] = None):
    """Rows and trilerp weights of either layout (slot_grid.py:212-319).

    x [N, 3] in [0, 1]. Returns idx (cell: [N, K] int64 ABSOLUTE entry
    indices, level row offset * P + entry; vertex: [N, K*8] int64 absolute
    rows, one per corner), w [N, K*8] f32 (column l*8 + p: corner offset
    bits p = dx + 2 dy + 4 dz in the cell layout, corner parity p in the
    vertex layout) and dw [N, 3*K*8] f32 with column t*K*8 + c = d w[:, c] /
    d x[:, t]. The hash runs in int64 masked to 32 bits, the uint32
    arithmetic of the reference."""
    if spec.layout == "cell":
        idx, wa, dwa, _ = cell_factors(x, spec, num_levels)
    else:
        idx, wa, dwa = _vertex_factors(x, spec, num_levels)
    n, k = x.shape[0], wa.shape[1]
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


# ------------------------------------------------------------ K6: the lookup


def _round(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if bf16 else x


def _gather(table, idx, feats, bf16):
    """The corner values T [N, k, F, 8] of each sample's entry per level
    (lane f * 8 + p of the entry), rounded to bf16 in bf16-table mode."""
    n, k = idx.shape
    entries = _round(table.float(), bf16).reshape(-1, NSLOT * feats)  # one row per entry
    return entries[idx].reshape(n, k, feats, NSLOT)


def _vertex_elements(idx):
    """Flat table element indices [N, k, 16, 8] of the vertex layout's
    corner values: row idx[n, l*8 + p] * 128 + lane f*8 + p, the lanes of
    parity p in slot p's row (_fwd_kernel :487-507)."""
    n, k = idx.shape[0], idx.shape[1] // NSLOT
    lanes = torch.arange(LANE, device=idx.device).reshape(FEAT, NSLOT)  # f * 8 + p
    return idx.reshape(n, k, 1, NSLOT) * LANE + lanes


def _combine(T, w, dw, bf16):
    """enc [N, k*F] (and with dw, tenc [N, 3*k*F], column t*k*F + l*F + f)
    from the corner values T [N, k, F, 8]: the 8-corner sums weighted by w
    (and dw)."""
    n, k, feats, _ = T.shape
    wb = _round(w.float(), bf16).reshape(n, k, 1, NSLOT)
    enc = _round(T * wb, bf16).sum(-1).reshape(n, k * feats)
    if dw is None:
        return enc
    dwb = _round(dw.float(), bf16).reshape(n, 3, k, 1, NSLOT)
    tenc = _round(T[:, None] * dwb, bf16).sum(-1).reshape(n, 3 * k * feats)
    return enc, tenc


def _bwd_terms(T, w, dw, genc, gtenc, bf16):
    """From the corner values T [N, k, F, 8] and the cotangents: d_w [N,
    k*8], d_dw [N, 3*k*8] or None, and the scatter values u [N, k, F, 8]
    (rounded to bf16 in bf16-table mode)."""
    n, k, feats, _ = T.shape
    gt = _round(genc.float(), bf16).reshape(n, k, feats, 1)
    d_w = _round(T * gt, bf16).sum(2).reshape(n, k * NSLOT)
    u = gt * _round(w.float(), bf16).reshape(n, k, 1, NSLOT)  # [N, k, F, 8]
    d_dw = None
    if dw is not None:
        gtk = _round(gtenc.float(), bf16).reshape(n, 3, k, feats, 1)
        dwb = _round(dw.float(), bf16).reshape(n, 3, k, 1, NSLOT)
        d_dw = _round(T[:, None] * gtk, bf16).sum(3).reshape(n, 3 * k * NSLOT)
        for t in range(3):
            u = u + gtk[:, t] * dwb[:, t]
    return d_w, d_dw, _round(u, bf16)


def slot_lookup_plain(table, idx, w, dw, *, feats: int, bf16: bool):
    """Plain PyTorch version of K6's forward (_fwd_kernel :415-523): idx
    [N, k] absolute entry indices, w [N, k*8], dw [N, 3*k*8] or None.
    Returns enc [N, k*F] f32 and, with dw, tenc [N, 3*k*F] f32 (column
    t*k*F + l*F + f)."""
    return _combine(_gather(table, idx, feats, bf16), w, dw, bf16)


def slot_lookup_bwd_plain(table, idx, w, dw, genc, gtenc, *, feats: int, bf16: bool):
    """Plain PyTorch version of K6's backward (_bwd_kernel :536-629) at its
    cast points: cotangents genc [N, k*F] (and gtenc [N, 3*k*F] with dw) in;
    returns (d_table [rows, 128] f32, d_w [N, k*8] f32, d_dw [N, 3*k*8] f32
    or None)."""
    d_w, d_dw, u = _bwd_terms(_gather(table, idx, feats, bf16), w, dw, genc, gtenc, bf16)
    width = NSLOT * feats
    d = torch.zeros(table.shape[0] * (LANE // width), width, device=table.device)
    d.index_add_(0, idx.reshape(-1), u.reshape(-1, width))
    return d.reshape(table.shape), d_w, d_dw


def slot_lookup_vertex_plain(table, idx, w, dw):
    """Plain PyTorch version of K6v's forward (_fwd_kernel's vertex branch
    :487-507, then the float32 dots :516-523): idx [N, k*8] absolute rows,
    w [N, k*8], dw [N, 3*k*8] or None; exact f32. Returns enc [N, k*16]
    (and tenc [N, 3*k*16]) as slot_lookup_plain."""
    return _combine(table.float().reshape(-1)[_vertex_elements(idx)], w, dw, False)


def slot_lookup_vertex_bwd_plain(table, idx, w, dw, genc, gtenc):
    """Plain PyTorch version of K6v's backward (_bwd_kernel :536-662, its
    vertex branch's masked row updates): d_table[idx[n, l*8 + p], f*8 + p]
    += u[n, l, f, p] and d_w, d_dw as slot_lookup_bwd_plain, exact f32."""
    el = _vertex_elements(idx)
    d_w, d_dw, u = _bwd_terms(table.float().reshape(-1)[el], w, dw, genc, gtenc, False)
    d = torch.zeros(table.numel(), device=table.device)
    d.index_add_(0, el.reshape(-1), u.reshape(-1))
    return d.reshape(table.shape), d_w, d_dw


def _f32(t):
    return None if t is None else t.float().contiguous()


def _launch_fwd(table, idx, w, dw, feats, bf16):
    """K6's forward kernel: enc (and tenc with dw)."""
    if idx.device.type != "cuda":
        raise ValueError(f"slot_grid_lookup: unsupported device {idx.device}")
    n, k = idx.shape
    tbl, ix, wc, dwc = _f32(table), idx.long().contiguous(), _f32(w), _f32(dw)
    enc = torch.empty((n, k * feats), dtype=torch.float32, device=idx.device)
    tenc = None if dw is None else torch.empty((n, 3 * k * feats), dtype=torch.float32,
                                               device=idx.device)
    if n:
        fn = build.function("slot_grid", "mms_slot_lookup_fwd", "ptr", "ptr", "ptr", "ptr", "int",
                            "int", "int", "int", "ptr", "ptr", "ptr")
        status = fn(build.ptr(tbl), build.ptr(ix), build.ptr(wc), build.ptr(dwc), n, k, feats,
                    int(bf16), build.ptr(enc), build.ptr(tenc), build.stream_of(ix))
        build.check(status, "slot_grid_lookup")
        KERNEL.launches += 1
    return enc if dw is None else (enc, tenc)


def _launch_bwd(table, idx, w, dw, genc, gtenc, feats, bf16):
    """K6's backward kernel: (d_table, d_w, d_dw or None)."""
    if idx.device.type != "cuda":
        raise ValueError(f"slot_grid_lookup: unsupported device {idx.device}")
    n, k = idx.shape
    dev = idx.device
    tbl, ix, wc, dwc = _f32(table), idx.long().contiguous(), _f32(w), _f32(dw)
    ge, gte = _f32(genc), _f32(gtenc if dw is not None else None)
    d_table = torch.zeros(table.shape, dtype=torch.float32, device=dev)
    d_w = torch.empty((n, k * NSLOT), dtype=torch.float32, device=dev)
    d_dw = None if dw is None else torch.empty((n, 3 * k * NSLOT), dtype=torch.float32, device=dev)
    if n:
        fn = build.function("slot_grid", "mms_slot_lookup_bwd", "ptr", "ptr", "ptr", "ptr", "ptr",
                            "ptr", "int", "int", "int", "int", "ptr", "ptr", "ptr", "ptr")
        status = fn(build.ptr(tbl), build.ptr(ix), build.ptr(wc), build.ptr(dwc), build.ptr(ge),
                    build.ptr(gte), n, k, feats, int(bf16), build.ptr(d_table), build.ptr(d_w),
                    build.ptr(d_dw), build.stream_of(ix))
        build.check(status, "slot_grid_lookup backward")
        BWD_KERNEL.launches += 1
    return d_table, d_w, d_dw


def _launch_vertex_fwd(table, idx, w, dw):
    """K6v's forward kernel: enc (and tenc with dw)."""
    if idx.device.type != "cuda":
        raise ValueError(f"slot_grid_lookup (vertex layout): unsupported device {idx.device}")
    n, k = idx.shape[0], idx.shape[1] // NSLOT
    tbl, ix, wc, dwc = _f32(table), idx.long().contiguous(), _f32(w), _f32(dw)
    enc = torch.empty((n, k * FEAT), dtype=torch.float32, device=idx.device)
    tenc = None if dw is None else torch.empty((n, 3 * k * FEAT), dtype=torch.float32,
                                               device=idx.device)
    if n:
        fn = build.function("slot_grid", "mms_slot_vertex_fwd", "ptr", "ptr", "ptr", "ptr", "int",
                            "int", "ptr", "ptr", "ptr")
        status = fn(build.ptr(tbl), build.ptr(ix), build.ptr(wc), build.ptr(dwc), n, k,
                    build.ptr(enc), build.ptr(tenc), build.stream_of(ix))
        build.check(status, "slot_grid_lookup (vertex layout)")
        VERTEX_KERNEL.launches += 1
    return enc if dw is None else (enc, tenc)


def _launch_vertex_bwd(table, idx, w, dw, genc, gtenc):
    """K6v's backward kernel: (d_table, d_w, d_dw or None)."""
    if idx.device.type != "cuda":
        raise ValueError(f"slot_grid_lookup (vertex layout): unsupported device {idx.device}")
    n, k = idx.shape[0], idx.shape[1] // NSLOT
    dev = idx.device
    tbl, ix, wc, dwc = _f32(table), idx.long().contiguous(), _f32(w), _f32(dw)
    ge, gte = _f32(genc), _f32(gtenc if dw is not None else None)
    d_table = torch.zeros(table.shape, dtype=torch.float32, device=dev)
    d_w = torch.empty((n, k * NSLOT), dtype=torch.float32, device=dev)
    d_dw = None if dw is None else torch.empty((n, 3 * k * NSLOT), dtype=torch.float32, device=dev)
    if n:
        fn = build.function("slot_grid", "mms_slot_vertex_bwd", "ptr", "ptr", "ptr", "ptr", "ptr",
                            "ptr", "int", "int", "ptr", "ptr", "ptr", "ptr")
        status = fn(build.ptr(tbl), build.ptr(ix), build.ptr(wc), build.ptr(dwc), build.ptr(ge),
                    build.ptr(gte), n, k, build.ptr(d_table), build.ptr(d_w), build.ptr(d_dw),
                    build.stream_of(ix))
        build.check(status, "slot_grid_lookup backward (vertex layout)")
        VERTEX_BWD_KERNEL.launches += 1
    return d_table, d_w, d_dw


def _lookup(table, idx, w, dw, feats, bf16, vertex=False):
    """The plain version for a CPU tensor, the kernel for any other (which
    raises off a card): K6, or with `vertex` K6v."""
    if vertex:
        if idx.device.type == "cpu":
            return slot_lookup_vertex_plain(table, idx, w, dw)
        return _launch_vertex_fwd(table, idx, w, dw)
    if idx.device.type == "cpu":
        return slot_lookup_plain(table, idx, w, dw, feats=feats, bf16=bf16)
    return _launch_fwd(table, idx, w, dw, feats, bf16)


def _lookup_bwd(table, idx, w, dw, genc, gtenc, feats, bf16, vertex=False):
    """The backward of _lookup, dispatched as it is."""
    if vertex:
        if idx.device.type == "cpu":
            return slot_lookup_vertex_bwd_plain(table, idx, w, dw, genc, gtenc)
        return _launch_vertex_bwd(table, idx, w, dw, genc, gtenc)
    if idx.device.type == "cpu":
        return slot_lookup_bwd_plain(table, idx, w, dw, genc, gtenc, feats=feats, bf16=bf16)
    return _launch_bwd(table, idx, w, dw, genc, gtenc, feats, bf16)


class _Lookup(torch.autograd.Function):
    """K6 or K6v with its backward (_lookup_fn's op_fwd / op_bwd :813-841):
    saves (table, idx, w, dw), not the gathered rows; idx has no
    cotangent. cfg = (feats, bf16[, vertex])."""

    @staticmethod
    def forward(ctx, cfg, table, idx, w, dw):
        ctx.cfg = cfg
        ctx.save_for_backward(table, idx, w, dw)
        return _lookup(table, idx, w, dw, *cfg)

    @staticmethod
    def backward(ctx, genc, gtenc=None):
        table, idx, w, dw = ctx.saved_tensors
        d_table, d_w, d_dw = _lookup_bwd(table, idx, w, dw, genc, gtenc, *ctx.cfg)
        return None, d_table.to(table.dtype), None, d_w.to(w.dtype), (
            None if d_dw is None else d_dw.to(dw.dtype))


def slot_grid_lookup(table: torch.Tensor, x: torch.Tensor, spec: SlotGridSpec,
                     num_levels: Optional[int] = None, with_tangents: bool = False):
    """Slot-grid encoding enc [N, spec.out_dim] of x [N, 3] in [0, 1]
    (zero columns for the levels past num_levels), and with_tangents its
    spatial tangents tenc [3, N, spec.out_dim] = d enc / d x. Differentiable
    in the table (the backward of K6, or of K6v for the vertex layout) and
    in x (autograd through the geometry's w and dw, second order
    included)."""
    k = spec.num_levels if num_levels is None else min(num_levels, spec.num_levels)
    n, feats = x.shape[0], spec.feats
    idx, w, dw = slot_geometry(x, spec, k)
    if not with_tangents:
        dw = None
    cfg = (feats, spec.table_dtype == "bf16", spec.layout == "vertex")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (table, x)):
        out = _Lookup.apply(cfg, table, idx, w, dw)
    else:
        out = _lookup(table, idx, w, dw, *cfg)
    enc, tenc = (out, None) if dw is None else out
    pad = (spec.num_levels - k) * feats
    if pad:
        enc = torch.nn.functional.pad(enc, (0, pad))
    if tenc is None:
        return enc
    # unfold the lane-folded tangents outside the op (slot_grid.py:933-939)
    tenc = tenc.reshape(n, 3, k * feats).permute(1, 0, 2)
    if pad:
        tenc = torch.nn.functional.pad(tenc, (0, pad))
    return enc, tenc
