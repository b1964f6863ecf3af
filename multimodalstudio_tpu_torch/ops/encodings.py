"""Input encodings: NeRF frequency, spherical harmonics and the
multiresolution hash grid (JAX reference: ops/encodings.py).

The hash grid is plain PyTorch, as the reference computes it outside any
kernel: per-level corner indices (dense and collision-free where
(res+1)^3 fits the table, XOR-hashed elsewhere), one row gather of the
table, and a backward that recomputes the indices and weights, adds the
table cotangent with index_add_ and chains the position cotangent through
the interpolation weights."""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from multimodalstudio_tpu_torch.ops.math import components_from_spherical_harmonics


def nerf_encoding(
    x: torch.Tensor,
    num_frequencies: int,
    min_freq_exp: float,
    max_freq_exp: float,
    include_input: bool = True,
) -> torch.Tensor:
    """[..., D] -> [..., D*2*F (+D)]: sin of [scaled, scaled + pi/2] with
    frequencies 2**linspace(min, max, F), optional raw input prepended."""
    exps = np.linspace(min_freq_exp, max_freq_exp, num_frequencies, dtype=np.float32)
    freqs = torch.as_tensor(np.exp2(exps), device=x.device)
    scaled = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)  # [..., D*F]
    encoded = torch.sin(torch.cat([scaled, scaled + np.float32(np.pi / 2.0)], dim=-1))
    if include_input:
        encoded = torch.cat([x, encoded], dim=-1)
    return encoded


def sh_encoding(directions: torch.Tensor, degree: int) -> torch.Tensor:
    return components_from_spherical_harmonics(degree + 1, directions)


@functools.lru_cache(maxsize=None)
def _sh_dense_coeffs(levels: int):
    """Monomial-basis coefficients C_k with SH(d) = C0 + d@C1 + d2@C2 + d3@C3
    + d4@C4, fitted by least squares on the unit sphere (exact up to ~1e-7:
    every real SH component up to degree 4 is a polynomial of degree <= 4)."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(4096, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    m2 = (d[:, :, None] * d[:, None, :]).reshape(-1, 9)
    m3 = (m2[:, :, None] * d[:, None, :]).reshape(-1, 27)
    m4 = (m3[:, :, None] * d[:, None, :]).reshape(-1, 81)
    design = np.concatenate([np.ones((d.shape[0], 1)), d, m2, m3, m4], axis=1)
    # the closed form evaluated in float32, as the reference evaluates it
    target = components_from_spherical_harmonics(levels, d.astype(np.float32))
    c, *_ = np.linalg.lstsq(design, target.astype(np.float64), rcond=None)
    c = c.astype(np.float32)
    return (c[0:1], c[1:4], c[4:13], c[13:40], c[40:121])


def sh_encoding_dense(directions: torch.Tensor, degree: int) -> torch.Tensor:
    """SH through dense monomial outer products and four small matmuls;
    numerically equal to `sh_encoding` for unit directions."""
    c0, c1, c2, c3, c4 = (
        torch.as_tensor(c, device=directions.device) for c in _sh_dense_coeffs(degree + 1)
    )
    lead = directions.shape[:-1]
    d = directions.reshape(-1, 3)
    m2 = (d[:, :, None] * d[:, None, :]).reshape(-1, 9)
    m3 = (m2[:, :, None] * d[:, None, :]).reshape(-1, 27)
    m4 = (m3[:, :, None] * d[:, None, :]).reshape(-1, 81)
    out = c0[0] + d @ c1 + m2 @ c2 + m3 @ c3 + m4 @ c4
    return out.reshape(*lead, -1)


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Static geometry of a multiresolution hash grid. `vjp_mode` "custom"
    runs the lookup as an autograd Function that saves only (table, x);
    "autodiff" runs it as plain autograd ops, which torch.func can also
    differentiate forward. `gather_mode` ("rows" or "flat") is a TPU layout
    choice of the reference; the port has one gather path for both."""

    num_levels: int = 16
    features_per_level: int = 2
    min_res: int = 16
    max_res: int = 2048
    log2_hashmap_size: int = 19
    hash_init_scale: float = 0.001
    interpolation: str = "Smoothstep"  # Nearest | Linear | Smoothstep
    dense: bool = False
    vjp_mode: str = "custom"
    gather_mode: str = "rows"

    @property
    def growth_factor(self) -> float:
        if self.num_levels == 1:
            return 1.0
        return float(
            np.exp((np.log(self.max_res) - np.log(self.min_res)) / (self.num_levels - 1))
        )

    @property
    def table_size(self) -> int:
        return 2 ** self.log2_hashmap_size

    @property
    def resolutions(self) -> np.ndarray:
        levels = np.arange(self.num_levels)
        return np.floor(self.min_res * self.growth_factor ** levels).astype(np.int32)

    @property
    def out_dim(self) -> int:
        return self.num_levels * self.features_per_level


# XOR-hash primes of the reference (uint32)
HASH_PRIMES = (1, 2654435761, 805459861)


def _levels(spec: HashGridSpec, num_levels: Optional[int]) -> int:
    """The levels a lookup reads; a truncation past the grid reads them all."""
    return spec.num_levels if num_levels is None else min(num_levels, spec.num_levels)


def grid_geometry(x: torch.Tensor, spec: HashGridSpec, num_levels: Optional[int] = None):
    """Corner indices and interpolation weights of every level read
    (encodings.py:173-232). x [N, 3] in [0, 1]. Returns (idx [L, 8, N]
    int32 rows of the flat table, w [L, 2, 3, N] the per-axis factors of
    bit 0 and bit 1, offset [L, 3, N] the fractional offsets).

    A corner's index is a function of its integer coordinates per axis, so
    each axis's term is made once per bit ([L, 2, N]) and the 8 corners
    (c = 4 * bx + 2 * by + bz) are their broadcast. The uint32 products of
    the hash keep their low 32 bits in int64 arithmetic, and the table size
    is a power of two below 2^32, so the masked int64 XOR equals the
    reference's uint32 one. A hashed term is below the table size once
    masked, and the dense terms take a zero stride on the hashed levels, so
    the corners are combined in int32."""
    n_levels = _levels(spec, num_levels)
    res_np = spec.resolutions[:n_levels]
    res = torch.as_tensor(res_np, dtype=x.dtype, device=x.device)
    scaled = res[:, None, None] * x.T[None]  # [L, 3, N]
    floor = torch.floor(scaled)
    offset = scaled - floor
    base = floor.long()
    bit = torch.arange(2, device=x.device)[None, :, None]
    axis = [base[:, None, d] + bit for d in range(3)]  # [L, 2, N] per axis, int64

    dense_levels = (res_np.astype(np.int64) + 1) ** 3 <= spec.table_size  # [L], static
    if spec.dense and not dense_levels.all():
        bad = res_np[~dense_levels]
        raise ValueError(
            f"dense grid requested but levels with res {bad.tolist()} exceed "
            f"table size 2^{spec.log2_hashmap_size}; raise log2_hashmap_size")
    mask = spec.table_size - 1
    h = [((a * p) & mask).int() for a, p in zip(axis, HASH_PRIMES)]
    idx = h[0][:, :, None, None] ^ h[1][:, None, :, None] ^ h[2][:, None, None, :]
    if dense_levels.any():
        stride = torch.as_tensor(np.where(dense_levels, res_np.astype(np.int64) + 1, 0),
                                 device=x.device)[:, None, None]
        d = [(a * stride**i).int() for i, a in enumerate(axis)]
        dense = d[0][:, :, None, None] + d[1][:, None, :, None] + d[2][:, None, None, :]
        is_dense = torch.as_tensor(dense_levels, device=x.device)[:, None, None, None, None]
        idx = torch.where(is_dense, dense, idx)
    level_offsets = torch.arange(n_levels, dtype=torch.int32, device=x.device) * spec.table_size
    idx = idx.reshape(n_levels, 8, -1) + level_offsets[:, None, None]

    if spec.interpolation == "Smoothstep":
        w1 = offset * offset * (3.0 - 2.0 * offset)
    elif spec.interpolation == "Linear":
        w1 = offset
    elif spec.interpolation == "Nearest":
        w1 = torch.round(offset)
    else:
        raise ValueError(f"unknown interpolation {spec.interpolation}")
    return idx, torch.stack([1.0 - w1, w1], dim=1), offset


def corner_weights(w: torch.Tensor) -> torch.Tensor:
    """Trilinear corner weights [L, 8, N] from the per-axis factors
    [L, 2, 3, N]: fx * fy * fz, multiplied in that order as the reference
    does."""
    fx, fy, fz = w[:, :, 0], w[:, :, 1], w[:, :, 2]  # [L, 2, N]
    cw = fx[:, :, None, None] * fy[:, None, :, None] * fz[:, None, None, :]
    return cw.reshape(w.shape[0], 8, -1)


def _lookup(table: torch.Tensor, x: torch.Tensor, spec: HashGridSpec,
            num_levels: Optional[int] = None) -> torch.Tensor:
    """Interpolated features [N, num_levels * F] (encodings.py:235-264) in
    plain ops; levels past a truncation are zero."""
    n, nf = x.shape[0], spec.features_per_level
    k = _levels(spec, num_levels)
    idx, w, _ = grid_geometry(x, spec, k)
    feats = table.index_select(0, idx.reshape(-1)).reshape(k, 8, n, nf)
    out = (corner_weights(w)[..., None] * feats).sum(1)  # [L, N, F]
    out = out.permute(1, 0, 2).reshape(n, k * nf)
    if k < spec.num_levels:
        out = nn.functional.pad(out, (0, (spec.num_levels - k) * nf))
    return out


class _HashLookup(torch.autograd.Function):
    """The reference's custom VJP (encodings.py:267-349): the forward saves
    only (table, x); the backward recomputes the geometry, adds the table
    cotangent with index_add_ and chains the position cotangent through the
    interpolation weights."""

    @staticmethod
    def forward(ctx, table, x, spec):
        ctx.spec = spec
        ctx.save_for_backward(table, x)
        return _lookup(table, x, spec)

    @staticmethod
    def backward(ctx, g):
        table, x = ctx.saved_tensors
        spec = ctx.spec
        d_table, d_x = hash_lookup_backward(table, x, spec, g,
                                            ctx.needs_input_grad[0], ctx.needs_input_grad[1])
        return d_table, d_x, None


def hash_lookup_backward(table: torch.Tensor, x: torch.Tensor, spec: HashGridSpec,
                         g: torch.Tensor, want_table: bool = True, want_x: bool = True
                         ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(d table [L*T, F], d x [N, 3]) of the lookup for the cotangent
    g [N, L*F] (encodings.py:278-345), each None when not wanted."""
    n, nf, nl = x.shape[0], spec.features_per_level, spec.num_levels
    idx, w, offset = grid_geometry(x, spec)
    cw = corner_weights(w)
    flat_idx = idx.reshape(-1)
    g_lnf = g.reshape(n, nl, nf).permute(1, 0, 2)  # [L, N, F]
    d_table = d_x = None
    if want_table:
        updates = (cw[..., None] * g_lnf[:, None]).reshape(-1, nf)
        d_table = torch.zeros_like(table).index_add_(0, flat_idx, updates)
    if want_x:
        feats = table.index_select(0, flat_idx).reshape(nl, 8, n, nf)
        fg = (feats * g_lnf[:, None]).sum(-1)  # [L, 8, N]
        fgc = fg.reshape(nl, 2, 2, 2, n)
        fx, fy, fz = w[:, :, 0], w[:, :, 1], w[:, :, 2]  # [L, 2, N]
        # d cw / d w_d = sign_d * product of the other two axes' factors
        sign = torch.tensor([-1.0, 1.0], dtype=x.dtype, device=x.device)[:, None]
        dwx = (fgc * (fy[:, None, :, None] * fz[:, None, None, :])).sum((2, 3))
        dwy = (fgc * (fx[:, :, None, None] * fz[:, None, None, :])).sum((1, 3))
        dwz = (fgc * (fx[:, :, None, None] * fy[:, None, :, None])).sum((1, 2))
        dw = torch.stack([(d * sign).sum(1) for d in (dwx, dwy, dwz)], dim=1)  # [L, 3, N]
        if spec.interpolation == "Smoothstep":
            dw_doff = 6.0 * offset * (1.0 - offset)
        elif spec.interpolation == "Linear":
            dw_doff = torch.ones_like(offset)
        else:  # Nearest
            dw_doff = torch.zeros_like(offset)
        res = torch.as_tensor(spec.resolutions, dtype=x.dtype, device=x.device)[:, None, None]
        d_x = (dw * dw_doff * res).sum(0).T
    return d_table, d_x


def hash_grid_lookup(table: torch.Tensor, x: torch.Tensor, spec: HashGridSpec,
                     num_levels: Optional[int] = None) -> torch.Tensor:
    """Multiresolution hash-grid encoding (encodings.py:352-392).

    table [num_levels * table_size, F], x [N, 3] in [0, 1] ->
    [N, num_levels * F]. With vjp_mode "autodiff", or truncated to the
    first `num_levels` levels (the sampler's queries), the lookup is plain
    autograd ops; else the autograd Function with the reference's
    backward."""
    if spec.vjp_mode == "autodiff" or num_levels is not None:
        return _lookup(table, x, spec, num_levels)
    return _HashLookup.apply(table, x, spec)


class HashEncoding(nn.Module):
    """Owns the hash table [num_levels * table_size, F]; init uniform in
    +-hash_init_scale (encodings.py:395-417)."""

    def __init__(self, spec: HashGridSpec, device=None):
        super().__init__()
        self.spec = spec
        self.table = nn.Parameter(torch.zeros(
            (spec.num_levels * spec.table_size, spec.features_per_level), device=device))

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        u = torch.rand(self.table.shape, generator=gen, device=gen.device)
        self.table.copy_((u * 2.0 - 1.0) * self.spec.hash_init_scale)

    def forward(self, x: torch.Tensor, num_levels: Optional[int] = None) -> torch.Tensor:
        return hash_grid_lookup(self.table, x, self.spec, num_levels)
