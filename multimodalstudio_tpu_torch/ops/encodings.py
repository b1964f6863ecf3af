"""Input encodings: NeRF frequency and spherical harmonics
(JAX reference: ops/encodings.py). The XLA hash grid is not ported yet;
only its spec dataclass is, because method configs name it."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

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
    """Static geometry of the XLA multiresolution hash grid."""

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
