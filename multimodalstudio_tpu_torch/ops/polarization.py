"""Mueller-calculus polarization optics (JAX reference: ops/polarization.py).

A Stokes vector (s0, s1, s2) is rotated into the camera polarizer frame and
projected to linear-polarizer intensities at 0/45/90/135 degrees.
"""

from __future__ import annotations

import math

import torch

_POLARIZER_ROWS = [
    [0.5, 0.5, 0.0],
    [0.5, 0.0, 0.5],
    [0.5, -0.5, 0.0],
    [0.5, 0.0, -0.5],
]
_DATA_TO_STOKES = [
    [0.5, 0.5, 0.5, 0.5],
    [1.0, 0.0, -1.0, 0.0],
    [0.0, 1.0, 0.0, -1.0],
]


def _const(rows, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(rows, dtype=like.dtype, device=like.device)


def mueller_rotate(theta: torch.Tensor) -> torch.Tensor:
    """Mueller rotation matrix, [...] -> [..., 3, 3]."""
    c, s = torch.cos(2.0 * theta), torch.sin(2.0 * theta)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    rows = torch.stack([one, zero, zero, zero, c, s, zero, -s, c], dim=-1)
    return rows.reshape(*theta.shape, 3, 3)


def mueller_linear_polarizer(theta: torch.Tensor) -> torch.Tensor:
    """Mueller matrix of a linear polarizer at angle theta, [...] ->
    [..., 3, 3] (polarization.py:48-55)."""
    c, s = torch.cos(2.0 * theta), torch.sin(2.0 * theta)
    rows = 0.5 * torch.stack([torch.ones_like(c), c, s, c, c * c, c * s, s, c * s, s * s], dim=-1)
    return rows.reshape(*theta.shape, 3, 3)


def align_polarization_filters(
    stokes: torch.Tensor, directions: torch.Tensor, up_directions: torch.Tensor
) -> torch.Tensor:
    """Rotate Stokes vectors [..., 3] into the camera polarizer frame."""
    world_z = torch.zeros_like(directions)
    world_z[..., 2] = 1.0
    normal = torch.linalg.cross(directions, world_z, dim=-1)
    normal = normal / (torch.linalg.vector_norm(normal, dim=-1, keepdim=True) + 1e-12)
    cos_theta = (normal * up_directions).sum(-1).clamp(-1.0 + 1e-4, 1.0 - 1e-4)
    theta = torch.arccos(cos_theta) - math.pi / 2.0
    return (mueller_rotate(theta) @ stokes[..., None])[..., 0]


def stokes_to_intensity(stokes: torch.Tensor):
    """Stokes [..., 3] -> (4 polarizer intensities, normalized coefficients)."""
    channels = stokes @ _const(_POLARIZER_ROWS, stokes).T
    total = 0.5 * channels.sum(-1, keepdim=True)
    return channels, channels / (total + 1e-10)


def _stokes_from(data, stokes):
    if stokes is not None:
        return stokes
    assert data is not None, "either data (4ch) or stokes (3ch) must be given"
    return data @ _const(_DATA_TO_STOKES, data).T


def to_dop(data=None, stokes=None) -> torch.Tensor:
    """Degree of linear polarization, [..., 4|3] -> [...]."""
    s = _stokes_from(data, stokes)
    return torch.linalg.vector_norm(s[..., 1:], dim=-1) / s[..., 0]


def to_aop(data=None, stokes=None) -> torch.Tensor:
    """Angle of linear polarization in [0, pi]."""
    s = _stokes_from(data, stokes)
    aop = 0.5 * torch.atan2(s[..., 2], s[..., 1] + 1e-7)
    aop = torch.where(aop < 0, aop + math.pi, aop)
    return aop.clamp(0.0, math.pi)
