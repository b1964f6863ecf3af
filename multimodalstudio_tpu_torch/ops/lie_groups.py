"""Lie-group exponential maps for pose optimization
(JAX reference: ops/lie_groups.py). All math is float32."""

from __future__ import annotations

import torch


def _skew(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrices."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def exp_map_SO3xR3(tangent: torch.Tensor) -> torch.Tensor:
    """exp of SO(3) x R^3: [..., 6] (translation first) -> [..., 3, 4];
    Rodrigues rotation with the 1e-4 squared-angle clamp."""
    log_rot = tangent[..., 3:]
    nrms = (log_rot * log_rot).sum(-1)
    rot_angles = torch.sqrt(nrms.clamp_min(1e-4))
    inv = 1.0 / rot_angles
    fac1 = inv * torch.sin(rot_angles)
    fac2 = inv * inv * (1.0 - torch.cos(rot_angles))
    skews = _skew(log_rot)
    skews_sq = skews @ skews
    eye = torch.eye(3, dtype=tangent.dtype, device=tangent.device).expand(skews.shape)
    rot = fac1[..., None, None] * skews + fac2[..., None, None] * skews_sq + eye
    return torch.cat([rot, tangent[..., :3, None]], dim=-1)


def exp_map_SE3(tangent: torch.Tensor) -> torch.Tensor:
    """exp: se(3) -> SE(3), [..., 6] -> [..., 3, 4], Taylor switch below
    theta = 1e-2."""
    lin, ang = tangent[..., :3], tangent[..., 3:]
    theta = torch.linalg.vector_norm(ang, dim=-1, keepdim=True)
    theta2, theta3 = theta**2, theta**3
    near_zero = theta < 1e-2
    one = torch.ones_like(theta)
    theta_nz = torch.where(near_zero, one, theta)
    theta2_nz = torch.where(near_zero, one, theta2)
    theta3_nz = torch.where(near_zero, one, theta3)
    sine = torch.sin(theta)
    cosine = torch.where(near_zero, 8.0 / (4.0 + theta2) - 1.0, torch.cos(theta))
    sine_by_theta = torch.where(near_zero, 0.5 * cosine + 0.5, sine / theta_nz)
    omc_by_theta2 = torch.where(near_zero, 0.5 * sine_by_theta, (1.0 - cosine) / theta2_nz)
    outer = ang[..., :, None] * ang[..., None, :]
    eye = torch.eye(3, dtype=tangent.dtype, device=tangent.device).expand(outer.shape)
    rot = omc_by_theta2[..., None] * outer + cosine[..., None] * eye
    rot = rot + sine_by_theta[..., None] * _skew(ang)
    sine_by_theta_t = torch.where(near_zero, 1.0 - theta2 / 6.0, sine_by_theta)
    omc_by_theta2_t = torch.where(near_zero, 0.5 - theta2 / 24.0, omc_by_theta2)
    t_m_s_by_theta3 = torch.where(near_zero, 1.0 / 6.0 - theta2 / 120.0, (theta - sine) / theta3_nz)
    trans = (
        sine_by_theta_t * lin
        + omc_by_theta2_t * torch.linalg.cross(ang, lin, dim=-1)
        + t_m_s_by_theta3 * ang * (ang * lin).sum(-1, keepdim=True)
    )
    return torch.cat([rot, trans[..., :, None]], dim=-1)


def pose_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose [..., 3, 4] rigid transforms (a @ b)."""
    rot = a[..., :3, :3] @ b[..., :3, :3]
    trans = a[..., :3, :3] @ b[..., :3, 3:] + a[..., :3, 3:]
    return torch.cat([rot, trans], dim=-1)
