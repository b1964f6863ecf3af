"""Lens distortion: Newton undistortion on the camera plane and the
forward model it inverts (JAX reference: ops/distortion.py). Parameters
are OpenCV-style [k1, k2, k3, k4, p1, p2]."""

from __future__ import annotations

import torch


def _residual_and_jacobian(x, y, xd, yd, params):
    k1, k2, k3, k4 = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    p1, p2 = params[..., 4], params[..., 5]
    r = x * x + y * y
    d = 1.0 + r * (k1 + r * (k2 + r * (k3 + r * k4)))
    fx = d * x + 2.0 * p1 * x * y + p2 * (r + 2.0 * x * x) - xd
    fy = d * y + 2.0 * p2 * x * y + p1 * (r + 2.0 * y * y) - yd
    d_r = k1 + r * (2.0 * k2 + r * (3.0 * k3 + r * 4.0 * k4))
    d_x = 2.0 * x * d_r
    d_y = 2.0 * y * d_r
    fx_x = d + d_x * x + 2.0 * p1 * y + 6.0 * p2 * x
    fx_y = d_y * x + 2.0 * p1 * x + 2.0 * p2 * y
    fy_x = d_x * y + 2.0 * p2 * y + 2.0 * p1 * x
    fy_y = d + d_y * y + 2.0 * p2 * x + 6.0 * p1 * y
    return fx, fy, fx_x, fx_y, fy_x, fy_y


def radial_and_tangential_undistort(
    coords: torch.Tensor, distortion_params: torch.Tensor, eps: float = 1e-3,
    max_iterations: int = 10,
) -> torch.Tensor:
    """Undistort camera-plane coords [..., 2] given params [..., 6]; Newton
    steps gated on |det J| > eps."""
    xd, yd = coords[..., 0], coords[..., 1]
    x, y = xd, yd
    for _ in range(max_iterations):
        fx, fy, fx_x, fx_y, fy_x, fy_y = _residual_and_jacobian(x, y, xd, yd, distortion_params)
        denom = fy_x * fx_y - fx_x * fy_y
        x_num = fx * fy_y - fy * fx_y
        y_num = fy * fx_x - fx * fy_x
        ok = denom.abs() > eps
        x = x + torch.where(ok, x_num / denom, torch.zeros_like(denom))
        y = y + torch.where(ok, y_num / denom, torch.zeros_like(denom))
    return torch.stack([x, y], dim=-1)


def distort(coords: torch.Tensor, distortion_params: torch.Tensor) -> torch.Tensor:
    """The forward OpenCV distortion of camera-plane coords [..., 2], the
    map radial_and_tangential_undistort inverts (distortion.py:70-83)."""
    x, y = coords[..., 0], coords[..., 1]
    p = distortion_params
    k1, k2, k3, k4, p1, p2 = (p[..., i] for i in range(6))
    r = x * x + y * y
    d = 1.0 + r * (k1 + r * (k2 + r * (k3 + r * k4)))
    xd = d * x + 2.0 * p1 * x * y + p2 * (r + 2.0 * x * x)
    yd = d * y + 2.0 * p2 * x * y + p1 * (r + 2.0 * y * y)
    return torch.stack([xd, yd], dim=-1)
