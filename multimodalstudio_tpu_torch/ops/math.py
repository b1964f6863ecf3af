"""Spherical harmonics, scene contraction and image metrics
(JAX reference: ops/math.py)."""

from __future__ import annotations

import torch

_SH_C = (
    0.28209479177387814, 0.4886025119029199, 1.0925484305920792,
    0.9461746957575601, 0.31539156525251999, 0.5462742152960396,
    0.5900435899266435, 2.890611442640554, 0.4570457994644658,
    0.3731763325901154, 1.445305721320277, 2.5033429417967046,
    1.7701307697799304, 0.6690465435572892, 0.10578554691520431,
    0.47308734787878004, 0.4425326924449826,
)


def components_from_spherical_harmonics(levels: int, directions):
    """Real SH basis, [..., 3] unit directions -> [..., levels**2]; levels in
    [1, 5]. Works on torch tensors and numpy arrays alike."""
    assert 1 <= levels <= 5, f"SH levels must be in [1,5], got {levels}"
    c = _SH_C
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    comps = [x * 0 + c[0]]
    if levels > 1:
        comps += [c[1] * y, c[1] * z, c[1] * x]
    if levels > 2:
        comps += [
            c[2] * x * y, c[2] * y * z, c[3] * zz - c[4], c[2] * x * z, c[5] * (xx - yy),
        ]
    if levels > 3:
        comps += [
            c[6] * y * (3 * xx - yy), c[7] * x * y * z, c[8] * y * (5 * zz - 1),
            c[9] * z * (5 * zz - 3), c[8] * x * (5 * zz - 1), c[10] * z * (xx - yy),
            c[6] * x * (xx - 3 * yy),
        ]
    if levels > 4:
        comps += [
            c[11] * x * y * (xx - yy), c[12] * y * z * (3 * xx - yy),
            c[3] * x * y * (7 * zz - 1), c[13] * y * (7 * zz - 3),
            c[14] * (35 * zz * zz - 30 * zz + 3), c[13] * x * z * (7 * zz - 3),
            c[15] * (xx - yy) * (7 * zz - 1), c[12] * x * z * (xx - 3 * yy),
            c[16] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    if isinstance(directions, torch.Tensor):
        return torch.stack(comps, dim=-1)
    import numpy as np

    return np.stack(comps, axis=-1)


def scene_contraction(positions: torch.Tensor, order=None) -> torch.Tensor:
    """MipNeRF-360 contraction: identity inside the unit ball, 2 - 1/|x|
    radially outside; order=inf uses the L-inf norm."""
    if order is None:
        mag = torch.linalg.vector_norm(positions, dim=-1, keepdim=True)
    elif order == float("inf"):
        mag = positions.abs().amax(dim=-1, keepdim=True)
    else:
        mag = torch.linalg.vector_norm(positions, ord=order, dim=-1, keepdim=True)
    mag_safe = mag.clamp_min(1e-12)
    contracted = (2.0 - 1.0 / mag_safe) * (positions / mag_safe)
    return torch.where(mag >= 1.0, contracted, positions)


def psnr(pred: torch.Tensor, target: torch.Tensor, mask=None) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB for [0, 1] images."""
    err = (pred - target) ** 2
    if mask is not None:
        if mask.shape != err.shape:
            mse = (err * mask).sum() / (mask.sum() * err.shape[-1]).clamp_min(1.0)
        else:
            mse = (err * mask).sum() / mask.sum().clamp_min(1.0)
    else:
        mse = err.mean()
    return -10.0 * torch.log10(mse.clamp_min(1e-12))


def _gaussian_kernel1d(sigma: float, radius: int, device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _conv_last(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Valid 1-D correlation along the last axis: windows @ kernel (a
    float32 matmul; TF32 stays off, see device.set_reference_precision)."""
    return img.unfold(-1, kernel.shape[0], 1) @ kernel


def ssim_map(pred, target, max_val=1.0, filter_size=11, filter_sigma=1.5, k1=0.01, k2=0.03):
    """Per-pixel Gaussian-window SSIM map of [H, W, C] images."""
    radius = filter_size // 2
    kernel = _gaussian_kernel1d(filter_sigma, radius, pred.device)

    def blur(img):
        img = img.permute(2, 0, 1)[None]  # [1, C, H, W]
        img = torch.nn.functional.pad(img, (radius,) * 4, mode="replicate")[0]
        img = _conv_last(img, kernel)  # along W
        img = _conv_last(img.transpose(-1, -2), kernel).transpose(-1, -2)  # along H
        return img.permute(1, 2, 0)

    mu_p, mu_t = blur(pred), blur(target)
    mu_pp = blur(pred * pred) - mu_p * mu_p
    mu_tt = blur(target * target) - mu_t * mu_t
    mu_pt = blur(pred * target) - mu_p * mu_t
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    num = (2 * mu_p * mu_t + c1) * (2 * mu_pt + c2)
    den = (mu_p**2 + mu_t**2 + c1) * (mu_pp + mu_tt + c2)
    return num / den


def ssim(pred, target, **kw) -> torch.Tensor:
    return ssim_map(pred, target, **kw).mean()


def masked_ssim(pred, target, mask=None) -> torch.Tensor:
    """SSIM map over the full images, averaged over the [H, W, 1] mask."""
    smap = ssim_map(pred, target)
    if mask is None:
        return smap.mean()
    m = mask.expand_as(smap)
    return (smap * m).sum() / m.sum().clamp_min(1.0)

