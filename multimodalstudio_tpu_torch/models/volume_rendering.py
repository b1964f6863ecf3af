"""Volume rendering: NeuS sigmoid-CDF alphas, the VolSDF Laplace density
and the NeuS logistic density (JAX reference: models/volume_rendering.py)."""

from __future__ import annotations

import torch

from multimodalstudio_tpu_torch.core.rays import RaySamples, weights_from_alphas


def neus_alphas(ray_samples: RaySamples, sdf, gradients, inv_s, cos_anneal_ratio: float):
    """Per-sample NeuS alpha [N, S] from section-estimated SDFs, with the
    true cos(view, grad) annealed in by cos_anneal_ratio."""
    true_cos = (ray_samples.directions[:, None, :] * gradients).sum(-1)
    iter_cos = -(
        torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
        + torch.relu(-true_cos) * cos_anneal_ratio
    )
    est_next = sdf + iter_cos * ray_samples.deltas * 0.5
    est_prev = sdf - iter_cos * ray_samples.deltas * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    return ((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)).clamp(0.0, 1.0)


def neus_weights(ray_samples: RaySamples, sdf, gradients, inv_s, cos_anneal_ratio: float):
    """NeuS compositing weights [N, S]."""
    return weights_from_alphas(neus_alphas(ray_samples, sdf, gradients, inv_s, cos_anneal_ratio))


def laplace_density(sdf: torch.Tensor, beta: torch.Tensor, beta_min: float = 1e-4) -> torch.Tensor:
    """VolSDF Laplace-CDF density with b = |beta| + beta_min
    (volume_rendering.py:68-71); the model's beta already holds beta_min
    once, and the reference adds it here again."""
    b = beta.abs() + beta_min
    return (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-sdf.abs() / b)) / b


def neus_s_density(sdf: torch.Tensor, inv_s: torch.Tensor) -> torch.Tensor:
    """NeuS logistic density s e^{-s x} / (1 + e^{-s x})^2
    (volume_rendering.py:74-79)."""
    e = torch.exp(-sdf * inv_s)
    return (inv_s * e) / (1.0 + e) ** 2
