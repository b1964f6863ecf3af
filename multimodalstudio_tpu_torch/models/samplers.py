"""Ray samplers: spaced and NeuS hierarchical, eval branch
(JAX reference: models/samplers.py). Without stratification every draw is
deterministic: bins are evenly spaced and the inverse-CDF lookups use the
bin centres (:128-134). Training's jittered draws come with the training
slice."""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from multimodalstudio_tpu_torch.core.rays import (
    RayBundle,
    RaySamples,
    samples_from_bins,
    weights_from_alphas,
)


@dataclasses.dataclass(frozen=True)
class SpacedSamplerSpec:
    num_samples: int = 32
    train_stratified: bool = True
    single_jitter: bool = False
    spacing: str = "uniform"  # uniform | lin_disparity


@dataclasses.dataclass(frozen=True)
class NeuSSamplerSpec:
    num_samples: int = 32
    num_samples_importance: int = 64
    num_upsample_steps: int = 4
    base_variance: float = 64.0
    train_stratified: bool = True
    single_jitter: bool = True


def linspace(start: float, stop: float, num: int, like: torch.Tensor) -> torch.Tensor:
    """float32 evenly spaced values, start * (1 - t) + stop * t with
    t = i / (num - 1) in float32 (the reference's rounding, which
    torch.linspace does not reproduce)."""
    start, stop = np.float32(start), np.float32(stop)
    t = np.arange(num - 1, dtype=np.float32) / np.float32(num - 1)
    out = np.append(start * (np.float32(1) - t) + stop * t, stop).astype(np.float32)
    return torch.as_tensor(out, device=like.device)


def spacing_to_euclidean(spacing_bins, nears, fars, spacing: str):
    """Map normalized [0, 1] bins to euclidean depth."""
    if spacing == "uniform":
        return fars * spacing_bins + nears * (1.0 - spacing_bins)
    if spacing == "lin_disparity":
        return 1.0 / ((1.0 / fars) * spacing_bins + (1.0 / nears) * (1.0 - spacing_bins))
    raise ValueError(f"unknown spacing {spacing}")


def spaced_sampling(rays: RayBundle, spec: SpacedSamplerSpec, num_samples=None) -> RaySamples:
    """Evenly spaced bins through the spacing function."""
    ns = num_samples or spec.num_samples
    bins = linspace(0.0, 1.0, ns + 1, rays.origins)[None, :].expand(rays.num_rays, ns + 1)
    euclid = spacing_to_euclidean(bins, rays.nears, rays.fars, spec.spacing)
    return samples_from_bins(rays, euclid, bins)


def pdf_sample_bins(existing_bins, weights, num_samples: int, histogram_padding: float = 0.01,
                    eps: float = 1e-5):
    """Inverse-CDF bin edges [N, num_samples+1] at the centres of
    num_samples+1 equal CDF slices; existing_bins [N, S+1], weights [N, S].
    The search is a comparison sweep: cdf and bins ascend along each row."""
    num_bins = num_samples + 1
    w = weights + histogram_padding
    w_sum = w.sum(-1, keepdim=True)
    padding = torch.relu(eps - w_sum)
    w = w + padding / w.shape[-1]
    w_sum = w_sum + padding
    cdf = torch.cumsum(w / w_sum, dim=-1).clamp_max(1.0)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # [N, S+1]

    u = linspace(0.0, 1.0 - 1.0 / num_bins, num_bins, cdf) + 1.0 / (2 * num_bins)
    u = u[None, :].expand(cdf.shape[0], num_bins)
    cmp = u[:, :, None] >= cdf[:, None, :]  # [N, K, S+1]
    big = 1e10
    cdf_g0 = torch.where(cmp, cdf[:, None, :], -big).amax(-1)
    bins_g0 = torch.where(cmp, existing_bins[:, None, :], -big).amax(-1)
    cdf_g1 = torch.where(cmp, big, cdf[:, None, :]).amin(-1)
    bins_g1 = torch.where(cmp, big, existing_bins[:, None, :]).amin(-1)
    cdf_g1 = torch.minimum(cdf_g1, cdf[:, -1:])
    bins_g1 = torch.minimum(bins_g1, existing_bins[:, -1:])
    denom = cdf_g1 - cdf_g0
    t = torch.where(denom > 0, (u - cdf_g0) / denom, torch.zeros_like(denom))
    t = torch.nan_to_num(t).clamp(0.0, 1.0)
    return bins_g0 + t * (bins_g1 - bins_g0)


def merge_sorted(a: torch.Tensor, b: torch.Tensor, *value_pairs):
    """Merge two per-row ascending lists [N, Sa] and [N, Sb]; ties keep a
    before b. Each (va, vb) pair rides the same permutation. Returns
    (merged, *merged_values)."""
    sa, sb = a.shape[1], b.shape[1]
    rank_a = torch.arange(sa, device=a.device)[None] + (b[:, None, :] < a[:, :, None]).sum(-1)
    rank_b = torch.arange(sb, device=a.device)[None] + (a[:, None, :] <= b[:, :, None]).sum(-1)

    def place(va, vb):
        out = va.new_empty(va.shape[0], sa + sb)
        out.scatter_(1, rank_a, va)
        out.scatter_(1, rank_b, vb)
        return out

    out = [place(a, b)] + [place(va, vb) for va, vb in value_pairs]
    return tuple(out) if len(out) > 1 else out[0]


def rendering_sdf_with_fixed_inv_s(euclid_bins, sdf, inv_s: float):
    """NeuS section alpha at a fixed inverse variance; sdf [N, S] at the
    first S of the [N, S+1] edges. Returns alphas [N, S-1]."""
    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    deltas = (euclid_bins[:, 1:] - euclid_bins[:, :-1])[:, :-1]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos_val = (next_sdf - prev_sdf) / (deltas + 1e-5)
    prev_cos = torch.cat([torch.zeros_like(cos_val[:, :1]), cos_val[:, :-1]], dim=-1)
    cos_val = torch.minimum(prev_cos, cos_val).clamp(-1e3, 0.0)
    prev_esti = mid_sdf - cos_val * deltas * 0.5
    next_esti = mid_sdf + cos_val * deltas * 0.5
    prev_cdf = torch.sigmoid(prev_esti * inv_s)
    next_cdf = torch.sigmoid(next_esti * inv_s)
    return (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)


def neus_sampling(
    rays: RayBundle, sdf_fn: Callable[[torch.Tensor], torch.Tensor], spec: NeuSSamplerSpec
) -> RaySamples:
    """NeuS hierarchical sampling: uniform bins, then num_upsample_steps
    rounds that draw new bins from the fixed-variance section alphas; SDF
    is evaluated only at new samples and cached values ride the merge."""
    n_steps = spec.num_upsample_steps
    n_per_round = spec.num_samples_importance // n_steps
    uniform = spaced_sampling(rays, SpacedSamplerSpec(num_samples=spec.num_samples))
    bins = torch.cat([uniform.spacing_starts, uniform.spacing_ends[:, -1:]], dim=-1)
    euclid = spacing_to_euclidean(bins, rays.nears, rays.fars, "uniform")

    def eval_sdf_at(spacing_starts):
        e = spacing_to_euclidean(spacing_starts, rays.nears, rays.fars, "uniform")
        return sdf_fn(rays.origins[:, None, :] + rays.directions[:, None, :] * e[..., None])

    sdf = eval_sdf_at(bins[:, :-1])
    for i in range(n_steps):
        alphas = rendering_sdf_with_fixed_inv_s(euclid, sdf, inv_s=spec.base_variance * 2.0**i)
        weights = weights_from_alphas(alphas)
        weights = torch.cat([weights, torch.zeros_like(weights[:, :1])], dim=-1)
        new_edges = pdf_sample_bins(bins, weights, n_per_round, histogram_padding=1e-5)
        new_starts = new_edges[:, :-1]
        end = torch.maximum(bins[:, -1:], new_edges[:, -1:])
        if i < n_steps - 1:
            sorted_starts, sdf = merge_sorted(bins[:, :-1], new_starts, (sdf, eval_sdf_at(new_starts)))
        else:
            sorted_starts = merge_sorted(bins[:, :-1], new_starts)
        bins = torch.cat([sorted_starts, end], dim=-1)
        euclid = spacing_to_euclidean(bins, rays.nears, rays.fars, "uniform")
    return samples_from_bins(rays, euclid, bins)
