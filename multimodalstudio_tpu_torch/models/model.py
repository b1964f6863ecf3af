"""The multimodal NeuS model, eval forward (JAX reference: models/model.py).

Shared SDF geometry, a shared radiance trunk with per-modality heads, and a
NeRF background, rendered for a flat ray batch with the hit mask carried
as a float vector. On the slot-grid methods the SDF goes through the fused
slot kernels: sampler queries through K2 (value only, the first
`sampler_levels` levels), render samples through K3 (sdf, geometric
features and d sdf/dx). The MLP chains of the trunk, the polarization
heads and the background run as K1 (fields/mlp.py).

The module tree mirrors the reference's params tree, so every state-dict
key is the dotted flax path (convert.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from multimodalstudio_tpu_torch.core.rays import (
    RayBundle,
    RaySamples,
    alphas_from_densities,
    weights_from_alphas,
)
from multimodalstudio_tpu_torch.device import resolve_device, set_reference_precision
from multimodalstudio_tpu_torch.fields.components import (
    ModalityHead,
    PolarizationHead,
    SingleVariance,
)
from multimodalstudio_tpu_torch.fields.fields import (
    NeRFField,
    NeRFFieldSpec,
    RadianceField,
    RadianceFieldSpec,
    SDFField,
    SDFFieldSpec,
)
from multimodalstudio_tpu_torch.fields.mlp import MLPSpec, can_fuse
from multimodalstudio_tpu_torch.models.colliders import background_bounds, sphere_collide
from multimodalstudio_tpu_torch.models.samplers import (
    NeuSSamplerSpec,
    SpacedSamplerSpec,
    neus_sampling,
    spaced_sampling,
)
from multimodalstudio_tpu_torch.models.volume_rendering import neus_weights
from multimodalstudio_tpu_torch.ops.encodings import sh_encoding_dense
from multimodalstudio_tpu_torch.ops.kernels.slot_fused import (
    fused_slot_sdf_chain,
    fused_slot_sdf_value,
)
from multimodalstudio_tpu_torch.ops.kernels.slot_grid import SlotGridSpec
from multimodalstudio_tpu_torch.ops.math import scene_contraction


@dataclasses.dataclass(frozen=True)
class HeadSpec:
    mlp: MLPSpec = MLPSpec(num_layers=1, hidden_dim=64, out_activation="Sigmoid")
    polarization: bool = False


@dataclasses.dataclass(frozen=True)
class SurfaceModelSpec:
    surface_field: SDFFieldSpec = SDFFieldSpec()
    use_numerical_gradients: bool = False
    numerical_gradient_taps: int = 4
    compute_hessian: bool = False
    variance_init: float = 0.3
    anneal_end_ratio: float = 0.05
    rendering: str = "neus"  # neus | volsdf
    beta_min: float = 1e-4
    contraction_order: Optional[float] = None
    sampler_levels: Optional[int] = None  # grid levels of the sampler's SDF queries
    curvature_tap_stride: int = 1
    curvature_taps: int = 4


@dataclasses.dataclass(frozen=True)
class RadianceModelSpec:
    radiance_field: RadianceFieldSpec = RadianceFieldSpec()
    use_direction_encoding: bool = True
    sh_degree: int = 4
    use_reflection_direction: bool = True
    use_n_dot_v: bool = True
    radiance_feature_dim: int = 256
    contraction_order: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class BackgroundModelSpec:
    field: NeRFFieldSpec = NeRFFieldSpec()
    radiance_feature_dim: int = 128
    contraction_order: Optional[float] = float("inf")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    modalities: Tuple[Tuple[str, int], ...] = (("rgb", 3),)
    heads: Tuple[Tuple[str, HeadSpec], ...] = ()
    ray_sampler: NeuSSamplerSpec = NeuSSamplerSpec(num_samples=32, num_samples_importance=32)
    background_ray_sampler: SpacedSamplerSpec = SpacedSamplerSpec(
        num_samples=16, spacing="lin_disparity"
    )
    surface: SurfaceModelSpec = SurfaceModelSpec()
    radiance: RadianceModelSpec = RadianceModelSpec()
    background: BackgroundModelSpec = BackgroundModelSpec()
    use_background: bool = True
    remat: bool = True
    scene_radius: float = 1.0
    collider_type: str = "sphere"  # sphere | near_far | box
    near_far: Tuple[float, float] = (0.05, 4.0)
    aabb: Tuple[Tuple[float, float, float], Tuple[float, float, float]] = (
        (-1.0, -1.0, -1.0),
        (1.0, 1.0, 1.0),
    )
    background_color: str = "None"  # None | white | black | random

    def head_spec(self, mod: str) -> HeadSpec:
        for name, spec in self.heads:
            if name == mod:
                return spec
        return HeadSpec()

    @property
    def modality_names(self) -> Tuple[str, ...]:
        return tuple(m for m, _ in self.modalities)

    @property
    def modality_channels(self) -> Dict[str, int]:
        return dict(self.modalities)


@dataclasses.dataclass(frozen=True)
class ScheduleState:
    """Per-step schedule values (engine/train.py::make_schedules)."""

    cos_anneal_ratio: float
    active_level: int
    numerical_delta: float


def _head_module(spec: HeadSpec, in_dim: int, channels: int, device):
    if spec.polarization:
        return PolarizationHead(spec.mlp, in_dim, device=device)
    return ModalityHead(spec.mlp, in_dim, channels, device=device)


class MMSModel(nn.Module):
    """Eval-time renderer of the multimodal NeuS model. `device` defaults to
    the card and raises without one; pass device="cpu" for the plain
    versions of the kernels."""

    def __init__(self, spec: ModelSpec, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        set_reference_precision()
        self.spec = spec
        self.surface_field = SDFField(spec.surface.surface_field, device=dev)
        self.variance = SingleVariance(spec.surface.variance_init, device=dev)
        rspec = spec.radiance
        dir_dim = (rspec.sh_degree + 1) ** 2 if rspec.use_direction_encoding else 3
        extra_dim = spec.surface.surface_field.geo_feature_dim + (1 if rspec.use_n_dot_v else 0)
        self.radiance_field = RadianceField(
            rspec.radiance_field, 3 + dir_dim + extra_dim, rspec.radiance_feature_dim, device=dev
        )
        self.heads = nn.ModuleDict({
            mod: _head_module(spec.head_spec(mod), rspec.radiance_feature_dim, ch, dev)
            for mod, ch in spec.modalities
        })
        if spec.use_background:
            bspec = spec.background
            self.background_field = NeRFField(bspec.field, bspec.radiance_feature_dim, device=dev)
            self.background_heads = nn.ModuleDict({
                mod: _head_module(spec.head_spec(mod), bspec.radiance_feature_dim, ch, dev)
                for mod, ch in spec.modalities
            })

    @property
    def device(self) -> torch.device:
        return self.variance.s.device

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "MMSModel":
        """Draw every parameter from the reference's init distributions
        (geometric SDF init, he-uniform MLPs, uniform table, variance)."""
        for module in self.modules():
            if hasattr(module, "init_params"):
                module.init_params(generator)
        return self

    # ----------------------------------------------------------- SDF queries
    def _slot_grid(self):
        fspec = self.spec.surface.surface_field
        grid = fspec.field.grid
        ok = (
            grid is not None
            and isinstance(grid.encoding, SlotGridSpec)
            and can_fuse(fspec.field.mlp)
            and fspec.field.mlp.out_activation in (None, "None")
            and self.spec.surface.contraction_order is None
            and fspec.use_position_encoding
            and fspec.position_encoding.include_input
        )
        if not ok:
            raise NotImplementedError(
                "only the fused slot-grid surface (grid_raw_tpu) is ported"
            )
        return self.surface_field.field.grid_mlp

    def _slot_kwargs(self, grid_mlp):
        fspec = self.spec.surface.surface_field
        mspec, pspec = fspec.field.mlp, fspec.position_encoding
        ws, bs = grid_mlp.mlp_head.effective_weights()
        return (grid_mlp.feature_grid.encoding.table, ws, bs, fspec.field.grid.encoding), dict(
            radius=fspec.field.grid.radius, num_frequencies=pspec.num_frequencies,
            min_freq_exp=pspec.min_freq_exp, max_freq_exp=pspec.max_freq_exp,
            skip=mspec.skip_connections, activation=mspec.activation,
            beta=mspec.activation_beta,
        )

    def sdf_only(self, positions: torch.Tensor, active_level, max_level: Optional[int] = None):
        """SDF values [...] at positions [..., 3] through K2."""
        grid_mlp = self._slot_grid()
        enc = self.spec.surface.surface_field.field.grid.encoding
        k = enc.num_levels if max_level is None else min(int(max_level), enc.num_levels)
        args, kw = self._slot_kwargs(grid_mlp)
        sdf = fused_slot_sdf_value(
            positions.reshape(-1, 3), *args, **kw,
            level_mask=grid_mlp.feature_grid.level_mask(active_level, k), num_levels=k,
        )
        return sdf.reshape(positions.shape[:-1])

    def sdf_gradients(self, positions: torch.Tensor, schedules: ScheduleState):
        """(sdf [...], geo [..., G] bf16, d sdf/dx [..., 3]) through K3."""
        if self.spec.surface.use_numerical_gradients:
            raise NotImplementedError("numerical SDF gradients are not ported")
        grid_mlp = self._slot_grid()
        enc = self.spec.surface.surface_field.field.grid.encoding
        args, kw = self._slot_kwargs(grid_mlp)
        sdf, geo, grad = fused_slot_sdf_chain(
            positions.reshape(-1, 3), *args, **kw,
            level_mask=grid_mlp.feature_grid.level_mask(schedules.active_level, enc.num_levels),
        )
        lead = positions.shape[:-1]
        return sdf.reshape(lead), geo.reshape(*lead, -1), grad.reshape(positions.shape)

    def inv_s(self) -> torch.Tensor:
        return self.variance()[0]

    # --------------------------------------------------------------- forward
    @torch.no_grad()
    def forward(
        self,
        rays: RayBundle,
        segments: Tuple[Tuple[str, int], ...],
        schedules: ScheduleState,
        train: bool = False,
        aligned: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """Render a flat ray batch (eval). `segments` is the static
        (modality, num_rays) split of the batch; with `aligned` every head
        renders every ray. Returns per-modality radiance, normals, depth,
        accumulation and the hit mask."""
        if train:
            raise NotImplementedError("the training forward is not ported yet")
        spec = self.spec
        if spec.collider_type != "sphere":
            raise NotImplementedError("only the sphere collider is ported")
        if spec.surface.rendering != "neus":
            raise NotImplementedError("only NeuS rendering is ported")
        collided, mask = sphere_collide(rays, spec.scene_radius)
        samples = neus_sampling(
            collided,
            lambda pos: self.sdf_only(pos, schedules.active_level, spec.surface.sampler_levels),
            spec.ray_sampler,
        )
        background = None
        if spec.use_background:
            bg_rays = background_bounds(rays, mask, spec.scene_radius)
            bg_samples = spaced_sampling(bg_rays, spec.background_ray_sampler)
            background = self._background_forward(bg_samples, segments, aligned)

        sdf, geo, gradients = self.sdf_gradients(samples.start_positions(), schedules)
        norm = torch.linalg.vector_norm(gradients, dim=-1, keepdim=True)
        normals = gradients / norm.clamp_min(1e-12)
        weights = neus_weights(samples, sdf, gradients, self.inv_s(), schedules.cos_anneal_ratio)
        radiance = self._radiance_forward(samples, normals, geo, segments, aligned)

        outputs: Dict[str, torch.Tensor] = {}
        acc = weights.sum(-1, keepdim=True)
        m = mask[:, None]
        for mod, seg in self._iter_segments(segments, aligned):
            w, a, mm = weights[seg], acc[seg], m[seg]
            comp = (w[..., None] * radiance[mod]).sum(-2)
            bg = self._background_color(mod, background, comp)
            outputs[mod] = mm * (comp + bg * (1.0 - a)) + (1.0 - mm) * bg
        steps = (samples.starts + samples.ends) * 0.5
        depth = (weights * steps).sum(-1, keepdim=True).clamp(steps.min(), steps.max())
        outputs["normals"] = m * (weights[..., None] * normals).sum(-2)
        outputs["depth"] = m * depth
        outputs["accumulation"] = m * acc
        outputs["mask"] = mask
        return outputs

    def _iter_segments(self, segments, aligned):
        if aligned:
            for mod, _ in self.spec.modalities:
                yield mod, slice(None)
        else:
            offset = 0
            for mod, n in segments:
                yield mod, slice(offset, offset + n)
                offset += n

    def _background_color(self, mod, background, like):
        bgc = self.spec.background_color
        if bgc == "white":
            return torch.ones_like(like)
        if bgc == "black" or background is None:
            return torch.zeros_like(like)
        if bgc == "random":
            raise NotImplementedError("random background colours are a training option")
        return background[mod]

    def _apply_heads(self, heads, feature, samples: RaySamples, segments, aligned):
        n, s = samples.num_rays, samples.num_samples
        feature_r = feature.reshape(n, s, -1)
        dirs_r = samples.directions[:, None, :].expand(n, s, 3)
        ups_r = samples.up_directions[:, None, :].expand(n, s, 3)
        outputs = {}
        for mod, seg in self._iter_segments(segments, aligned):
            f, d, u = feature_r[seg], dirs_r[seg], ups_r[seg]
            out = heads[mod](
                f.reshape(-1, f.shape[-1]), d.reshape(-1, 3), u.reshape(-1, 3)
            )
            outputs[mod] = out.reshape(f.shape[0], s, -1)
        return outputs

    def _radiance_forward(self, samples: RaySamples, normals, geo, segments, aligned):
        """Shared trunk + per-modality heads."""
        spec = self.spec.radiance
        n, s = samples.num_rays, samples.num_samples
        pos = samples.start_positions().reshape(-1, 3)
        if spec.contraction_order is not None:
            pos = scene_contraction(pos, spec.contraction_order)
        dirs = samples.directions[:, None, :].expand(n, s, 3).reshape(-1, 3)
        nrm = normals.reshape(-1, 3)
        n_dot_v = (nrm * -dirs).sum(-1, keepdim=True)
        extras = [geo.reshape(-1, geo.shape[-1]).float()]
        if spec.use_n_dot_v:
            extras.append(n_dot_v)
        dir_input = dirs
        if spec.use_reflection_direction:
            dir_input = 2.0 * (n_dot_v * nrm) + dirs
        if spec.use_direction_encoding:
            dir_input = sh_encoding_dense(dir_input, spec.sh_degree)
        feature = self.radiance_field(pos, dir_input, torch.cat(extras, dim=-1))
        return self._apply_heads(self.heads, feature, samples, segments, aligned)

    def _background_forward(self, samples: RaySamples, segments, aligned):
        """NeRF background: per-modality radiance alpha-composited along the
        background samples."""
        spec = self.spec.background
        n, s = samples.num_rays, samples.num_samples
        pos = samples.start_positions().reshape(-1, 3)
        if spec.contraction_order is not None:
            pos = scene_contraction(pos, spec.contraction_order)
        dirs = samples.directions[:, None, :].expand(n, s, 3).reshape(-1, 3)
        density, feature = self.background_field(pos, dirs)
        weights = weights_from_alphas(alphas_from_densities(samples.deltas, density.reshape(n, s)))
        outs = self._apply_heads(self.background_heads, feature, samples, segments, aligned)
        outputs = {}
        for mod, seg in self._iter_segments(segments, aligned):
            outputs[mod] = (weights[seg][..., None] * outs[mod]).sum(-2)
        return outputs
