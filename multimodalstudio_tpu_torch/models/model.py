"""The multimodal NeuS model, eval and training forward (JAX reference:
models/model.py).

Shared SDF geometry, a shared radiance trunk with per-modality heads, and a
NeRF background, rendered for a flat ray batch with the hit mask carried
as a float vector. On a slot-grid surface whose position encoding includes
the input (grid_raw_tpu) the SDF goes through the fused slot kernels:
sampler queries through K2 (value only, the first `sampler_levels`
levels), render samples through K3 (sdf, geometric features and d sdf/dx).
Without a position encoding (or with one that leaves the input out), the
sampler queries run the SDF field (the slot-grid lookup K6, then the K1
head) and the render samples the two-kernel composition: K6 with its
spatial tangents, K5 (the chain and d sdf / d input from one reverse
sweep), and the tangents contracted outside. On the grid-less methods
(mlp_raw_tpu) sampler queries run the SDF field (position encoding, then a
K1 chain) and render samples K4 (encoding, chain and d sdf/dx in one
kernel; K4j, its forward-tangent form, under MMS_SDF_CHAIN_MODE=jvp). A
grid-less surface with a scene contraction, or without an input-including
position encoding, takes the generic route: the encoding's tangents along
the 3 axes outside the kernels, then K1 with those tangents (K1t) for sdf,
geo and d sdf/dx. The MLP chains of the trunk, the polarization heads and
the background run as K1 (fields/mlp.py).

In training the kernels run as autograd Functions with CUDA backwards,
and the curvature loss's hessian proxy comes from SDF taps through the
SDF value route with gradient (curvature_hessian_taps).

The reference methods (grid, mlp and their raw, unbalanced, decimated and
hash-grid-background variants) run no kernel: their MLPs are float32
chains and their grids the plain hash grid (ops/encodings.py). Their SDF
gradients come from numerical taps (the grid methods: 4 or 6 SDF queries
per sample, and the hessian diagonal from the same taps) or from
vmap(jacfwd) through the SDF field (the mlp methods), and in training the
three field regions (background, SDF with its gradients, radiance) are
recomputed in the backward (`remat`, torch.utils.checkpoint).

The module tree mirrors the reference's params tree, so every state-dict
key is the dotted flax path (convert.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from multimodalstudio_tpu_torch.core.rays import (
    RayBundle,
    RaySamples,
    alphas_from_densities,
    weights_from_alphas,
    weights_from_densities,
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
from multimodalstudio_tpu_torch.models.colliders import (
    background_bounds,
    box_collide,
    near_far_collide,
    sphere_collide,
)
from multimodalstudio_tpu_torch.models.samplers import (
    NeuSSamplerSpec,
    SpacedSamplerSpec,
    neus_sampling,
    spaced_sampling,
)
from multimodalstudio_tpu_torch.models.volume_rendering import laplace_density, neus_weights
from multimodalstudio_tpu_torch.ops.encodings import sh_encoding_dense
from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import fused_chain
from multimodalstudio_tpu_torch.ops.kernels.sdf_chain import fused_chain_adjoint, fused_sdf_chain
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


TETRAHEDRON = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))


def curvature_hessian_taps(sdf_fn, tap_pos, base_sdf, delta: float, n_taps: int):
    """Numerical hessian-trace proxy for the curvature loss (model.py:196-226).

    n_taps=4: the tetrahedron taps, sum_i k_i k_i^T = 4I. n_taps=2: the
    antipodal pair +-k_j with k_j cycling through the tetrahedron
    directions by sample index (j = index % 4). Returns the [..., 3]
    per-axis stack the curvature loss reads (hxx replicated, / 3)."""
    d = delta / math.sqrt(3.0)
    k = torch.tensor(TETRAHEDRON, dtype=tap_pos.dtype, device=tap_pos.device)
    if n_taps == 2:
        kj = k[torch.arange(tap_pos.shape[-2], device=tap_pos.device) % 4]  # [S, 3]
        taps = torch.stack([tap_pos + kj * d, tap_pos - kj * d], dim=-2)
        hxx = (sdf_fn(taps).sum(-1) - 2.0 * base_sdf) / delta**2
    elif n_taps == 4:
        taps = tap_pos[..., None, :] + k * d
        hxx = (sdf_fn(taps).sum(-1) / 2.0 - 2.0 * base_sdf) / delta**2
    else:
        raise ValueError("curvature_taps must be 2 or 4")
    return torch.stack([hxx, hxx, hxx], dim=-1) / 3.0


def _head_module(spec: HeadSpec, in_dim: int, channels: int, device):
    if spec.polarization:
        return PolarizationHead(spec.mlp, in_dim, device=device)
    return ModalityHead(spec.mlp, in_dim, channels, device=device)


class MMSModel(nn.Module):
    """The multimodal NeuS model: eval renderer and training forward.
    `device` defaults to the card and raises without one; pass device="cpu"
    for the plain versions of the kernels."""

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
    def _fused_slot(self) -> bool:
        """The surface is a slot grid whose MLP runs fused with no output
        activation and no contraction (the slot branch of sdf_gradients,
        model.py:411-422)."""
        spec = self.spec.surface
        fspec = spec.surface_field
        grid = fspec.field.grid
        return (grid is not None and isinstance(grid.encoding, SlotGridSpec)
                and can_fuse(fspec.field.mlp) and fspec.field.mlp.out_activation in (None, "None")
                and spec.contraction_order is None)

    def _slot_value_ok(self) -> bool:
        """Sampler and tap SDF queries take the fused value kernel K2
        (model.py:324-337): the fused slot surface with an input-including
        position encoding."""
        fspec = self.spec.surface.surface_field
        return (self._fused_slot() and fspec.use_position_encoding
                and fspec.position_encoding.include_input)

    def _slot_kwargs(self):
        fspec = self.spec.surface.surface_field
        mspec, pspec = fspec.field.mlp, fspec.position_encoding
        grid_mlp = self.surface_field.field.grid_mlp
        ws, bs = grid_mlp.mlp_head.effective_weights()
        return (grid_mlp.feature_grid.encoding.table, ws, bs, fspec.field.grid.encoding), dict(
            radius=fspec.field.grid.radius, num_frequencies=pspec.num_frequencies,
            min_freq_exp=pspec.min_freq_exp, max_freq_exp=pspec.max_freq_exp,
            skip=mspec.skip_connections, activation=mspec.activation,
            beta=mspec.activation_beta,
        )

    def _level_mask(self, active_level, num_levels: int):
        return self.surface_field.field.grid_mlp.feature_grid.level_mask(active_level, num_levels)

    def sdf_geo(self, positions: torch.Tensor, active_level, max_level: Optional[int] = None):
        """(sdf [...], geo [..., G]) at positions [..., 3] through the SDF
        field, after the surface contraction (model.py:300-315)."""
        flat = positions.reshape(-1, 3)
        if self.spec.surface.contraction_order is not None:
            flat = scene_contraction(flat, self.spec.surface.contraction_order)
        sdf, geo = self.surface_field(flat, active_level, max_level)
        return sdf.reshape(positions.shape[:-1]), geo.reshape(*positions.shape[:-1], -1)

    def sdf_only(self, positions: torch.Tensor, active_level, max_level: Optional[int] = None):
        """SDF values [...] at positions [..., 3]: through K2 where
        _slot_value_ok, else through the SDF field (model.py:317-322)."""
        if not self._slot_value_ok():
            return self.sdf_geo(positions, active_level, max_level)[0]
        enc = self.spec.surface.surface_field.field.grid.encoding
        k = enc.num_levels if max_level is None else min(int(max_level), enc.num_levels)
        args, kw = self._slot_kwargs()
        sdf = fused_slot_sdf_value(
            positions.reshape(-1, 3), *args, **kw,
            level_mask=self._level_mask(active_level, k), num_levels=k,
        )
        return sdf.reshape(positions.shape[:-1])

    def _fused_sdf_gradients(self, positions: torch.Tensor):
        """The grid-less fused surface (model.py:432-503): through K4 (or
        K4j) with geo bf16, or the generic route with geo f32; (sdf, geo, d
        sdf/dx, None)."""
        spec = self.spec.surface
        fspec = spec.surface_field
        mspec, pspec = fspec.field.mlp, fspec.position_encoding
        ws, bs = self.surface_field.field.mlp.effective_weights()
        if (spec.contraction_order is not None or not fspec.use_position_encoding
                or not pspec.include_input):
            return self._tangent_sdf_gradients(positions, ws, bs)
        sdf, geo, grad = fused_sdf_chain(
            positions.reshape(-1, 3), ws, bs, num_frequencies=pspec.num_frequencies,
            min_freq_exp=pspec.min_freq_exp, max_freq_exp=pspec.max_freq_exp,
            skip=mspec.skip_connections, activation=mspec.activation, beta=mspec.activation_beta,
        )
        lead = positions.shape[:-1]
        # geo stays bf16 into the radiance trunk (model.py:471-474)
        return sdf.reshape(lead), geo.reshape(*lead, -1), grad.reshape(positions.shape), None

    def _jacfwd_sdf_gradients(self, positions: torch.Tensor, active_level, hessian: bool):
        """Autograd SDF gradients (model.py:505-533): value, geo and d sdf/dx
        of each sample from one field pass with 3 forward tangents,
        vmap(jacfwd(f, has_aux=True)); with `hessian`, the nested jacfwd and
        the hessian's rows summed (H @ 1, the reference's autograd hessian).
        Parameter gradients flow back through the tangents (the eikonal
        loss's second-order term). Returns (sdf, geo, grad, hessians or
        None)."""
        def f_single(p):  # [3] -> (sdf, (sdf, geo))
            s, g = self.sdf_geo(p[None, :], active_level)
            return s[0], (s[0], g[0])

        flat = positions.reshape(-1, 3)
        lead = positions.shape[:-1]
        hessians = None
        if hessian:
            def f_grad(p):
                jac, aux = torch.func.jacfwd(f_single, has_aux=True)(p)
                return jac, (jac, aux)

            hess, (grads, (sdf, geo)) = torch.func.vmap(
                torch.func.jacfwd(f_grad, has_aux=True))(flat)
            hessians = hess.sum(-1).reshape(*lead, 3)
        else:
            grads, (sdf, geo) = torch.func.vmap(torch.func.jacfwd(f_single, has_aux=True))(flat)
        return sdf.reshape(lead), geo.reshape(*lead, -1), grads.reshape(positions.shape), hessians

    def _numerical_sdf_gradients(self, positions: torch.Tensor, schedules: ScheduleState,
                                 train: bool):
        """Numerical SDF gradients (model.py:535-545, 672-722): the
        tetrahedron's 4 taps or the 6 axis taps at distance `delta`, each an
        SDF query; in training with compute_hessian, the hessian diagonal
        from the same taps."""
        spec = self.spec.surface
        lvl, delta = schedules.active_level, schedules.numerical_delta
        sdf, geo = self.sdf_geo(positions, lvl)
        hessian = train and spec.compute_hessian
        hessians = None
        if spec.numerical_gradient_taps == 4:
            d = delta / math.sqrt(3.0)
            k = torch.tensor(TETRAHEDRON, dtype=positions.dtype, device=positions.device)
            tap_sdf = self.sdf_only(positions[..., None, :] + k * d, lvl)  # [..., 4]
            gradients = (k * tap_sdf[..., None]).sum(-2) / (4.0 * d)
            if hessian:
                hxx = (tap_sdf.sum(-1) / 2.0 - 2.0 * sdf) / delta**2
                hessians = torch.stack([hxx, hxx, hxx], dim=-1) / 3.0
        elif spec.numerical_gradient_taps == 6:
            eye = torch.eye(3, dtype=positions.dtype, device=positions.device)
            offs = torch.cat([eye, -eye])  # [6, 3]
            tap_sdf = self.sdf_only(positions[..., None, :] + offs * delta, lvl)  # [..., 6]
            plus, minus = tap_sdf[..., :3], tap_sdf[..., 3:]
            gradients = 0.5 * (plus - minus) / delta
            if hessian:
                hessians = (plus + minus - 2.0 * sdf[..., None]) / delta**2
        else:
            raise ValueError("numerical_gradient_taps must be 4 or 6")
        return sdf, geo, gradients, hessians

    def _tangent_sdf_gradients(self, positions: torch.Tensor, ws, bs):
        """The generic route (model.py:477-503): enc(p) = PE(contract(p))
        (each part as the spec has it) and its jvp along e_0, e_1, e_2
        outside the kernels; K1t with those tangents gives y and d sdf/dx
        from the sdf channel's tangents. Gradients reach the positions
        through the chain input and through the tangents (the eikonal
        loss's second-order term). Returns (sdf, geo f32, grad, None)."""
        spec = self.spec.surface
        fspec = spec.surface_field
        mspec, pspec = fspec.field.mlp, fspec.position_encoding

        def enc(p):
            if spec.contraction_order is not None:
                p = scene_contraction(p, spec.contraction_order)
            return pspec.apply(p) if fspec.use_position_encoding else p

        flat = positions.reshape(-1, 3)
        eye = torch.eye(3, dtype=flat.dtype, device=flat.device)
        tangs = []
        for k in range(3):
            primal, t = torch.func.jvp(enc, (flat,), (eye[k].expand_as(flat),))
            tangs.append(t)
        y, grad = fused_chain(primal, ws, bs, skip=mspec.skip_connections,
                              activation=mspec.activation, beta=mspec.activation_beta,
                              tangents=torch.stack(tangs), tangent_out_channel=0)
        y = y.float()
        lead = positions.shape[:-1]
        return y[:, 0].reshape(lead), y[:, 1:].reshape(*lead, -1), grad.reshape(positions.shape), None

    def _slot_composition(self, flat: torch.Tensor, active_level):
        """The two-kernel composition (model.py:612-652) for a slot surface
        without an input-including position encoding: K6 with its spatial
        tangents, the chain input [xyz, PE, grid] with its tangents, K5 for
        (y, adj = d sdf / d input), and d sdf/dx = <adj, tangents> outside
        the kernels. Returns (sdf, geo f32, grad [N, 3])."""
        fspec = self.spec.surface.surface_field
        mspec, pspec = fspec.field.mlp, fspec.position_encoding
        grid_mlp = self.surface_field.field.grid_mlp
        enc_g, tenc_g = grid_mlp.feature_grid(flat, active_level, with_tangents=True)
        n = flat.shape[0]
        eye = torch.eye(3, dtype=flat.dtype, device=flat.device)
        parts, tparts = [flat], [eye[:, None, :].expand(3, n, 3)]
        if fspec.use_position_encoding:
            # without the input: with it the fused K3 route runs
            tangs = []
            for k in range(3):
                primal_pe, t = torch.func.jvp(pspec.apply, (flat,), (eye[k].expand_as(flat),))
                tangs.append(t)
            parts.append(primal_pe)
            tparts.append(torch.stack(tangs))
        parts.append(enc_g)
        tparts.append(tenc_g)
        ws, bs = grid_mlp.mlp_head.effective_weights()
        y, adj = fused_chain_adjoint(torch.cat(parts, -1), ws, bs, skip=mspec.skip_connections,
                                     activation=mspec.activation, beta=mspec.activation_beta,
                                     channel=0)
        grad = (adj[None] * torch.cat(tparts, -1).float()).sum(-1)  # [3, N]
        y = y.float()
        return y[:, 0], y[:, 1:], grad.T

    def sdf_gradients(self, positions: torch.Tensor, schedules: ScheduleState, train: bool = False):
        """(sdf [...], geo [..., G], d sdf/dx [..., 3], hessians), by the
        reference's dispatch (model.py:402-545). Numerical taps when the
        surface asks for them. Else, on a fused slot surface
        (model.py:547-669): through K3 (geo bf16) with an input-including
        position encoding, else through the K6 + K5 composition (geo f32);
        on a grid-less fused surface, outside training with a hessian,
        through K4 or K4j (geo bf16), or with a contraction or without an
        input-including encoding through K1t (geo f32); on any other surface
        (an unfused MLP, a hash grid) through vmap(jacfwd). On a slot
        surface in training with compute_hessian, hessians [..., S_tap, 3]
        come from the curvature taps through sdf_only."""
        spec = self.spec.surface
        if spec.use_numerical_gradients:
            return self._numerical_sdf_gradients(positions, schedules, train)
        grid = spec.surface_field.field.grid
        if grid is None or not isinstance(grid.encoding, SlotGridSpec):
            mspec = spec.surface_field.field.mlp
            if (grid is None and can_fuse(mspec) and mspec.out_activation in (None, "None")
                    and not (train and spec.compute_hessian)):
                return self._fused_sdf_gradients(positions)
            return self._jacfwd_sdf_gradients(positions, schedules.active_level,
                                              train and spec.compute_hessian)
        if not self._fused_slot():
            raise ValueError(
                "slot-grid analytic SDF gradients need fused MLPs "
                "(set mlp.fused=True, dtype=bfloat16) or numerical taps")
        flat = positions.reshape(-1, 3)
        if self._slot_value_ok():
            args, kw = self._slot_kwargs()
            sdf, geo, grad = fused_slot_sdf_chain(
                flat, *args, **kw,
                level_mask=self._level_mask(schedules.active_level, grid.encoding.num_levels),
            )
        else:
            sdf, geo, grad = self._slot_composition(flat, schedules.active_level)
        lead = positions.shape[:-1]
        sdf, geo, grad = sdf.reshape(lead), geo.reshape(*lead, -1), grad.reshape(positions.shape)
        hessians = None
        if train and spec.compute_hessian:
            tap_pos, tap_sdf = positions, sdf
            if spec.curvature_tap_stride > 1 and positions.dim() >= 3:
                tap_pos = positions[..., :: spec.curvature_tap_stride, :]
                tap_sdf = sdf[..., :: spec.curvature_tap_stride]
            hessians = curvature_hessian_taps(
                lambda q: self.sdf_only(q, schedules.active_level), tap_pos, tap_sdf,
                schedules.numerical_delta, spec.curvature_taps,
            )
        return sdf, geo, grad, hessians

    def inv_s(self) -> torch.Tensor:
        return self.variance()[0]

    def beta(self) -> torch.Tensor:
        """VolSDF Laplace beta: |s| + beta_min (model.py:388-390)."""
        return self.variance.s[0].abs() + self.spec.surface.beta_min

    def random_background_color(self, mod: str, like: torch.Tensor,
                                generator: torch.Generator) -> torch.Tensor:
        """The escape colour of background_color="random": one uniform
        value per ray and channel (model.py:850-851)."""
        return torch.rand(like.shape, generator=generator, dtype=like.dtype, device=like.device)

    # --------------------------------------------------------------- forward
    def forward(
        self,
        rays: RayBundle,
        segments: Tuple[Tuple[str, int], ...],
        schedules: ScheduleState,
        train: bool = False,
        aligned: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Render a flat ray batch. `segments` is the static (modality,
        num_rays) split of the batch; with `aligned` every head renders
        every ray. Returns per-modality radiance, normals, depth,
        accumulation and the hit mask, and in training also gradients,
        hessians and inv_s (model.py:829-832). Eval runs under no_grad;
        training draws the samplers' jitter from `generator` (none: no
        jitter). A random background colour is drawn from `generator` in
        training, and in eval (or without one) from a generator seeded 0
        on the model's device, as the reference's key(0)
        (model.py:815-816)."""
        if not train:
            with torch.no_grad():
                return self._render(rays, segments, schedules, False, aligned, None)
        return self._render(rays, segments, schedules, True, aligned, generator)

    def _render(self, rays, segments, schedules, train, aligned, generator):
        spec = self.spec
        if spec.collider_type == "near_far":
            collided, mask = near_far_collide(rays, *spec.near_far)
        elif spec.collider_type == "box":
            collided, mask = box_collide(rays, spec.aabb)
        else:
            collided, mask = sphere_collide(rays, spec.scene_radius)
        samples = neus_sampling(
            collided,
            lambda pos: self.sdf_only(pos, schedules.active_level, spec.surface.sampler_levels),
            spec.ray_sampler, generator, train,
        )

        def region(fn, *args):
            # remat (model.py:773, 780, 801): in training the region's
            # activations are recomputed in the backward; no region draws
            # from a generator, so the recompute sees the same numbers
            if spec.remat and train:
                return checkpoint(fn, *args, use_reentrant=False)
            return fn(*args)

        background = None
        if spec.use_background:
            bg_rays = background_bounds(rays, mask, spec.scene_radius)
            bg_samples = spaced_sampling(bg_rays, spec.background_ray_sampler,
                                         generator=generator, train=train)
            background = region(self._background_forward, bg_samples, segments, aligned)

        sdf, geo, gradients, hessians = region(self.sdf_gradients, samples.start_positions(),
                                               schedules, train)
        norm = torch.linalg.vector_norm(gradients, dim=-1, keepdim=True)
        normals = gradients / norm.clamp_min(1e-12)
        if spec.surface.rendering == "volsdf":  # model.py:785-791
            inv_s = self.beta()  # reported as 1 / beta
            density = laplace_density(sdf, inv_s, spec.surface.beta_min)
            weights = weights_from_densities(samples.deltas, density)
        else:
            inv_s = self.inv_s()
            weights = neus_weights(samples, sdf, gradients, inv_s, schedules.cos_anneal_ratio)
        radiance = region(self._radiance_forward, samples, normals, geo, segments, aligned)

        outputs: Dict[str, torch.Tensor] = {}
        acc = weights.sum(-1, keepdim=True)
        m = mask[:, None]
        if spec.background_color == "random" and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        for mod, seg in self._iter_segments(segments, aligned):
            w, a, mm = weights[seg], acc[seg], m[seg]
            comp = (w[..., None] * radiance[mod]).sum(-2)
            bg = self._background_color(mod, background, comp, generator)
            outputs[mod] = mm * (comp + bg * (1.0 - a)) + (1.0 - mm) * bg
        steps = (samples.starts + samples.ends) * 0.5
        depth = (weights * steps).sum(-1, keepdim=True).clamp(steps.min(), steps.max())
        outputs["normals"] = m * (weights[..., None] * normals).sum(-2)
        outputs["depth"] = m * depth
        outputs["accumulation"] = m * acc
        outputs["mask"] = mask
        if train:
            outputs["gradients"] = gradients
            outputs["hessians"] = hessians
            outputs["inv_s"] = 1.0 / inv_s
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

    def _background_color(self, mod, background, like, generator):
        """Escape radiance per ray (model.py:846-855): random before black,
        so a random colour applies with or without a background field."""
        bgc = self.spec.background_color
        if bgc == "white":
            return torch.ones_like(like)
        if bgc == "random":
            return self.random_background_color(mod, like, generator)
        if bgc == "black" or background is None:
            return torch.zeros_like(like)
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
        nrm = normals.reshape(-1, 3).detach()  # stop_gradient (model.py:866)
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
