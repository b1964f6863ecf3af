"""Evaluator: chunked full-view rendering and metrics
(JAX reference: engine/evaluator.py).

A view renders as fixed-size chunks of rays (the tail chunk padded with
copies of the first ray), every modality head along the view's rays
(aligned rendering), stitched on the host. Metrics are ROI-masked PSNR and
SSIM. The raw evaluator adds the mosaicked rendering of every modality on
this modality's frame grid. Disk exports and the demosaicked metric
regimes are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from multimodalstudio_tpu_torch.cameras.camera_optimizer import camera_opt_transform
from multimodalstudio_tpu_torch.cameras.cameras import generate_rays
from multimodalstudio_tpu_torch.configs.config import TrainerConfig
from multimodalstudio_tpu_torch.data.dataset import MMSDataset
from multimodalstudio_tpu_torch.data.sampler import PixelBatch, dense_pixel_batch
from multimodalstudio_tpu_torch.device import resolve_device, set_reference_precision
from multimodalstudio_tpu_torch.engine.train import TrainState, make_schedules
from multimodalstudio_tpu_torch.models.model import MMSModel
from multimodalstudio_tpu_torch.ops import polarization as pol
from multimodalstudio_tpu_torch.ops.math import masked_ssim


class Evaluator:
    """Renders eval views and computes metrics. `device` is where metrics
    run; it defaults to the card and raises without one."""

    def __init__(self, config: TrainerConfig, model: MMSModel, train_dataset: MMSDataset,
                 eval_dataset: MMSDataset, device="cuda"):
        self.device = resolve_device(device)
        set_reference_precision()
        self.config = config
        self.model = model
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset

    # --------------------------------------------------------------- render
    @torch.no_grad()
    def _render_chunk(self, state: TrainState, mod: str, cameras, camera_indices, pixel_coords):
        config = self.config
        opt = camera_opt_transform(config.datamanager.camera_optimizer, state.camera_poses, mod,
                                   camera_indices)
        rays = generate_rays(cameras, camera_indices, pixel_coords, opt)
        n = camera_indices.shape[0]
        return self.model.forward(
            rays, ((config.modalities[0], n),), make_schedules(config, state.step),
            train=False, aligned=True,
        )

    def render_rays(self, state: TrainState, mod: str, batch: PixelBatch, cameras) -> Dict[str, np.ndarray]:
        """Chunked rendering of a ray list; returns host arrays [N, ...]."""
        chunk = self.config.evaluator.eval_num_rays_per_chunk
        n = batch.camera_indices.shape[0]
        n_pad = (-n) % chunk
        idx = torch.cat([batch.camera_indices, batch.camera_indices[:1].repeat(n_pad)])
        coords = torch.cat([batch.pixel_coords, batch.pixel_coords[:1].repeat(n_pad, 1)])
        outs = []
        for i in range(0, n + n_pad, chunk):
            out = self._render_chunk(state, mod, cameras, idx[i : i + chunk], coords[i : i + chunk])
            outs.append({k: v.float().cpu().numpy() for k, v in out.items()})
        return {k: np.concatenate([o[k] for o in outs], axis=0)[:n] for k in outs[0]}

    def render_view(self, state: TrainState, dataset: MMSDataset, mod: str,
                    frame_index: int) -> Dict[str, np.ndarray]:
        """Render one full view at rendering_scale; per-key [H, W, C] frames."""
        scale = self.config.evaluator.rendering_scale
        d = dataset.data[mod]
        batch = dense_pixel_batch(dataset, mod, frame_index, scale)
        h, w = int(d.cameras.height * scale), int(d.cameras.width * scale)
        flat = self.render_rays(state, mod, batch, d.cameras)
        frames = {k: v.reshape(h, w, -1) for k, v in flat.items() if k != "mask"}
        frames["gt"] = batch.pixels.cpu().numpy().reshape(h, w, -1)
        frames["mosaick_channel"] = batch.mosaick_channel.cpu().numpy().reshape(h, w)
        if "polarization" in frames and frames["polarization"].shape[-1] == 4:
            p = torch.as_tensor(frames["polarization"])
            frames["dop"] = pol.to_dop(data=p).numpy()[..., None]
            frames["aop"] = (pol.to_aop(data=p) / np.pi).numpy()[..., None]
        frames["c2w"] = d.cameras.camera_to_worlds[frame_index].cpu().numpy()
        return frames

    # -------------------------------------------------------------- metrics
    def view_metrics(self, frames: Dict[str, np.ndarray], mod: str) -> Dict[str, float]:
        """PSNR over the ROI (accumulation > threshold) normalised by its
        pixel count, and SSIM over the full images averaged over the ROI."""
        pred, gt = frames[mod], frames["gt"]
        if self.config.datamanager.raw and gt.shape[-1] == 1 and pred.shape[-1] > 1:
            chan = frames["mosaick_channel"][..., None].astype(np.int64)
            pred = np.take_along_axis(pred, chan, axis=-1)
        p = torch.as_tensor(pred, device=self.device)
        g = torch.as_tensor(gt, device=self.device)
        if not self.config.evaluator.roi_only:
            mse = ((p - g) ** 2).mean()
            return {"psnr": float(-10.0 * torch.log10(mse.clamp_min(1e-12))),
                    "ssim": float(masked_ssim(p, g))}
        threshold = self.config.evaluator.accumulation_mask_threshold
        m = torch.as_tensor(
            (frames["accumulation"][..., 0] > threshold).astype(np.float32)[..., None],
            device=self.device,
        )
        mse = (((p - g) ** 2) * m).sum() / (m.sum() * p.shape[-1]).clamp_min(1.0)
        return {"psnr": float(-10.0 * torch.log10(mse.clamp_min(1e-12))),
                "ssim": float(masked_ssim(p, g, m))}

    def render_all_eval_views(self, state: TrainState) -> Dict[str, Dict[str, float]]:
        """Render and score every eval view of every modality; per-modality
        means."""
        results: Dict[str, Dict[str, float]] = {}
        for mod in self.eval_dataset.modalities:
            vals = [
                self.view_metrics(self.render_view(state, self.eval_dataset, mod, fi), mod)
                for fi in range(self.eval_dataset.num_frames(mod))
            ]
            results[mod] = {k: float(np.mean([v[k] for v in vals])) for k in vals[0]} if vals else {}
        return results


class RawEvaluator(Evaluator):
    """Raw (mosaicked) scenes: every modality's rendering is also mosaicked
    to this modality's frame grid, and the mosaicked scores are reported
    under their own names."""

    def render_view(self, state, dataset, mod, frame_index):
        frames = super().render_view(state, dataset, mod, frame_index)
        if dataset.raw and dataset.mosaick_masks_across is not None:
            inv = 1.0 / self.config.evaluator.rendering_scale
            for key in list(frames.keys()):
                if key in dataset.mosaick_masks_across.get(mod, {}):
                    h, w = frames[key].shape[:2]
                    ys = (np.arange(h) * inv).astype(np.int64)[:, None]
                    xs = (np.arange(w) * inv).astype(np.int64)[None, :]
                    sub = dataset.mosaick_masks_across[mod][key][ys, xs]
                    if frames[key].shape[-1] > 1:
                        frames[f"{key}_mosaicked"] = np.take_along_axis(
                            frames[key], sub[..., None].astype(np.int64), axis=-1
                        )
        return frames

    def _pattern(self, mod: str):
        for ds in (self.eval_dataset, self.train_dataset):
            if mod in ds.data and ds.data[mod].mosaick_pattern is not None:
                return ds.data[mod].mosaick_pattern
        return None

    def view_metrics(self, frames: Dict[str, np.ndarray], mod: str) -> Dict[str, float]:
        out = super().view_metrics(frames, mod)
        pred, gt = frames[mod], frames["gt"]
        if not (self.config.datamanager.raw and gt.shape[-1] == 1 and pred.shape[-1] > 1
                and self._pattern(mod) is not None):
            return out
        out["psnr_mosaicked"] = out["psnr"]
        out["ssim_mosaicked"] = out["ssim"]
        if self.config.evaluator.rendering_scale == 1.0:
            raise NotImplementedError("the demosaicked metric regimes are not ported yet")
        return out
