"""Evaluator: chunked full-view rendering, metrics, and image, metric,
mesh and pose exports (JAX reference: engine/evaluator.py).

A view renders as fixed-size chunks of rays (the tail chunk padded with
copies of the first ray), every modality head along the view's rays
(aligned rendering), stitched on the host. Metrics are ROI-masked PSNR and
SSIM. The raw evaluator adds the mosaicked rendering of every modality on
this modality's frame grid and, at rendering_scale 1, the demosaicked and
rendered-demosaicked scoring regimes. With an output directory, renders
go to 16-bit PNGs (utils/images.py), scores to a newest-first results.txt,
the surface to meshes/step-*.ply and the camera centres to
poses/step-*.ply.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from multimodalstudio_tpu_torch.cameras.camera_optimizer import camera_opt_transform
from multimodalstudio_tpu_torch.cameras.cameras import generate_rays
from multimodalstudio_tpu_torch.configs.config import TrainerConfig
from multimodalstudio_tpu_torch.data.dataset import MMSDataset
from multimodalstudio_tpu_torch.data.sampler import PixelBatch, dense_pixel_batch
from multimodalstudio_tpu_torch.device import resolve_device, set_reference_precision
from multimodalstudio_tpu_torch.engine.train import TrainState, make_schedules
from multimodalstudio_tpu_torch.engine.mesh import extract_mesh
from multimodalstudio_tpu_torch.models.model import MMSModel
from multimodalstudio_tpu_torch.ops import polarization as pol
from multimodalstudio_tpu_torch.ops.lie_groups import pose_multiply
from multimodalstudio_tpu_torch.ops.math import masked_ssim
from multimodalstudio_tpu_torch.preprocessing.demosaick import demosaick_grid
from multimodalstudio_tpu_torch.utils.images import to16, viridis, write_png16
from multimodalstudio_tpu_torch.utils.meshio import write_ply_mesh, write_ply_points

# camera-centre colours of the pose export (evaluator.py:360-366)
POSE_COLORS = {"rgb": (0, 255, 0), "infrared": (255, 0, 0), "multispectral": (0, 0, 255),
               "mono": (0, 0, 0), "polarization": (255, 0, 255)}


def _psnr(p: torch.Tensor, g: torch.Tensor, m: Optional[torch.Tensor]) -> float:
    """PSNR over the ROI normalised by its pixel count, or over everything."""
    if m is None:
        mse = ((p - g) ** 2).mean()
    else:
        mse = (((p - g) ** 2) * m).sum() / (m.sum() * p.shape[-1]).clamp_min(1.0)
    return float(-10.0 * torch.log10(mse.clamp_min(1e-12)))


class Evaluator:
    """Renders eval views, computes metrics and, given `output_dir`, writes
    the exports. `device` is where metrics run; it defaults to the card and
    raises without one."""

    def __init__(self, config: TrainerConfig, model: MMSModel, train_dataset: MMSDataset,
                 eval_dataset: MMSDataset, output_dir: Optional[str] = None, device="cuda"):
        self.device = resolve_device(device)
        set_reference_precision()
        self.config = config
        self.model = model
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.output_dir = output_dir

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
    def _roi(self, frames) -> Optional[torch.Tensor]:
        """[H, W, 1] ROI mask (accumulation > threshold), or None without roi_only."""
        if not self.config.evaluator.roi_only:
            return None
        threshold = self.config.evaluator.accumulation_mask_threshold
        return torch.as_tensor(
            (frames["accumulation"][..., 0] > threshold).astype(np.float32)[..., None],
            device=self.device,
        )

    def view_metrics(self, frames: Dict[str, np.ndarray], mod: str) -> Dict[str, float]:
        """PSNR over the ROI (accumulation > threshold) normalised by its
        pixel count, and SSIM over the full images averaged over the ROI."""
        pred, gt = frames[mod], frames["gt"]
        if self.config.datamanager.raw and gt.shape[-1] == 1 and pred.shape[-1] > 1:
            chan = frames["mosaick_channel"][..., None].astype(np.int64)
            pred = np.take_along_axis(pred, chan, axis=-1)
        p = torch.as_tensor(pred, device=self.device)
        g = torch.as_tensor(gt, device=self.device)
        m = self._roi(frames)
        return {"psnr": _psnr(p, g, m), "ssim": float(masked_ssim(p, g, m))}

    def render_all_eval_views(self, state: TrainState) -> Dict[str, Dict[str, float]]:
        """Render and score the eval views of every modality; per-modality
        means (evaluator.py:159-186). MMS_EVAL_MAX_VIEWS = K > 0, read at
        call time, scores only the first K views of each modality (unset or
        0: every view), as the JAX evaluator does. With an output directory
        every view is exported and the means go to results.txt."""
        max_views = int(os.environ.get("MMS_EVAL_MAX_VIEWS", "0"))
        results: Dict[str, Dict[str, float]] = {}
        for mod in self.eval_dataset.modalities:
            n_frames = self.eval_dataset.num_frames(mod)
            if max_views > 0:
                n_frames = min(n_frames, max_views)
            vals = []
            for fi in range(n_frames):
                frames = self.render_view(state, self.eval_dataset, mod, fi)
                vals.append(self.view_metrics(frames, mod))
                if self.output_dir is not None:
                    self.export_view(frames, mod, fi, int(state.step))
            results[mod] = {k: float(np.mean([v[k] for v in vals])) for k in vals[0]} if vals else {}
        if self.output_dir is not None:
            self.export_metrics(results, int(state.step))
        return results

    def render_single_view(self, state: TrainState, mod: str, frame_index: int,
                           split: str = "eval") -> Dict[str, np.ndarray]:
        ds = self.eval_dataset if split == "eval" else self.train_dataset
        return self.render_view(state, ds, mod, frame_index)

    def render_specific_views(self, state: TrainState, view_ids) -> Dict[str, Dict[int, dict]]:
        """Render the given view ids of every modality from whichever split
        holds them (evaluator.py:215-238): an id in both splits is rendered
        and exported from each, and the eval split's frames are returned."""
        out: Dict[str, Dict[int, dict]] = {}
        for mod in self.train_dataset.modalities:
            out[mod] = {}
            for vid in sorted(view_ids):
                for ds in (self.eval_dataset, self.train_dataset):
                    ids = list(ds.data[mod].frame_ids) if mod in ds.data else []
                    if vid in ids:
                        frames = self.render_view(state, ds, mod, ids.index(vid))
                        out[mod].setdefault(vid, frames)
                        if self.output_dir is not None:
                            self.export_view(frames, mod, vid, int(state.step))
        return out

    # -------------------------------------------------------------- exports
    def export_view(self, frames: Dict[str, np.ndarray], mod: str, frame_index: int, step: int):
        """A 16-bit [render | GT | |diff|] sheet, the render as .npy, and
        the normal, depth, accumulation, DoP and AoP images
        (evaluator.py:240-296)."""
        out_dir = os.path.join(self.output_dir, "renders", f"step-{step:09d}", mod)
        os.makedirs(out_dir, exist_ok=True)
        pred, gt = frames[mod], frames["gt"]
        if gt.shape[-1] != pred.shape[-1]:
            chan = frames["mosaick_channel"][..., None].astype(np.int64)
            pred_cmp = np.take_along_axis(pred, chan, axis=-1)
        else:
            pred_cmp = pred
        sheet = np.concatenate([pred_cmp, gt, np.abs(pred_cmp - gt)], axis=1)
        if sheet.shape[-1] not in (1, 3):
            sheet = sheet.mean(axis=-1, keepdims=True)
        write_png16(os.path.join(out_dir, f"{frame_index:04d}_sheet.png"), to16(sheet))
        np.save(os.path.join(out_dir, f"{frame_index:04d}_render.npy"), pred)
        for extra in ("normals", "depth", "accumulation", "dop", "aop"):
            if extra not in frames:
                continue
            img = frames[extra]
            if extra == "normals":
                # world-frame normals into the camera frame (evaluator.py:265-270)
                if "c2w" in frames:
                    img = img @ np.linalg.inv(frames["c2w"][:3, :3]).T
                img = (img + 1.0) / 2.0
            elif extra == "depth":
                # viridis over rendered (depth != 0) pixels, 0.5 grey elsewhere
                d = img[..., 0]
                mask = d != 0
                img = np.full((*d.shape, 3), 0.5, dtype=np.float32)
                if mask.any():
                    lo, hi = d[mask].min(), d[mask].max()
                    img[mask] = viridis((d[mask] - lo) / max(hi - lo, 1e-8))
            write_png16(os.path.join(out_dir, f"{frame_index:04d}_{extra}.png"), to16(img))

    def export_metrics(self, results: Dict[str, Dict[str, float]], step: int):
        """Prepend this step's block to results.txt (evaluator.py:298-312)."""
        path = os.path.join(self.output_dir, "results.txt")
        lines = [f"step {step} @ {time.strftime('%Y-%m-%d %H:%M:%S')}"]
        for mod, vals in results.items():
            lines.append(f"  {mod}: " + "  ".join(f"{k}={v:.4f}" for k, v in vals.items()))
        old = ""
        if os.path.exists(path):
            with open(path) as f:
                old = f.read()
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n\n" + old)

    @torch.no_grad()
    def export_mesh(self, state: TrainState, step: int) -> Optional[str]:
        """The SDF's zero set by marching tetrahedra over the scene cube at
        mesh_resolution, the SDF through MMSModel.sdf_only (K2 or K2f on a
        slot grid), to meshes/step-*.ply (evaluator.py:314-344)."""
        if self.output_dir is None:
            return None
        out = os.path.join(self.output_dir, "meshes")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"step-{step:09d}.ply")
        active = make_schedules(self.config, state.step).active_level
        radius = self.config.model.scene_radius
        dev = self.model.device

        def sdf_fn(pts):
            return self.model.sdf_only(torch.as_tensor(pts, device=dev), active).float().cpu().numpy()

        verts, faces = extract_mesh(sdf_fn, resolution=self.config.evaluator.mesh_resolution,
                                    bounds=(-radius, radius),
                                    threshold=self.config.evaluator.marching_cube_threshold)
        if self.config.evaluator.gt_scale and verts.size:
            w2gt = self.train_dataset.worldtogt
            verts = verts @ w2gt[:3, :3].T + w2gt[:3, 3]
        write_ply_mesh(path, verts, faces)
        return path

    @torch.no_grad()
    def export_poses(self, state: TrainState, step: int) -> Optional[str]:
        """Pose-corrected camera centres of every modality as a coloured PLY
        point cloud, to poses/step-*.ply (evaluator.py:346-388)."""
        if self.output_dir is None:
            return None
        pts, cols = [], []
        for mod in self.train_dataset.modalities:
            cams = self.train_dataset.data[mod].cameras
            n = cams.num_cameras
            opt = camera_opt_transform(self.config.datamanager.camera_optimizer,
                                       state.camera_poses, mod, torch.arange(n, device=cams.device))
            c2w = cams.camera_to_worlds
            if opt is not None:
                c2w = pose_multiply(c2w, opt)
            centers = c2w[..., :3, 3].cpu().numpy()
            if self.config.evaluator.gt_scale:
                w2gt = self.train_dataset.worldtogt
                centers = centers @ w2gt[:3, :3].T + w2gt[:3, 3]
            pts.append(centers)
            cols.append(np.tile(POSE_COLORS.get(mod, (128, 128, 128)), (n, 1)))
        out = os.path.join(self.output_dir, "poses")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"step-{step:09d}.ply")
        write_ply_points(path, np.concatenate(pts), np.concatenate(cols).astype(np.uint8))
        return path


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
        """Three scoring regimes (evaluator.py:418-485): mosaicked (the
        inherited scores, also under their own names), demosaicked (the
        mosaicked rendering and the raw GT both demosaicked by
        demosaick_grid) and rendered-demosaicked (the full-channel rendering
        against the demosaicked GT). The last two need rendering_scale 1,
        as subsampling breaks the mosaick's period; at any other scale they
        are skipped with a warning."""
        out = super().view_metrics(frames, mod)
        pred, gt = frames[mod], frames["gt"]
        pattern = self._pattern(mod)
        if not (self.config.datamanager.raw and gt.shape[-1] == 1 and pred.shape[-1] > 1
                and pattern is not None):
            return out
        out["psnr_mosaicked"] = out["psnr"]
        out["ssim_mosaicked"] = out["ssim"]
        if self.config.evaluator.rendering_scale != 1.0:
            warnings.warn(
                f"demosaicked-regime metrics skipped: rendering_scale="
                f"{self.config.evaluator.rendering_scale} (set "
                f"evaluator.rendering_scale=1.0 to score all 3 regimes)"
            )
            return out
        m = self._roi(frames)
        chan = frames["mosaick_channel"][..., None].astype(np.int64)
        gt_dem = torch.as_tensor(demosaick_grid(gt, pattern), device=self.device)
        pred_dem = torch.as_tensor(
            demosaick_grid(np.take_along_axis(pred, chan, axis=-1), pattern), device=self.device)
        for p, suffix in ((pred_dem, "demosaicked"),
                          (torch.as_tensor(pred, device=self.device), "rendered_demosaicked")):
            out[f"psnr_{suffix}"] = _psnr(p, gt_dem, m)
            out[f"ssim_{suffix}"] = float(masked_ssim(p, gt_dem, m))
        return out

    def export_view(self, frames, mod, frame_index, step):
        """Also the full-channel rendering under renders/.../demosaicked/:
        one PNG for 1 or 3 channels, one a channel otherwise
        (evaluator.py:486-512)."""
        super().export_view(frames, mod, frame_index, step)
        pred = frames[mod]
        if not (self.config.datamanager.raw and pred.shape[-1] != frames["gt"].shape[-1]):
            return
        out_dir = os.path.join(self.output_dir, "renders", f"step-{step:09d}", "demosaicked", mod)
        os.makedirs(out_dir, exist_ok=True)
        if pred.shape[-1] in (1, 3):
            write_png16(os.path.join(out_dir, f"{frame_index:04d}.png"), to16(pred))
        else:
            for c in range(pred.shape[-1]):
                write_png16(os.path.join(out_dir, f"{frame_index:04d}_ch{c}.png"),
                            to16(pred[..., c : c + 1]))
