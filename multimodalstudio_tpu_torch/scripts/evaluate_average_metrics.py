"""The paper's metrics of exported renders: PSNR, SSIM and LPIPS of each
modality over the eval views, under the accumulation mask, in three
regimes (JAX reference: scripts/evaluate_average_metrics.py, with the same
command line and JSON):

  raw training (single-channel mosaicked ground truth):
    - mosaicked:             the rendering mosaicked vs the raw frame
    - demosaicked:           demosaick(mosaicked rendering) vs demosaick(frame)
    - rendered_demosaicked:  the full-channel rendering vs demosaick(frame)
  demosaicked training (full-channel ground truth):
    - rendered_demosaicked:  the rendering vs the frame
    - mosaicked:             both mosaicked through the pattern
    - demosaicked:           both mosaicked, then demosaicked

Frames and accumulation PNGs are read by the port's own PNG reader
(utils/images.py::read_png, as OpenCV's IMREAD_UNCHANGED), demosaicked by
preprocessing/demosaick.py, SSIM is ops/math.py::masked_ssim and LPIPS
utils/lpips.py (its weight source is reported). `{vi:04d}` in a render's
file name is the position of the view in --views, as in the reference.
Runs on the card unless --device cpu is given:

    python -m multimodalstudio_tpu_torch.scripts.evaluate_average_metrics \\
        --renders <run>/renders/step-XXXXXXXXX --scene <scene dir> \\
        --modalities rgb mono --views 9 19 29 39 49 [--out metrics.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REGIMES = ("mosaicked", "demosaicked", "rendered_demosaicked")


def masked_psnr(pred, gt, mask):
    err = ((pred - gt) ** 2) * mask
    mse = err.sum() / max(mask.sum() * pred.shape[-1], 1.0)
    return -10.0 * np.log10(max(mse, 1e-12))


def masked_ssim(pred, gt, mask, device):
    """The SSIM map over the full images, averaged over the mask."""
    from multimodalstudio_tpu_torch.ops.math import masked_ssim as _masked_ssim

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return float(_masked_ssim(t(pred), t(gt), t(mask)))


def try_lpips(pred, gt, mask, device):
    """LPIPS of the mask-zeroed images in [-1, 1]; one channel repeated to
    three, more than three scored by their mean repeated; None below the
    32-pixel side AlexNet's five stages need."""
    from multimodalstudio_tpu_torch.utils.lpips import lpips

    def to_img(x):
        x = x * mask
        if x.shape[-1] == 1:
            x = np.repeat(x, 3, -1)
        elif x.shape[-1] > 3:
            x = np.repeat(x.mean(-1, keepdims=True), 3, -1)
        return x[..., :3] * 2.0 - 1.0

    if min(pred.shape[0], pred.shape[1]) < 32:
        return None
    return float(lpips(to_img(pred), to_img(gt), device=device)[0])


def regime_metrics(pred, gt, mask, rows, regime, device):
    rows[f"psnr_{regime}"].append(masked_psnr(pred, gt, mask))
    rows[f"ssim_{regime}"].append(masked_ssim(pred, gt, mask, device))
    lp = try_lpips(pred, gt, mask, device)
    if lp is not None:
        rows[f"lpips_{regime}"].append(lp)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--renders", required=True, help="renders/step-* dir")
    parser.add_argument("--scene", required=True, help="scene data dir")
    parser.add_argument("--modalities", nargs="+", default=["rgb"])
    parser.add_argument("--views", type=int, nargs="+", default=[9, 19, 29, 39, 49])
    parser.add_argument("--mask_threshold", type=float, default=0.9)
    parser.add_argument("--rendering_scale", type=float, default=0.25)
    parser.add_argument("--out", default=None, help="optional JSON output path")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from multimodalstudio_tpu_torch.data.dataset import build_mosaick_mask, normalize_frame
    from multimodalstudio_tpu_torch.device import resolve_device
    from multimodalstudio_tpu_torch.preprocessing.demosaick import demosaick_for_modality
    from multimodalstudio_tpu_torch.utils.images import read_png
    from multimodalstudio_tpu_torch.utils.lpips import weight_source

    device = resolve_device(args.device)
    with open(os.path.join(args.scene, "meta_data.json")) as f:
        meta = json.load(f)
    raw = meta.get("raw", False)

    results = {}
    for mod in args.modalities:
        mmeta = meta["modalities"][mod]
        frames_by_id = {fr["frame_id"]: fr["file_name"] for fr in mmeta["frames"]}
        pattern = np.asarray(mmeta.get("mosaick_pattern", [[0]]))
        multi_channel_pattern = int(pattern.max()) > 0
        rows = {f"{m}_{r}": [] for r in REGIMES for m in ("psnr", "ssim", "lpips")}

        def score(pred, gt, mask, regime):
            regime_metrics(pred, gt, mask, rows, regime, device)

        for vi, view in enumerate(args.views):
            render_path = os.path.join(args.renders, mod, f"{vi:04d}_render.npy")
            acc_path = os.path.join(args.renders, mod, f"{vi:04d}_accumulation.png")
            if not os.path.exists(render_path):
                continue
            pred = np.load(render_path)
            gt_full = normalize_frame(read_png(
                os.path.join(args.scene, "modalities", mod, frames_by_id[view])))
            if gt_full.ndim == 2:
                gt_full = gt_full[..., None]
            h, w = pred.shape[:2]
            inv = 1.0 / args.rendering_scale
            ys = (np.arange(h) * inv).astype(np.int64)
            xs = (np.arange(w) * inv).astype(np.int64)
            gt = gt_full[ys][:, xs]

            if os.path.exists(acc_path):
                acc = read_png(acc_path).astype(np.float32) / 65535.0
                mask = (acc > args.mask_threshold).astype(np.float32)[..., None]
            else:
                mask = np.ones((h, w, 1), np.float32)

            # the mosaick mask subsampled to the rendering scale
            mos = build_mosaick_mask(pattern, mmeta["height"], mmeta["width"])
            sub = mos[ys][:, xs].astype(np.int64)

            if raw and gt.shape[-1] == 1 and pred.shape[-1] > 1:
                pred_mos = np.take_along_axis(pred, sub[..., None], axis=-1)
                score(pred_mos, gt, mask, "mosaicked")
                if multi_channel_pattern and args.rendering_scale == 1.0:
                    # demosaicking needs the mosaick's whole period: full-resolution renders only
                    gt_dem = demosaick_for_modality(gt, pattern, mod)
                    pred_dem = demosaick_for_modality(pred_mos, pattern, mod)
                    score(pred_dem, gt_dem, mask, "demosaicked")
                    score(pred, gt_dem, mask, "rendered_demosaicked")
                else:
                    # a single-channel mosaick: demosaicking is the identity
                    score(pred_mos, gt, mask, "demosaicked")
                    score(pred, gt, mask, "rendered_demosaicked")
            else:
                if pred.shape[-1] != gt.shape[-1]:
                    pred = pred[..., : gt.shape[-1]]
                score(pred, gt, mask, "rendered_demosaicked")
                if multi_channel_pattern:
                    gt_mos = np.take_along_axis(gt, sub[..., None], axis=-1)
                    pred_mos = np.take_along_axis(pred, sub[..., None], axis=-1)
                    score(pred_mos, gt_mos, mask, "mosaicked")
                    if args.rendering_scale == 1.0:
                        score(demosaick_for_modality(pred_mos, pattern, mod),
                              demosaick_for_modality(gt_mos, pattern, mod), mask, "demosaicked")
                else:
                    score(pred, gt, mask, "mosaicked")
                    score(pred, gt, mask, "demosaicked")

        results[mod] = {k: float(np.mean(v)) for k, v in rows.items() if v}
        # headline aliases: the regime of the training data
        if raw and "psnr_mosaicked" in results[mod]:
            results[mod]["psnr"] = results[mod]["psnr_mosaicked"]
            results[mod]["ssim"] = results[mod]["ssim_mosaicked"]
        elif "psnr_rendered_demosaicked" in results[mod]:
            results[mod]["psnr"] = results[mod]["psnr_rendered_demosaicked"]
            results[mod]["ssim"] = results[mod]["ssim_rendered_demosaicked"]

    if any("lpips" in k for r in results.values() for k in r):
        results["lpips_weights"] = weight_source()
        if weight_source() == "randinit":
            print("note: LPIPS scored with the deterministic rand-init fallback (no vendored "
                  "weights; see scripts/vendor_lpips_weights.py): comparable within this table, "
                  "not with trained-LPIPS values", file=sys.stderr)
    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
