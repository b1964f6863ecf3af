"""Dense full-view pixel batches (JAX reference: data/sampler.py). Random
training batches come with the training slice."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multimodalstudio_tpu_torch.data.dataset import MMSDataset


@dataclasses.dataclass
class PixelBatch:
    """One modality's pixels, on the cameras' device."""

    camera_indices: torch.Tensor  # [N] int64 (index into the split's frames)
    pixel_coords: torch.Tensor  # [N, 2] float32 (y, x) + pixel_offset
    pixels: torch.Tensor  # [N, C] targets
    mosaick_channel: torch.Tensor  # [N] int32 (0 when not raw)


def dense_pixel_batch(dataset: MMSDataset, mod: str, frame_index: int, scale: float = 1.0) -> PixelBatch:
    """Every pixel of one view in row-major order; scale < 1 renders a
    subsampled grid of full-resolution pixel coordinates."""
    d = dataset.data[mod]
    dev = d.cameras.device
    h = int(d.cameras.height * scale)
    w = int(d.cameras.width * scale)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ys, xs = yy.reshape(-1), xx.reshape(-1)
    inv = 1.0 / scale
    coords = np.stack([ys * inv, xs * inv], axis=-1).astype(np.float32) + d.cameras.pixel_offset
    n = coords.shape[0]
    yi, xi = (ys * inv).astype(np.int64), (xs * inv).astype(np.int64)
    if scale == 1.0:
        pixels = d.images[frame_index].reshape(n, -1)
    else:
        pixels = d.images[frame_index][yi, xi].reshape(n, -1)
    if dataset.raw and d.mosaick_mask is not None:
        chan = d.mosaick_mask[yi, xi].astype(np.int32)
    else:
        chan = np.zeros(n, np.int32)
    return PixelBatch(
        camera_indices=torch.full((n,), frame_index, dtype=torch.int64, device=dev),
        pixel_coords=torch.as_tensor(coords, device=dev),
        pixels=torch.as_tensor(pixels, device=dev),
        mosaick_channel=torch.as_tensor(chan, device=dev),
    )
