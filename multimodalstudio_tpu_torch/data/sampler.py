"""Pixel batches (JAX reference: data/sampler.py): uniform random training
batches drawn on the host with numpy, and dense full-view batches. The
training loop on the card samples on the device instead
(data/device_cache.py)."""

from __future__ import annotations

import dataclasses
from typing import Dict

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


class UniformPixelSampler:
    """Uniform random (frame, y, x) sampling per modality with numpy
    (sampler.py:32-60, the numpy branch of data/native.py::sample_pixels):
    one seed per modality per call from the sampler's generator."""

    def __init__(self, dataset: MMSDataset, num_rays_per_modality: int, seed: int = 0):
        self.dataset = dataset
        self.num_rays = num_rays_per_modality
        self.rng = np.random.default_rng(seed)

    def sample(self) -> Dict[str, PixelBatch]:
        batch = {}
        for mod in self.dataset.modalities:
            d = self.dataset.data[mod]
            n = self.num_rays
            rng = np.random.default_rng(int(self.rng.integers(0, 2**62)))
            f, h, w, _ = d.images.shape
            fi = rng.integers(0, f, n).astype(np.int32)
            yi = rng.integers(0, h, n)
            xi = rng.integers(0, w, n)
            coords = np.stack([yi, xi], -1).astype(np.float32) + d.cameras.pixel_offset
            mask = d.mosaick_mask if self.dataset.raw else None
            chan = mask[yi, xi].astype(np.int32) if mask is not None else np.zeros(n, np.int32)
            dev = d.cameras.device
            batch[mod] = PixelBatch(
                camera_indices=torch.as_tensor(fi, device=dev).long(),
                pixel_coords=torch.as_tensor(coords, device=dev),
                pixels=torch.as_tensor(np.ascontiguousarray(d.images[fi, yi, xi]), device=dev),
                mosaick_channel=torch.as_tensor(chan, device=dev),
            )
        return batch


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
