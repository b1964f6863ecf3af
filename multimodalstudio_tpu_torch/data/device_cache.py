"""Device-resident dataset cache with on-device pixel sampling (JAX
reference: data/device_cache.py).

Every frame lives on the card, quantised to uint16 with scale 1/65535 (or
as float32, unquantised), and each training step draws its pixel batch
there from a torch.Generator, so a step moves no bytes from the host. The draws are not the reference's
jax.random bits; the tests compare the two packages on host-sampled
batches (data/sampler.py::UniformPixelSampler).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from multimodalstudio_tpu_torch.data.dataset import MMSDataset
from multimodalstudio_tpu_torch.data.sampler import PixelBatch


@dataclasses.dataclass
class DeviceModalityCache:
    images: torch.Tensor  # [F*H*W, C] uint16 bits in int32, or float32; frames flattened
    mosaick_mask: torch.Tensor  # [H*W] int32 (zeros when not raw)
    shape: Tuple[int, int, int]  # (F, H, W)
    scale: float  # dequantisation factor
    pixel_offset: float = 0.5


@dataclasses.dataclass
class DeviceDataCache:
    data: Dict[str, DeviceModalityCache]


def build_device_cache(dataset: MMSDataset, quantize: bool = True,
                       device="cuda") -> DeviceDataCache:
    """Every modality's frames on `device` (device_cache.py:42-66): with
    quantize, as uint16 round(clip(x) * 65535) with scale 1/65535, else as
    float32 with scale 1."""
    out = {}
    for mod in dataset.modalities:
        d = dataset.data[mod]
        imgs = d.images
        if quantize:
            # torch has no uint16 arithmetic on every device: keep the bits in int32
            stored = (np.clip(imgs, 0.0, 1.0) * 65535.0 + 0.5).astype(np.uint16).astype(np.int32)
        else:
            stored = imgs.astype(np.float32)
        mask = (
            d.mosaick_mask.astype(np.int32)
            if dataset.raw and d.mosaick_mask is not None
            else np.zeros(imgs.shape[1:3], np.int32)
        )
        f, h, w, c = imgs.shape
        images = torch.as_tensor(stored.reshape(f * h * w, c), device=device)
        out[mod] = DeviceModalityCache(
            images=images, mosaick_mask=torch.as_tensor(mask.reshape(h * w), device=device),
            shape=(f, h, w), scale=1.0 / 65535.0 if quantize else 1.0,
            pixel_offset=d.cameras.pixel_offset,
        )
    return DeviceDataCache(data=out)


def sample_pixel_batch(cache: DeviceDataCache, generator: torch.Generator,
                       num_rays_per_modality: int, modalities) -> Dict[str, PixelBatch]:
    """Uniform (frame, y, x) draws per modality on the cache's device
    (device_cache.py:69-94)."""
    batch = {}
    for mod in modalities:
        c = cache.data[mod]
        f, h, w = c.shape
        dev = c.images.device
        n = num_rays_per_modality
        fi = torch.randint(0, f, (n,), generator=generator, device=dev)
        yi = torch.randint(0, h, (n,), generator=generator, device=dev)
        xi = torch.randint(0, w, (n,), generator=generator, device=dev)
        pixels = c.images[(fi * h + yi) * w + xi].float() * c.scale
        coords = torch.stack([yi, xi], dim=-1).float() + c.pixel_offset
        batch[mod] = PixelBatch(camera_indices=fi, pixel_coords=coords, pixels=pixels,
                                mosaick_channel=c.mosaick_mask[yi * w + xi])
    return batch
