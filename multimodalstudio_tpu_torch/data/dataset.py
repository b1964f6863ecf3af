"""Datasets and mosaick masks (JAX reference: data/dataset.py). Frames are
host numpy arrays (float32 in [0, 1]); camera tables are tensors on the
dataset's device. Loading scenes from disk is not ported yet."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np

from multimodalstudio_tpu_torch.cameras.cameras import Cameras
from multimodalstudio_tpu_torch.core.scene_box import SceneBox


def build_mosaick_mask(pattern: np.ndarray, height: int, width: int) -> np.ndarray:
    """Tile a mosaick pattern to frame size."""
    n_h = math.ceil(height / pattern.shape[0])
    n_w = math.ceil(width / pattern.shape[1])
    return np.tile(pattern, (n_h, n_w))[:height, :width].astype(np.int8)


def build_masks_across_modalities(
    patterns: Dict[str, np.ndarray], shapes: Dict[str, Tuple[int, int]]
) -> Dict[str, Dict[str, np.ndarray]]:
    """Every modality's pattern tiled to every modality's frame shape."""
    return {
        mod_shape: {mod_pat: build_mosaick_mask(p, h, w) for mod_pat, p in patterns.items()}
        for mod_shape, (h, w) in shapes.items()
    }


@dataclasses.dataclass
class ModalityData:
    """All frames and cameras of one modality."""

    images: np.ndarray  # [F, H, W, C] float32
    cameras: Cameras
    frame_ids: np.ndarray  # [F] original view ids
    mosaick_pattern: Optional[np.ndarray] = None
    mosaick_mask: Optional[np.ndarray] = None  # [H, W] int8

    @property
    def num_frames(self) -> int:
        return self.images.shape[0]

    @property
    def channels(self) -> int:
        return self.images.shape[-1]


@dataclasses.dataclass
class MMSDataset:
    """A split (train or eval) of a multimodal scene."""

    modalities: Tuple[str, ...]
    data: Dict[str, ModalityData]
    scene_box: SceneBox
    worldtogt: np.ndarray
    raw: bool
    # masks[target_shape_modality][pattern_modality]
    mosaick_masks_across: Optional[Dict[str, Dict[str, np.ndarray]]] = None

    @property
    def channels_per_modality(self) -> Dict[str, int]:
        out = {}
        for mod, d in self.data.items():
            if self.raw and d.mosaick_pattern is not None:
                out[mod] = int(len(np.unique(d.mosaick_pattern)))
            else:
                out[mod] = d.channels
        return out

    def num_frames(self, mod: str) -> int:
        return self.data[mod].num_frames
