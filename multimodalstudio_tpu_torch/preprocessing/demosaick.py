"""Demosaicking for Bayer, polarization and multispectral mosaicks
(JAX reference: preprocessing/demosaick.py, copied: host-side numpy, with
OpenCV imported only inside the two edge-aware functions).

`demosaick_grid` is the bilinear per-channel interpolation with linear
border extrapolation that the raw evaluator's demosaicked metric regimes
score through.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def _to_uint16(raw: np.ndarray) -> tuple:
    """cv2's edge-aware demosaicing needs uint8/uint16 input."""
    if raw.dtype in (np.uint8, np.uint16):
        return raw, None
    clipped = np.clip(raw, 0.0, 1.0)
    return (clipped * 65535.0 + 0.5).astype(np.uint16), np.float32(65535.0)


def _from_uint16(img: np.ndarray, scale) -> np.ndarray:
    if scale is None:
        return img
    return img.astype(np.float32) / scale


def demosaick_bayer(raw: np.ndarray, pattern: str = "RGGB") -> np.ndarray:
    """Bayer -> RGB via OpenCV EDGE-AWARE demosaicing (the reference's
    choice for rgb, evaluate_average_metrics.py:62 / preprocess_mmsdata.py:34
    use cv.COLOR_Bayer*_EA). Float input is scored through uint16."""
    import cv2

    # OpenCV Bayer code naming refers to the 2x2 starting at (1, 1); these
    # map an image whose top-left 2x2 reads <key> to the EA BGR conversion.
    codes = {
        "RGGB": cv2.COLOR_BayerBG2BGR_EA,
        "BGGR": cv2.COLOR_BayerRG2BGR_EA,
        "GRBG": cv2.COLOR_BayerGB2BGR_EA,
        "GBRG": cv2.COLOR_BayerGR2BGR_EA,
    }
    raw2 = raw[..., 0] if raw.ndim == 3 else raw
    as_u16, scale = _to_uint16(raw2)
    bgr = cv2.demosaicing(as_u16, codes[pattern])
    return _from_uint16(bgr[..., ::-1], scale)  # BGR -> RGB


def bayer_pattern_string(pattern: np.ndarray) -> str:
    """2x2 channel-index pattern (0=R, 1=G, 2=B) -> OpenCV pattern string,
    e.g. [[1, 2], [0, 1]] -> 'GBRG'."""
    flat = np.asarray(pattern).reshape(-1)
    return "".join("RGB"[int(c)] for c in flat)


def demosaick_polarization(raw: np.ndarray, pattern: Optional[np.ndarray] = None,
                           edge_aware: bool = True) -> np.ndarray:
    """2x2 polarizer-filter array -> [H, W, 4].

    Edge-aware path (default, matching the reference's polanalyser
    COLOR_PolarMono_EA at evaluate_average_metrics.py:65): each angle's
    subgrid is rolled onto the R site of a Bayer layout and interpolated
    with cv2's edge-aware Bayer kernel — all four PFA channels have the
    same 1-in-4 sampling as Bayer R, so the EA interpolator transfers
    directly. Falls back to bilinear grid interpolation otherwise."""
    if pattern is None:
        pattern = np.array([[0, 1], [3, 2]])
    if not edge_aware:
        return demosaick_grid(raw, pattern)
    import cv2

    raw2 = raw[..., 0] if raw.ndim == 3 else raw
    as_u16, scale = _to_uint16(raw2)
    h, w = as_u16.shape
    channels = int(np.max(pattern)) + 1
    out = np.zeros((h, w, channels), np.float32)
    for c in range(channels):
        ys, xs = np.nonzero(np.asarray(pattern) == c)
        y0, x0 = int(ys[0]), int(xs[0])
        rolled = np.roll(as_u16, (-y0, -x0), axis=(0, 1))
        # COLOR_BayerBG2BGR: (0,0) is the R site -> BGR channel 2
        dem = cv2.demosaicing(rolled, cv2.COLOR_BayerBG2BGR_EA)[..., 2]
        out[..., c] = np.roll(dem, (y0, x0), axis=(0, 1))
    return _from_uint16(out, scale) if scale is not None else out


# SILIOS CMS-C1 filter-array position -> wavelength order (reference
# utils.py:248-253): channel c of the demosaicked stack is taken from
# mosaic position _SILIOS_BAND_ORDER[c].
_SILIOS_BAND_ORDER = (5, 4, 3, 6, 0, 1, 2, 8, 7)


def multispectral_band_sort(frame: np.ndarray) -> np.ndarray:
    """Reorder SILIOS CMS-C1 bands to wavelength order
    (reference utils.py:248-253)."""
    return frame[..., list(_SILIOS_BAND_ORDER)]


def demosaick_multispectral(
    raw: np.ndarray, bands: int = 9, band_sort: bool = True
) -> np.ndarray:
    """3x3 multispectral filter array -> [H, W, 9] by per-channel grid
    interpolation (reference utils.py:215-246), then SILIOS CMS-C1 band
    re-sorting to wavelength order (utils.py:248-253) as the reference
    drivers do (preprocess_mmsdata.py:36)."""
    side = int(np.sqrt(bands))
    pattern = np.arange(bands).reshape(side, side)
    out = demosaick_grid(raw, pattern)
    if band_sort and bands == 9:
        out = multispectral_band_sort(out)
    return out


def _interp_axis(values: np.ndarray, grid: np.ndarray, size: int) -> np.ndarray:
    """Linear interpolation with linear EXTRAPOLATION along axis 0 —
    RegularGridInterpolator(fill_value=None) semantics (reference
    utils.py:231-240), which cv2.resize does not reproduce at the borders."""
    q = np.arange(size, dtype=np.float64)
    idx = np.clip(np.searchsorted(grid, q, side="right") - 1, 0, len(grid) - 2)
    g0 = grid[idx]
    g1 = grid[idx + 1]
    t = ((q - g0) / (g1 - g0)).astype(np.float32)
    return values[idx] * (1.0 - t[:, None]) + values[idx + 1] * t[:, None]


def demosaick_grid(raw: np.ndarray, pattern: np.ndarray) -> np.ndarray:
    """Generic mosaick demosaicking: for each channel, bilinear-interpolate
    its sparse sample grid back to full frame with linear border
    extrapolation — numerically matching the reference's
    RegularGridInterpolator formulation (utils.py:215-246)."""
    raw2 = raw[..., 0] if raw.ndim == 3 else raw
    h, w = raw2.shape
    pattern = np.asarray(pattern)
    ph, pw = pattern.shape
    channels = int(pattern.max()) + 1
    out = np.zeros((h, w, channels), dtype=np.float32)
    for c in range(channels):
        ys, xs = np.nonzero(pattern == c)
        # a channel may appear multiple times in the pattern (e.g. G in
        # RGGB): average the interpolated subgrids
        acc = np.zeros((h, w), np.float32)
        for y0, x0 in zip(ys, xs):
            ygrid = np.arange(y0, h, ph, dtype=np.float64)
            xgrid = np.arange(x0, w, pw, dtype=np.float64)
            sub = raw2[y0::ph, x0::pw].astype(np.float32)
            sub = _interp_axis(sub, ygrid, h)  # [h, nx]
            sub = _interp_axis(sub.T, xgrid, w).T  # [h, w]
            acc += sub
        out[..., c] = acc / len(ys)
    return out


def demosaick_for_modality(
    raw: np.ndarray, pattern: np.ndarray, mod: str
) -> np.ndarray:
    """Per-modality demosaicking dispatcher matching the reference metric
    protocol (evaluate_average_metrics.py:61-66): edge-aware Bayer for rgb,
    edge-aware PFA for polarization, grid interpolation otherwise. Channel
    order follows the pattern's channel indexing in every case."""
    pattern = np.asarray(pattern)
    if mod == "rgb" and pattern.shape == (2, 2) and int(pattern.max()) == 2:
        return demosaick_bayer(raw, bayer_pattern_string(pattern))
    if mod == "polarization" and pattern.shape == (2, 2):
        return demosaick_polarization(raw, pattern)
    return demosaick_grid(raw, pattern)


def mosaick(frame: np.ndarray, pattern: np.ndarray) -> np.ndarray:
    """Full-channel frame -> single-channel mosaicked frame (the inverse
    operation, used to synthesize raw data and in the raw evaluator)."""
    from multimodalstudio_tpu_torch.data.dataset import build_mosaick_mask

    h, w = frame.shape[:2]
    mask = build_mosaick_mask(pattern, h, w).astype(np.int64)
    return np.take_along_axis(frame, mask[..., None], axis=-1)[..., :1]
