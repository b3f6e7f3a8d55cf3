"""Train-time photometric augmentation (counterpart of the JAX package's
`data/augment.py`) on uint8 RGB arrays, without Pillow.

One brightness / contrast / saturation / hue factor is drawn per clip
(`sample_jitter_factors`, the same `rng` calls in the same order as the
JAX package, so one `random.Random(seed)` gives the same factors) and
applied to every frame. `apply_jitter` reproduces Pillow's
`ImageEnhance` Brightness, Contrast and Color (`Image.blend` in float32,
truncated to uint8; Pillow's integer luma) and the HSV hue shift of the
JAX package's `_shift_hue` (Pillow's RGB <-> HSV conversions, with their
float and double steps).
"""

from __future__ import annotations

import random as _random

import numpy as np

JITTER_BRIGHT = 64.0 / 255
JITTER_CONTRAST = 0.25
JITTER_SAT = 0.25
JITTER_HUE = 0.04

_F32 = np.float32


def sample_jitter_factors(rng=None):
    rng = rng or _random
    return {
        "brightness": rng.uniform(max(0, 1 - JITTER_BRIGHT), 1 + JITTER_BRIGHT),
        "contrast": rng.uniform(max(0, 1 - JITTER_CONTRAST),
                                1 + JITTER_CONTRAST),
        "saturation": rng.uniform(max(0, 1 - JITTER_SAT), 1 + JITTER_SAT),
        "hue": rng.uniform(-JITTER_HUE, JITTER_HUE),
    }


def _luma(rgb: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> L: (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    c = rgb.astype(np.int64)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _blend(degenerate: np.ndarray, img: np.ndarray, alpha: float):
    """Pillow's `Image.blend(degenerate, img, alpha)`: float32 arithmetic,
    truncated, clipped to [0, 255] when extrapolating."""
    if alpha == 0.0:
        return np.broadcast_to(degenerate, img.shape).astype(np.uint8)
    if alpha == 1.0:
        return img.copy()
    a = _F32(alpha)
    one = degenerate.astype(np.int32)
    out = one.astype(_F32) + a * (img.astype(np.int32) - one).astype(_F32)
    return np.clip(out, 0.0, 255.0).astype(np.uint8)


def _rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    maxc = np.maximum(r, np.maximum(g, b))
    minc = np.minimum(r, np.minimum(g, b))
    grey = maxc == minc
    cr = np.where(grey, 1, maxc - minc).astype(_F32)
    s = cr / np.where(maxc == 0, 1, maxc).astype(_F32)
    rc = (maxc - r).astype(_F32) / cr
    gc = (maxc - g).astype(_F32) / cr
    bc = (maxc - b).astype(_F32) / cr
    h = np.where(r == maxc, (bc - gc).astype(np.float64),
                 np.where(g == maxc,
                          (2.0 + rc.astype(np.float64)) - bc,
                          (4.0 + gc.astype(np.float64)) - rc)).astype(_F32)
    h = np.fmod(h.astype(np.float64) / 6.0 + 1.0, 1.0).astype(_F32)
    uh = np.clip((h.astype(np.float64) * 255.0).astype(np.int64), 0, 255)
    us = np.clip((s.astype(np.float64) * 255.0).astype(np.int64), 0, 255)
    return np.stack([np.where(grey, 0, uh), np.where(grey, 0, us), maxc],
                    axis=-1).astype(np.uint8)


# which of (v, p, q, t) each of R, G, B takes, by hue sector (colorsys)
_SECTOR_RGB = np.array([[0, 3, 1], [2, 0, 1], [1, 0, 3], [1, 2, 0],
                        [3, 1, 0], [0, 1, 2]])


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = (hsv[..., i].astype(_F32) for i in range(3))
    h6 = h.astype(np.float64) * 6.0 / 255.0
    i = np.floor(h6).astype(np.int64)
    f = (h6 - i.astype(_F32)).astype(_F32)
    fs = (s.astype(np.float64) / 255.0).astype(_F32)
    v64 = v.astype(np.float64)

    def rnd(x):  # C round(): half away from zero, then CLIP8
        return np.clip(np.floor(x + 0.5), 0, 255).astype(np.uint8)

    cand = np.stack([hsv[..., 2], rnd(v64 * (1.0 - fs)),
                     rnd(v64 * (1.0 - (fs * f).astype(np.float64))),
                     rnd(v64 * (1.0 - fs * (1.0 - f.astype(np.float64))))])
    pick = np.moveaxis(_SECTOR_RGB[i % 6], -1, 0)          # (3, H, W)
    out = np.moveaxis(np.take_along_axis(cand, pick, axis=0), 0, -1)
    grey = (hsv[..., 1] == 0)[..., None]
    return np.where(grey, hsv[..., 2:3], out)


def _shift_hue(img: np.ndarray, hue_factor: float) -> np.ndarray:
    """Cyclic hue shift by hue_factor (in turns), through Pillow's HSV."""
    if abs(hue_factor) < 1e-9:
        return img
    hsv = _rgb_to_hsv(img)
    hsv[..., 0] = (hsv[..., 0].astype(np.int16)
                   + int(hue_factor * 255)) % 256
    return _hsv_to_rgb(hsv)


def apply_jitter(img: np.ndarray, f: dict) -> np.ndarray:
    """(H, W, 3) uint8 RGB frame jittered by the factors `f`."""
    img = _blend(np.zeros_like(img), img, f["brightness"])
    lum = _luma(img)
    mean = int(np.bincount(lum.ravel(), minlength=256) @ np.arange(256)
               / lum.size + 0.5)
    img = _blend(np.full_like(img, mean), img, f["contrast"])
    img = _blend(np.repeat(_luma(img)[..., None], 3, axis=-1), img,
                 f["saturation"])
    return _shift_hue(img, f["hue"])
