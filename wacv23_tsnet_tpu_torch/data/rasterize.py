"""Host-side curve rasterization of keypoint edges (the port's own copy
of the JAX package's `data/rasterize.py:interp_curve`, `stamp_edge` and
`draw_edge`, which the face labels of training need).

A keypoint edge is fitted by least squares (quadratic, linear for two
points) along the axis of larger span, sampled at unit steps and stamped
with a (2 bw)^2 square brush. The JAX package's `draw_edge` takes a
native C++ fast path where one is built; the port runs the numpy form,
which that path is held equal to.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def _fit_axis(t: np.ndarray, v: np.ndarray):
    """Least-squares v = poly(t); unit-step samples along t."""
    try:
        if len(t) < 3:
            coef = np.polyfit(t, v, 1)
        else:
            coef = np.polyfit(t, v, 2)
            if abs(coef[0]) > 1:       # reject wild quadratics
                return None, None
    except (np.linalg.LinAlgError, ValueError):
        return None, None
    if not np.all(np.isfinite(coef)):
        return None, None
    if t[0] > t[-1]:
        t = t[::-1]
    ts = np.linspace(t[0], t[-1], math.ceil(t[-1] - t[0]))
    return ts, np.polyval(coef, ts)


def interp_curve(x: Sequence[float], y: Sequence[float]):
    """Keypoints -> integer pixel curve (curve_x, curve_y), or
    (None, None) on a degenerate fit."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if len(x) < 2:
        return None, None
    if np.abs(np.diff(x)).max() < np.abs(np.diff(y)).max():
        ts, vs = _fit_axis(y, x)
        if ts is None:
            return None, None
        return vs.astype(int), ts.astype(int)
    ts, vs = _fit_axis(x, y)
    if ts is None:
        return None, None
    return ts.astype(int), vs.astype(int)


def stamp_edge(img: np.ndarray, curve_x, curve_y, bw: int = 1,
               color=(255, 255, 255), endpoints: bool = False) -> None:
    """Stamp a curve with a (2bw)^2 square brush, in place.

    Offsets span [-bw, bw) on both axes, clipped at the borders; endpoint
    dots fill the radius-2bw disk (i^2 + j^2 < 4 bw^2).
    """
    if curve_x is None or len(curve_x) == 0:
        return
    h, w = img.shape[:2]
    xs = np.asarray(curve_x)
    ys = np.asarray(curve_y)
    off = np.arange(-bw, bw)
    oy, ox = np.meshgrid(off, off, indexing="ij")
    yy = np.clip(ys[None, :] + oy.reshape(-1, 1), 0, h - 1)
    xx = np.clip(xs[None, :] + ox.reshape(-1, 1), 0, w - 1)
    img[yy, xx] = color if img.ndim == 3 else color[0]

    if endpoints:
        off2 = np.arange(-2 * bw, 2 * bw)
        oy, ox = np.meshgrid(off2, off2, indexing="ij")
        disk = (oy ** 2 + ox ** 2) < 4 * bw * bw
        oy, ox = oy[disk], ox[disk]
        for ex, ey in ((xs[0], ys[0]), (xs[-1], ys[-1])):
            yy = np.clip(ey + oy, 0, h - 1)
            xx = np.clip(ex + ox, 0, w - 1)
            img[yy, xx] = color if img.ndim == 3 else color[0]


def draw_edge(img: np.ndarray, x, y, bw: int = 1, color=(255, 255, 255),
              endpoints: bool = False) -> None:
    """Fit and stamp one keypoint edge, in place."""
    cx, cy = interp_curve(x, y)
    stamp_edge(img, cx, cy, bw=bw, color=color, endpoints=endpoints)
