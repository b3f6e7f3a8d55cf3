"""Host-side rasterization of keypoints (the port's own copy of the JAX
package's `data/rasterize.py`).

A keypoint edge is fitted by least squares (quadratic, linear for two
points) along the axis of larger span, sampled at unit steps and stamped
with a (2 bw)^2 square brush (`interp_curve`, `stamp_edge`, `draw_edge`;
the face labels of training use them through `data.face`). `draw_edge`
runs the native C++ form of the same loop (`native/`, built by the host's
compiler at first use), as the JAX package's does; `TSNET_NATIVE=0` in
the environment selects the numpy form, read at each call. A native
build or load that fails raises.

The OpenPose half renders a person's BODY_25 skeleton, hands and face
into a colour label image (the reference's keypoint2img): keypoints
below their confidence threshold are zeroed (`valid_keypoints`), every
edge whose two x coordinates are non-zero is drawn in its palette colour
(pose edges with radius-2bw end dots), and of several people the one of
largest vertical pose extent is kept (`render_openpose`). Brush widths
are drawn from the `random.Random` given in train mode, in the JAX
package's order, so a seeded dataset draws the same labels.
"""

from __future__ import annotations

import json
import math
import os
import random as _random
from typing import Optional, Sequence

import numpy as np

from ..native import native_draw_edge
from .codecs import POSE_PALETTE

# skeleton topology: OpenPose BODY_25, 21-point hands, 70-point face
POSE_EDGES_BASIC = [
    (17, 15), (15, 0), (0, 16), (16, 18),      # head
    (0, 1), (1, 8),                            # body
    (1, 2), (2, 3), (3, 4),                    # right arm
    (1, 5), (5, 6), (6, 7),                    # left arm
    (8, 9), (9, 10), (10, 11),                 # right leg
    (8, 12), (12, 13), (13, 14),               # left leg
]
POSE_EDGES_FEET = [
    (11, 24), (11, 22), (22, 23),              # right foot
    (14, 21), (14, 19), (19, 20),              # left foot
]
# the feet edges repeat the leg colours
_FEET_COLORS = [[0, 153, 153]] * 3 + [[0, 0, 153]] * 3

HAND_FINGERS = [
    (0, 1, 2, 3, 4),
    (0, 5, 6, 7, 8),
    (0, 9, 10, 11, 12),
    (0, 13, 14, 15, 16),
    (0, 17, 18, 19, 20),
]

FACE_SEGMENTS = [
    [list(range(0, 17))],
    [list(range(17, 22))],
    [list(range(22, 27))],
    [[28, 31], list(range(31, 36)), [35, 28]],
    [[36, 37, 38, 39], [39, 40, 41, 36]],
    [[42, 43, 44, 45], [45, 46, 47, 42]],
    [list(range(48, 55)), [54, 55, 56, 57, 58, 59, 48]],
]

HAND_COLORS = [list(c) for c in POSE_PALETTE[18:23]]


def pose_edge_colors(basic_point_only: bool):
    """The pose edges and their palette colours, in stamping order."""
    edges = list(POSE_EDGES_BASIC)
    colors = [list(c) for c in POSE_PALETTE[:18]]
    if not basic_point_only:
        edges += POSE_EDGES_FEET
        colors += _FEET_COLORS
    return edges, colors


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
    """Fit and stamp one keypoint edge into the uint8 image, in place:
    natively unless `TSNET_NATIVE=0`, else `interp_curve` + `stamp_edge`
    (the tests bound how far the two differ)."""
    if os.environ.get("TSNET_NATIVE", "1") != "0":
        native_draw_edge(img, x, y, bw, color, endpoints)
        return
    cx, cy = interp_curve(x, y)
    stamp_edge(img, cx, cy, bw=bw, color=color, endpoints=endpoints)


# ---------------------------------------------------------------- OpenPose

def valid_keypoints(pts: np.ndarray) -> np.ndarray:
    """(N, 3) [x, y, confidence] -> (N, 2) xy with low-confidence points
    zeroed. Face (N=70): threshold 0.1, and a whole segment of
    `FACE_SEGMENTS` must pass; hands (N=21): 0.01, a whole finger; body:
    0.01, point by point."""
    n = pts.shape[0]
    thr = 0.1 if n == 70 else 0.01
    out = np.zeros((n, 2))
    if n == 70:
        for seg_list in FACE_SEGMENTS:
            for seg in seg_list:
                idx = np.asarray(seg)
                if (pts[idx, 2] > thr).all():
                    out[idx] = pts[idx, :2]
    elif n == 21:
        for finger in HAND_FINGERS:
            idx = np.asarray(finger)
            if (pts[idx, 2] > thr).all():
                out[idx] = pts[idx, :2]
    else:
        keep = pts[:, 2] > thr
        out[keep] = pts[keep, :2]
    return out


def parse_openpose_json(source) -> list[dict[str, np.ndarray]]:
    """An OpenPose output JSON, as a path or as the JSON text itself (a
    `{` within its first 64 characters), -> one dict a person of (25, 3)
    `pose`, (70, 3) `face`, (21, 3) `hand_l` and `hand_r` float64."""
    if isinstance(source, (str, bytes)) and "{" not in str(source)[:64]:
        with open(source, encoding="utf-8") as f:
            payload = json.load(f)
    else:
        payload = json.loads(source)
    people = []
    for person in payload["people"]:
        people.append({
            "pose": np.asarray(person["pose_keypoints_2d"],
                               np.float64).reshape(25, 3),
            "face": np.asarray(person["face_keypoints_2d"],
                               np.float64).reshape(70, 3),
            "hand_l": np.asarray(person["hand_left_keypoints_2d"],
                                 np.float64).reshape(21, 3),
            "hand_r": np.asarray(person["hand_right_keypoints_2d"],
                                 np.float64).reshape(21, 3),
        })
    return people


def render_person(pose, face, hand_l, hand_r, size, train: bool,
                  rng: Optional[_random.Random] = None,
                  basic_point_only: bool = False,
                  remove_face_labels: bool = False) -> np.ndarray:
    """One person's validated (K, 2) keypoints -> (h, w, 3) uint8 label
    image, `size` = (w, h). Brush widths: in train mode drawn from `rng`
    (pose 2..4, then hands 1..2, then face 1..2); at test time from the
    person's pose height (pose extent // 150, hands and face // 450, at
    least 1)."""
    rng = rng or _random
    w, h = size
    img = np.zeros((h, w, 3), np.uint8)
    y_extent = int(pose[:, 1].max() - pose[:, 1].min())

    edges, colors = pose_edge_colors(basic_point_only)
    bw = rng.randrange(2, 5) if train else max(1, y_extent // 150)
    for (a, b), color in zip(edges, colors):
        x = pose[[a, b], 0]
        y = pose[[a, b], 1]
        if 0 not in x:
            draw_edge(img, x, y, bw=bw, color=color, endpoints=True)

    if not basic_point_only:
        bw = rng.randrange(1, 3) if train else max(1, y_extent // 450)
        for hand in (hand_l, hand_r):
            for finger, color in zip(HAND_FINGERS, HAND_COLORS):
                for j in range(len(finger) - 1):
                    x = hand[[finger[j], finger[j + 1]], 0]
                    y = hand[[finger[j], finger[j + 1]], 1]
                    if 0 not in x:
                        draw_edge(img, x, y, bw=bw, color=color)

        if not remove_face_labels:
            bw = rng.randrange(1, 3) if train else max(1, y_extent // 450)
            for seg_list in FACE_SEGMENTS:
                for seg in seg_list:
                    for i in range(0, max(1, len(seg) - 1)):
                        sub = seg[i:i + 2]
                        x = face[np.asarray(sub), 0]
                        y = face[np.asarray(sub), 1]
                        if 0 not in x:
                            draw_edge(img, x, y, bw=bw)
    return img


def render_openpose(source, size, train: bool = False,
                    rng: Optional[_random.Random] = None,
                    basic_point_only: bool = False,
                    remove_face_labels: bool = False,
                    person_idx: Optional[int] = None):
    """OpenPose JSON (path or text) -> (label image (h, w, 3) uint8, the
    drawn person's validated pose (25, 2), face (70, 2)); the person of
    largest vertical pose extent is drawn (or `person_idx`), none where
    every extent is 0."""
    people = parse_openpose_json(source)
    if person_idx is not None:
        people = [people[person_idx]]
    w, h = size
    best_img = np.zeros((h, w, 3), np.uint8)
    best_pose = np.zeros((25, 3))
    best_face = np.zeros((70, 3))
    best_extent = 0.0
    for person in people:
        pose = valid_keypoints(person["pose"])
        face = valid_keypoints(person["face"])
        hand_l = valid_keypoints(person["hand_l"])
        hand_r = valid_keypoints(person["hand_r"])
        extent = pose[:, 1].max() - pose[:, 1].min()
        if extent > best_extent:
            best_extent = extent
            best_img = render_person(pose, face, hand_l, hand_r, size, train,
                                     rng, basic_point_only,
                                     remove_face_labels)
            best_pose, best_face = pose, face
    return best_img, best_pose, best_face
