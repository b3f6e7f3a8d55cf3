"""Inputs drawn from a seed: images, moving face landmarks, pose
skeletons, and their class maps and boxes.

One general generator, driven by a traffic file's parameters. Every
random number comes from a `numpy.random.Generator` made from the seed
(small arrays of motion parameters and low-resolution noise); the
drawing runs in torch on the given device, so the same seed gives the
same inputs on any device.

Face: 68 landmarks (jaw 17, brows 5 + 5, nose 4 + 5, eyes 6 + 6, mouth
12 + 8) on a template, per subject placed and sized, per frame turned,
shifted, the mouth and the eyes opened and closed on smooth sinusoids;
the edges are drawn as 1-pixel-radius lines into class 1 (label_nc 2).
Pose: 18 OpenPose keypoints of a standing figure with seeded joint
angles; the limbs drawn thick into classes 5-23, the head's segments
into 1-4 and a face disc into the last class, so that the face crop
finds a face.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _ellipse(cx, cy, rx, ry, n, closed=True):
    a = np.linspace(0, 2 * np.pi, n, endpoint=not closed)
    return np.stack([cx + rx * np.cos(a), cy + ry * np.sin(a)], -1)


FACE_GROUPS = ((0, 17, False), (17, 22, False), (22, 27, False),
               (27, 31, False), (31, 36, False), (36, 42, True),
               (42, 48, True), (48, 60, True), (60, 68, True))


def face_edges() -> np.ndarray:
    """(E, 2) landmark index pairs: consecutive points of each group, the
    eyes and the mouth closed."""
    edges = []
    for lo, hi, closed in FACE_GROUPS:
        edges += [(i, i + 1) for i in range(lo, hi - 1)]
        if closed:
            edges.append((hi - 1, lo))
    return np.asarray(edges)


def face_template(mouth_open: float, eye_open: float) -> np.ndarray:
    """(68, 2) landmarks in [-1, 1] (x right, y down)."""
    i = np.arange(17)
    jaw = np.stack([-0.8 * np.cos(np.pi * i / 16),
                    0.1 + 0.8 * np.sin(np.pi * i / 16)], -1)
    t = np.linspace(0, 1, 5)
    brow_l = np.stack([-0.6 + 0.45 * t, -0.35 - 0.08 * np.sin(np.pi * t)], -1)
    brow_r = brow_l * [-1, 1]
    bridge = np.stack([np.zeros(4), np.linspace(-0.25, 0.15, 4)], -1)
    nose = np.stack([np.linspace(-0.15, 0.15, 5), np.full(5, 0.22)], -1)
    eye_l = _ellipse(-0.35, -0.15, 0.13, 0.05 * eye_open + 0.01, 6)
    eye_r = _ellipse(0.35, -0.15, 0.13, 0.05 * eye_open + 0.01, 6)
    mouth = _ellipse(0.0, 0.5, 0.3, 0.08 * (1 + mouth_open), 12)
    inner = _ellipse(0.0, 0.5, 0.2, 0.04 * mouth_open + 0.005, 8)
    return np.concatenate([jaw, brow_l, brow_r, bridge, nose, eye_l, eye_r,
                           mouth, inner]).astype(np.float32)


def face_track(rng, frames: int, size: int) -> np.ndarray:
    """(frames, 68, 2) pixel positions of one subject's moving face."""
    cx, cy = size * (0.5 + rng.uniform(-0.05, 0.05, 2))
    scale = size * rng.uniform(0.25, 0.31)
    w = rng.uniform(0.05, 0.3, 5)
    ph = rng.uniform(0, 2 * np.pi, 5)
    out = np.empty((frames, 68, 2), np.float32)
    for f in range(frames):
        s = np.sin(w * f + ph)
        pts = face_template(0.5 + 0.5 * s[0], 0.6 + 0.4 * s[1])
        ang = 0.12 * s[2]
        rot = np.array([[math.cos(ang), -math.sin(ang)],
                        [math.sin(ang), math.cos(ang)]], np.float32)
        out[f] = pts @ rot.T * scale + [cx + 0.03 * size * s[3],
                                        cy + 0.03 * size * s[4]]
    return out


POSE_LIMBS = (  # (a, b, class): head 1-4, body and limbs 5-22
    (1, 0, 1), (0, 14, 2), (0, 15, 2), (14, 16, 3), (15, 17, 4),
    (1, 2, 5), (2, 3, 6), (3, 4, 7), (1, 5, 8), (5, 6, 9), (6, 7, 10),
    (1, 8, 11), (8, 9, 12), (9, 10, 13), (1, 11, 14), (11, 12, 15),
    (12, 13, 16), (2, 8, 17), (5, 11, 18), (8, 11, 19))


def pose_skeleton(rng, size: int) -> np.ndarray:
    """(18, 2) OpenPose keypoints of a standing figure, in pixels."""
    h = size * rng.uniform(0.7, 0.85)
    cx = size * (0.5 + rng.uniform(-0.06, 0.06))
    top = size * 0.08 + rng.uniform(0, size * 0.05)
    u = h / 8.0
    jitter = rng.uniform(-0.35, 0.35, 8)
    neck = np.array([cx, top + 1.3 * u])
    nose = neck + [0.1 * u * jitter[0], -0.9 * u]
    pts = np.zeros((18, 2), np.float32)
    pts[0], pts[1] = nose, neck
    for side, k in ((-1, 2), (1, 5)):
        sh = neck + [side * 0.9 * u, 0.1 * u]
        a1 = np.pi / 2 - side * (0.3 + jitter[1 + (k == 5)])
        el = sh + 1.4 * u * np.array([np.cos(a1), np.sin(a1)])
        a2 = a1 - side * 0.4 * jitter[3]
        wr = el + 1.3 * u * np.array([np.cos(a2), np.sin(a2)])
        pts[k], pts[k + 1], pts[k + 2] = sh, el, wr
    for side, k in ((-1, 8), (1, 11)):
        hip = neck + [side * 0.5 * u, 3.0 * u]
        a = np.pi / 2 - side * 0.15 * jitter[4 + (k == 11)]
        knee = hip + 1.9 * u * np.array([np.cos(a), np.sin(a)])
        ank = knee + 1.8 * u * np.array([np.cos(a + 0.1 * jitter[6]),
                                         np.sin(a + 0.1 * jitter[6])])
        pts[k], pts[k + 1], pts[k + 2] = hip, knee, ank
    pts[14] = nose + [-0.25 * u, -0.2 * u]
    pts[15] = nose + [0.25 * u, -0.2 * u]
    pts[16] = nose + [-0.5 * u, -0.05 * u]
    pts[17] = nose + [0.5 * u, -0.05 * u]
    return pts


def draw(segments: torch.Tensor, size: int, chunk: int = 16) -> torch.Tensor:
    """Class maps of N frames from their segments (N, K, 6): x0, y0, x1,
    y1, radius, class. A pixel within `radius` of a segment takes the
    segment's class (the highest where several reach it), else 0.
    Returns (N, size, size) uint8 on the segments' device."""
    dev = segments.device
    ys, xs = torch.meshgrid(torch.arange(size, device=dev, dtype=torch.float32),
                            torch.arange(size, device=dev, dtype=torch.float32),
                            indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)       # (P, 2)
    out = []
    for lo in range(0, segments.shape[0], chunk):
        seg = segments[lo:lo + chunk]
        a, b = seg[..., None, 0:2], seg[..., None, 2:4]           # (n, K, 1, 2)
        ab = b - a
        t = (((pix - a) * ab).sum(-1) / (ab * ab).sum(-1).clamp(min=1e-6))
        near = a + t.clamp(0, 1)[..., None] * ab
        d2 = ((pix - near) ** 2).sum(-1)                          # (n, K, P)
        hit = d2 <= seg[..., 4:5] ** 2
        cls = torch.where(hit, seg[..., 5:6], torch.zeros_like(d2))
        out.append(cls.amax(1).reshape(-1, size, size).to(torch.uint8))
    return torch.cat(out)


def boxes(points: torch.Tensor, size: int, margin: float) -> torch.Tensor:
    """(N, size, size) float masks of each frame's keypoint box (N, K, 2),
    widened by `margin` of its side."""
    lo = points.amin(1)
    hi = points.amax(1)
    pad = (hi - lo) * margin
    lo, hi = (lo - pad).clamp(0, size - 1), (hi + pad).clamp(0, size - 1)
    r = torch.arange(size, device=points.device, dtype=torch.float32)
    iny = (r[None] >= lo[:, 1:2]) & (r[None] <= hi[:, 1:2])
    inx = (r[None] >= lo[:, 0:1]) & (r[None] <= hi[:, 0:1])
    return (iny[:, :, None] & inx[:, None, :]).float()


def face_segments(track: np.ndarray, radius: float) -> np.ndarray:
    e = face_edges()
    n, k = track.shape[0], e.shape[0]
    seg = np.empty((n, k, 6), np.float32)
    seg[..., 0:2] = track[:, e[:, 0]]
    seg[..., 2:4] = track[:, e[:, 1]]
    seg[..., 4] = radius
    seg[..., 5] = 1
    return seg


def pose_segments(pts: np.ndarray, size: int, label_nc: int) -> np.ndarray:
    """(K, 6) limbs, and the face disc in the last class."""
    width = size / 64.0
    seg = [(*pts[a], *pts[b], 1.5 * width, min(c, label_nc - 2))
           for a, b, c in POSE_LIMBS]
    head = np.linalg.norm(pts[16] - pts[17])
    seg.append((*pts[0], *pts[0], 0.55 * head, label_nc - 1))
    return np.asarray(seg, np.float32)


def smooth_images(rng, n: int, size: int, device) -> torch.Tensor:
    """(n, size, size, 3) model-space images: 8x8 noise, bilinearly
    upsampled, around a seeded colour, in [-0.45, 0.55]."""
    low = rng.uniform(-0.3, 0.3, (n, 3, 8, 8)).astype(np.float32)
    base = rng.uniform(-0.2, 0.2, (n, 3, 1, 1)).astype(np.float32)
    x = torch.as_tensor(low + base, device=device)
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False)
    return x.clamp(-0.45, 0.55).permute(0, 2, 3, 1).contiguous()


def one_hot(lbl: torch.Tensor, n: int) -> torch.Tensor:
    return F.one_hot(lbl.long(), n).float()


def face_clip(rng, frames: int, size: int, device, radius: float):
    """One face clip: class maps (frames, H, W) uint8 and boxes
    (frames, H, W) float32, on `device`."""
    track = face_track(rng, frames, size)
    seg = torch.as_tensor(face_segments(track, radius), device=device)
    lbl = draw(seg, size)
    box = boxes(torch.as_tensor(track, device=device), size, 0.1)
    return lbl, box


def pose_frames(rng, n: int, size: int, label_nc: int, device):
    """n pose frames: class maps (n, H, W) uint8 and person boxes."""
    pts = np.stack([pose_skeleton(rng, size) for _ in range(n)])
    seg = np.stack([pose_segments(p, size, label_nc) for p in pts])
    lbl = draw(torch.as_tensor(seg, device=device), size)
    box = boxes(torch.as_tensor(pts, device=device), size, 0.1)
    return lbl, box


def train_batch(rng, cfg: dict, batch: int, labels: str, radius: float,
                device) -> dict:
    """One training batch, NHWC tensors on `device`: S sources and one
    target per sample, each sample its own subject."""
    size, s, nc = cfg["image_size"], cfg["n_source"], cfg["label_nc"]
    src_lbl, src_box, tar_lbl, tar_box = [], [], [], []
    for _ in range(batch):
        if labels == "face":
            lbl, box = face_clip(rng, s + 1, size, device, radius)
        else:
            lbl, box = pose_frames(rng, s + 1, size, nc, device)
        src_lbl.append(lbl[:s])
        src_box.append(box[:s])
        tar_lbl.append(lbl[s])
        tar_box.append(box[s])
    imgs = smooth_images(rng, batch * (s + 1), size, device).reshape(
        batch, s + 1, size, size, 3)
    return {"src_img": imgs[:, :s].contiguous(),
            "src_lbl": one_hot(torch.stack(src_lbl), nc),
            "src_bbox": torch.stack(src_box),
            "tar_img": imgs[:, s].contiguous(),
            "tar_lbl": one_hot(torch.stack(tar_lbl), nc),
            "tar_bbox": torch.stack(tar_box)}
