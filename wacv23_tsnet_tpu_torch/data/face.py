"""68-landmark face geometry (the port's own copy of the JAX package's
`data/face.py`): the part list, the edge-map rasterizer of the labels,
the landmark-extent bbox, the face-anchored crop box, the shift into
crop coordinates, and the cross-identity retargeter of the test set
(`FaceRetargeter`)."""

from __future__ import annotations

import random as _random
from typing import Optional, Sequence

import numpy as np

from .rasterize import draw_edge

# 68-landmark part edges (reference dataset_video_face.py part_list)
FACE_PART_LIST = [
    [list(range(0, 17))],                                    # jaw
    [list(range(17, 22))],                                   # right eyebrow
    [list(range(22, 27))],                                   # left eyebrow
    [[28, 31], list(range(31, 36)), [35, 28]],               # nose
    [[36, 37, 38, 39], [39, 40, 41, 36]],                    # right eye
    [[42, 43, 44, 45], [45, 46, 47, 42]],                    # left eye
    [list(range(48, 55)), [54, 55, 56, 57, 58, 59, 48],
     list(range(60, 65)), [64, 65, 66, 67, 60]],             # mouth + tongue
]

# per-part landmark groups for proportion retargeting
# (reference dataset_video_face.py:425-431)
RETARGET_PART_LIST = [
    [0, 16], [1, 15], [2, 14], [3, 13], [4, 12], [5, 11], [6, 10], [7, 9, 8],
    [17, 26], [18, 25], [19, 24], [20, 23], [21, 22],
    [27], [28], [29], [30], [31, 35], [32, 34], [33],
    [36, 45], [37, 44], [38, 43], [39, 42], [40, 47], [41, 46],
    [48, 54], [49, 53], [50, 52], [51], [55, 59], [56, 58], [57],
    [60, 64], [61, 63], [62], [65, 67], [66],
]

CENTRAL_KEYPOINT = 8  # the chin centre anchors the face coordinate frame


def render_face_edges(keypoints: np.ndarray, size, bw: int = 1) -> np.ndarray:
    """68 landmarks -> edge map (h, w) uint8 with values 0 and 255, each
    part edge drawn as 3-point quadratic segments; `size` is (w, h)."""
    w, h = size
    img = np.zeros((h, w), np.uint8)
    edge_len = 3
    for part in FACE_PART_LIST:
        for edge in part:
            for i in range(0, max(1, len(edge) - 1), edge_len - 1):
                sub = np.asarray(edge[i:i + edge_len])
                draw_edge(img, keypoints[sub, 0], keypoints[sub, 1],
                          bw=bw, color=(255, 255, 255))
    return img


def face_bbox_mask(keypoints: np.ndarray, size) -> np.ndarray:
    """Landmark extent + 1/16 margin as a filled uint8 mask (values 0 and
    255); `size` is (w, h). `RetargetSession._extent_bbox` is its device
    form."""
    w, h = size
    mask = np.zeros((h, w), np.uint8)
    x_min = int(max(0.0, keypoints[:, 0].min() - w // 16))
    x_max = int(min(w, keypoints[:, 0].max() + w // 16))
    y_min = int(max(0.0, keypoints[:, 1].min() - h // 16))
    y_max = int(min(h, keypoints[:, 1].max() + h // 16))
    mask[y_min:y_max, x_min:x_max] = 255
    return mask


def face_crop_coords(keypoints: np.ndarray, jitter: bool = False,
                     scale: Optional[Sequence[float]] = None,
                     rng: Optional[_random.Random] = None):
    """Face-anchored crop box [min_y, max_y, min_x, max_x].

    The box is 2w x 2h around the face centre (h shifted up by 1.25x);
    train-time jitter perturbs the centre (+-0.2 extent) and the scale
    (+-0.2), drawing from `rng` in the JAX package's order. Returns
    (coords, scale) so a clip can reuse the anchor frame's scale.
    """
    rng = rng or _random
    min_y, max_y = int(keypoints[:, 1].min()), int(keypoints[:, 1].max())
    min_x, max_x = int(keypoints[:, 0].min()), int(keypoints[:, 0].max())
    x_cen, y_cen = (min_x + max_x) // 2, (min_y + max_y) // 2
    w = h = float(max_x - min_x)
    if jitter:
        if scale is None:
            scale = [rng.uniform(0.8, 1.2), rng.uniform(0.8, 1.2)]
        offset = [rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2)]
        w *= scale[0]
        h *= scale[1]
        x_cen += int(offset[0] * w)
        y_cen += int(offset[1] * h)
    min_x = x_cen - w
    min_y = y_cen - h * 1.25
    coords = [int(min_y), int(min_y + h * 2), int(min_x), int(min_x + w * 2)]
    return coords, scale


def shift_keypoints(keypoints: np.ndarray, crop_coords) -> np.ndarray:
    """Keypoints in the coordinates of the crop `crop_coords`."""
    out = np.array(keypoints, np.float64, copy=True)
    out[:, 0] -= crop_coords[2]
    out[:, 1] -= crop_coords[0]
    return out


class FaceRetargeter:
    """Rescale driving-face part distances to the subject's proportions.

    `fit_reference(subject_frames)` measures the subject's per-part mean
    distances; `retarget(driving_frames)` computes per-part scale factors
    from the driving clip's own statistics and remaps every frame:
    pts' = (pts - part_centre) * sx + (part_centre - face_centre) * sy
    + face_centre (reference normalize_faces, dataset_video_face.py
    :411-454). Float64, with the JAX package's order of sums, so the
    results are equal to its.
    """

    def __init__(self):
        self.ref_dist_x = None
        self.ref_dist_y = None
        self.img_scale = None

    @staticmethod
    def _part_stats(frames, part):
        dists_x, dists_y = [], []
        for kp in frames:
            pts = kp[part]
            pts_cen = pts.mean(axis=0)
            face_cen = kp[[CENTRAL_KEYPOINT]].mean(axis=0)
            for pt in pts:
                dists_x.append(np.linalg.norm(pt - pts_cen))
                dists_y.append(np.linalg.norm(pts_cen - face_cen))
        return (sum(dists_x) / len(dists_x) + 1e-3,
                sum(dists_y) / len(dists_y) + 1e-3)

    def fit_reference(self, frames: Sequence[np.ndarray]) -> None:
        n = len(RETARGET_PART_LIST)
        self.ref_dist_x = [0.0] * n
        self.ref_dist_y = [0.0] * n
        for i, part in enumerate(RETARGET_PART_LIST):
            self.ref_dist_x[i], self.ref_dist_y[i] = self._part_stats(
                frames, part)
        self.img_scale = frames[0][:, 0].max() - frames[0][:, 0].min()

    def retarget(self, frames: Sequence[np.ndarray]) -> list[np.ndarray]:
        if self.img_scale is None:
            raise RuntimeError("call fit_reference before retarget")
        frames = [np.array(f, np.float64, copy=True) for f in frames]
        rel_scale = self.img_scale / (frames[0][:, 0].max()
                                      - frames[0][:, 0].min())
        face_centers = [kp[[CENTRAL_KEYPOINT]].mean(axis=0) for kp in frames]
        for i, part in enumerate(RETARGET_PART_LIST):
            mean_x, mean_y = self._part_stats(frames, part)
            sx = self.ref_dist_x[i] / mean_x / rel_scale
            sy = self.ref_dist_y[i] / mean_y / rel_scale
            for k, kp in enumerate(frames):
                pts = kp[part]
                pts_cen = pts.mean(axis=0)
                kp[part] = ((pts - pts_cen) * sx
                            + (pts_cen - face_centers[k]) * sy
                            + face_centers[k])
        return frames


def retarget_face_keypoints(subject_frames, driving_frames):
    """The driving frames retargeted onto the subject's proportions (one
    `FaceRetargeter` fitted and applied)."""
    r = FaceRetargeter()
    r.fit_reference(subject_frames)
    return r.retarget(driving_frames)
