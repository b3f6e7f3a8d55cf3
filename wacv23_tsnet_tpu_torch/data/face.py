"""68-landmark face geometry (the port's own copy of the JAX package's
`data/face.py:FACE_PART_LIST` and `face_bbox_mask`)."""

from __future__ import annotations

import numpy as np

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
