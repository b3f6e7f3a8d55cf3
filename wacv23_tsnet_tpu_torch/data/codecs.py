"""Label codecs of the pose task (the port's copy of the JAX package's
`data/codecs.py`): colour label image <-> class map <-> one-hot channels.

Class 0 is background; classes 1..24 are the rows of the 24-entry
OpenPose palette in the rasterizer's stamping order (4 head edges, 2
body, 3 right arm, 3 left arm, 3 right leg, 3 left leg, the 5 finger
colours, white for face edges). With `basic_point_only` and
`remove_face_labels` the model has 19 classes: background and the 18
basic limbs. The face task is binary (background / edge, edge pixels 255
in the rasterized map).
"""

from __future__ import annotations

import numpy as np

POSE_PALETTE = np.array([
    [153, 0, 153], [153, 0, 102], [102, 0, 153], [51, 0, 153],
    [153, 0, 51], [153, 0, 0],
    [153, 51, 0], [153, 102, 0], [153, 153, 0],
    [102, 153, 0], [51, 153, 0], [0, 153, 0],
    [0, 153, 51], [0, 153, 102], [0, 153, 153],
    [0, 102, 153], [0, 51, 153], [0, 0, 153],
    [204, 0, 0], [163, 204, 0], [0, 204, 82], [0, 82, 204], [163, 0, 204],
    [255, 255, 255],
], dtype=np.uint8)


def _num_classes(basic_point_only: bool, remove_face_labels: bool) -> int:
    return 19 if (basic_point_only and remove_face_labels) else 25


def image_to_labels(img: np.ndarray, task: str = "pose",
                    basic_point_only: bool = False,
                    remove_face_labels: bool = False) -> np.ndarray:
    """(H, W, 3) uint8 rasterized label image -> (H, W) uint8 class map
    (a colour outside the palette is background)."""
    if task == "face":
        return (img == 255).astype(np.uint8)
    flat = img.reshape(-1, 3)
    out = np.zeros(flat.shape[0], dtype=np.uint8)
    for idx, color in enumerate(POSE_PALETTE):
        out[np.all(flat == color, axis=1)] = idx + 1
    return out.reshape(img.shape[:2])


def labels_to_image(lbl: np.ndarray, task: str = "pose",
                    basic_point_only: bool = False,
                    remove_face_labels: bool = False) -> np.ndarray:
    """Class map -> displayable uint8 image: (H, W, 3) palette colours for
    the pose task, (H, W) 0/255 for the face task."""
    if task == "face":
        return np.where(lbl == 1, 255, 0).astype(np.uint8)
    n = _num_classes(basic_point_only, remove_face_labels)
    lut = np.zeros((n, 3), dtype=np.uint8)
    lut[1:n] = POSE_PALETTE[: n - 1]
    return lut[np.clip(lbl, 0, n - 1)]


def labels_to_onehot(lbl: np.ndarray, task: str = "pose",
                     basic_point_only: bool = False,
                     remove_face_labels: bool = False) -> np.ndarray:
    """(..., H, W) class map -> (..., num_classes, H, W) float32 one-hot,
    channels first (the reference's `vl2ch`)."""
    n = 2 if task == "face" else _num_classes(basic_point_only,
                                              remove_face_labels)
    lbl = np.asarray(lbl)
    return (lbl[..., None, :, :] ==
            np.arange(n).reshape((n, 1, 1))).astype(np.float32)
