"""Face datasets (counterparts of the JAX package's
`data/datasets.py:FaceDatasetTrain` and `FaceDatasetTest`), on the port's
own PNG codec and resizes (`data.image_io`) instead of Pillow and OpenCV.

A training sample is one clip of `n_frame_total` frames of one video:
images BGR float32 minus the mean, (T, 3, H, W); labels the face-edge
class map (T, H, W) uint8 0/1; bboxes the landmark-extent masks
(T, H, W) uint8 0/1; and the label files' names. The random draws (clip
start, crop jitter, colour jitter, mirror coin) are the JAX package's, in
its order, from the `rng` given, so one `random.Random(seed)` gives the
same clips. A test sample is a subject clip and a driving clip in the
same layout, the driving landmarks retargeted onto the subject's face.
"""

from __future__ import annotations

import os
import random as _random
from typing import Optional

import numpy as np

from .augment import apply_jitter, sample_jitter_factors
from .face import (FaceRetargeter, face_bbox_mask, face_crop_coords,
                   render_face_edges, shift_keypoints)
from .image_io import crop, mirror, read_rgb, resize_frame, resize_mask
from .smoothing import smooth_keypoint_track

IMG_MEAN = np.array((101.84807705937696, 112.10832843463207,
                     111.65973036298041), dtype=np.float32)


def _listdir_sorted(path):
    return sorted(os.listdir(path))


def _bgr_mean_sub(frames, mean) -> np.ndarray:
    """(T, H, W, 3) uint8 RGB -> (T, 3, H, W) float32 BGR minus `mean`."""
    bgr = np.stack(frames)[..., ::-1].astype(np.float32) - mean
    return np.ascontiguousarray(bgr.transpose(0, 3, 1, 2))


class FaceDatasetTrain:
    """Per-video clip sampler for face training: `label_path/<video>/`
    holds one landmark file (68 rows "x,y") per frame, `image_path/<video>/`
    one PNG per frame, both in name order."""

    def __init__(self, label_path: str, image_path: str, mean=IMG_MEAN,
                 n_frame_total: int = 10, is_jitter: bool = True,
                 is_mirror: bool = True, img_size=(256, 256),
                 rng: Optional[_random.Random] = None):
        self.mean = np.asarray(mean, np.float32)
        self.n_frame_total = n_frame_total
        self.is_jitter = is_jitter
        self.is_mirror = is_mirror
        self.img_size = tuple(img_size)
        self.rng = rng or _random.Random()
        self.videos = []
        lbl_dirs = _listdir_sorted(label_path)
        img_dirs = _listdir_sorted(image_path)
        if len(lbl_dirs) != len(img_dirs):
            raise ValueError(f"{len(lbl_dirs)} label directories against "
                             f"{len(img_dirs)} image directories")
        for ld, vd in zip(lbl_dirs, img_dirs):
            names = _listdir_sorted(os.path.join(label_path, ld))
            imgs = [os.path.join(image_path, vd, f)
                    for f in _listdir_sorted(os.path.join(image_path, vd))]
            if len(names) != len(imgs):
                raise ValueError(f"frame count mismatch in {ld}")
            lbls = [os.path.join(label_path, ld, f) for f in names]
            self.videos.append((lbls, imgs, names))

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, index: int) -> dict:
        rng = self.rng
        lbls, imgs, names = self.videos[index % len(self.videos)]
        n = self.n_frame_total
        if len(lbls) > n:
            start = rng.choice(range(len(lbls) - n + 1))
        else:
            start = rng.choice(range(n))

        anchor_ky = np.loadtxt(lbls[start % len(lbls)], delimiter=",")
        coords, _ = face_crop_coords(anchor_ky, jitter=True, rng=rng)
        bw = max(1, (coords[1] - coords[0]) // 256)
        size = (coords[3] - coords[2], coords[1] - coords[0])   # (w, h)

        frames, labels, bboxes, out_names = [], [], [], []
        for i in range(n):
            j = (start + i) % len(lbls)
            img = crop(read_rgb(imgs[j]), coords)
            ky = shift_keypoints(np.loadtxt(lbls[j], delimiter=","), coords)
            frames.append(resize_frame(img, self.img_size))
            labels.append(resize_mask(render_face_edges(ky, size, bw=bw),
                                      self.img_size))
            bboxes.append(resize_mask(face_bbox_mask(ky, size),
                                      self.img_size))
            out_names.append(names[j])

        if self.is_jitter:
            factors = sample_jitter_factors(rng)
            frames = [apply_jitter(f, factors) for f in frames]
        if self.is_mirror and rng.random() < 0.5:
            frames = [mirror(f) for f in frames]
            labels = [mirror(lbl) for lbl in labels]
            bboxes = [mirror(bb) for bb in bboxes]

        return {
            "img": _bgr_mean_sub(frames, self.mean),
            "lbl": np.stack(labels),
            "bbox": np.stack(bboxes),
            "names": out_names,
        }


class FaceDatasetTest:
    """One subject clip and one driving clip, each a directory of
    68-landmark files (`*.txt`) beside a directory of PNG frames of the
    same names. Each clip is cropped once, from its frame 0's landmarks;
    the subject's landmarks fit a `FaceRetargeter`, and the driving
    landmarks are retargeted onto them, then smoothed over 5 frames.
    `ds[0]` is {"src": clip, "tar": clip}, each clip as a training sample
    (`img`, `lbl`, `bbox`, `names`: the image files' names)."""

    def __init__(self, sub_images_path, sub_labels_path, dri_images_path,
                 dri_labels_path, mean=IMG_MEAN, img_size=(256, 256),
                 max_frame_num: Optional[int] = None,
                 image_ext: str = ".png"):
        if image_ext != ".png":
            raise ValueError(
                f"image_ext {image_ext!r}: the port reads .png frames only; "
                "the JPEG decoder comes with the port of the pose variant")
        self.paths = (sub_images_path, sub_labels_path,
                      dri_images_path, dri_labels_path)
        self.mean = np.asarray(mean, np.float32)
        self.img_size = tuple(img_size)
        self.max_frame_num = max_frame_num
        self.image_ext = image_ext

    def __len__(self):
        return 1

    def _load_clip(self, images_path, labels_path, retargeter, is_ref):
        ky_names = _listdir_sorted(labels_path)
        if self.max_frame_num is not None:
            ky_names = ky_names[:self.max_frame_num]
        kys = [np.loadtxt(os.path.join(labels_path, n), delimiter=",")
               for n in ky_names]
        coords, _ = face_crop_coords(kys[0], jitter=False)
        bw = max(1, (coords[1] - coords[0]) // 256)
        size = (coords[3] - coords[2], coords[1] - coords[0])   # (w, h)
        kys = [shift_keypoints(k, coords) for k in kys]
        if is_ref:
            retargeter.fit_reference(kys)
        else:
            kys = list(smooth_keypoint_track(np.stack(
                retargeter.retarget(kys))))

        imgs, lbls, boxes, names = [], [], [], []
        for name, ky in zip(ky_names, kys):
            img_name = name.replace(".txt", self.image_ext)
            img = crop(read_rgb(os.path.join(images_path, img_name)), coords)
            imgs.append(resize_frame(img, self.img_size))
            lbls.append(resize_mask(render_face_edges(ky, size, bw=bw),
                                    self.img_size))
            boxes.append(resize_mask(face_bbox_mask(ky, size),
                                     self.img_size))
            names.append(img_name)
        return {"img": _bgr_mean_sub(imgs, self.mean), "lbl": np.stack(lbls),
                "bbox": np.stack(boxes), "names": names}

    def __getitem__(self, index: int) -> dict:
        sub_img, sub_lbl, dri_img, dri_lbl = self.paths
        retargeter = FaceRetargeter()
        src = self._load_clip(sub_img, sub_lbl, retargeter, is_ref=True)
        tar = self._load_clip(dri_img, dri_lbl, retargeter, is_ref=False)
        return {"src": src, "tar": tar}
