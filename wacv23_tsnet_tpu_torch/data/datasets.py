"""Face and pose datasets (counterparts of the JAX package's
`data/datasets.py`: `FaceDatasetTrain`, `FaceDatasetTest`,
`PoseDatasetTrain`, `PoseDatasetTest`), on the port's own PNG and JPEG
decoders and resizes (`data.image_io`) instead of Pillow and OpenCV.

A training sample is one clip of `n_frame_total` frames of one video:
images BGR float32 minus the mean, (T, 3, H, W); labels the face-edge
class map (T, H, W) uint8 0/1; bboxes the landmark-extent masks
(T, H, W) uint8 0/1; and the label files' names. The random draws (clip
start, crop jitter, colour jitter, mirror coin) are the JAX package's, in
its order, from the `rng` given, so one `random.Random(seed)` gives the
same clips. A test sample is a subject clip and a driving clip in the
same layout, the driving landmarks retargeted onto the subject's face.

The pose sets read dance videos: one JPEG (or PNG) frame and one
OpenPose JSON a frame, listed by a video dict ({video id: [frame file
names]}). A clip is cropped to the person (a box of 1.4-1.6x the pose
height at aspect 1/2, from its first frame), resized to 128x256 and
padded to a 256x256 square; labels are the 25 pose classes (19 with
`basic_point_only` and `remove_face_labels`).
"""

from __future__ import annotations

import json
import os
import random as _random
from typing import Optional

import numpy as np

from .augment import apply_jitter, sample_jitter_factors
from .codecs import image_to_labels
from .face import (FaceRetargeter, face_bbox_mask, face_crop_coords,
                   render_face_edges, shift_keypoints)
from .image_io import (crop, image_size, mirror, pad_square, read_rgb,
                       resize_frame, resize_mask, resize_nearest)
from .posenorm import retarget_pose, shift_pts
from .rasterize import render_openpose, render_person
from .smoothing import load_json_tricks, smooth_keypoint_track

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
    68-landmark files (`*.txt`) beside a directory of frames of the same
    names, with extension `image_ext` (PNG or JPEG). Each clip is cropped
    once, from its frame 0's landmarks; the subject's landmarks fit a
    `FaceRetargeter`, and the driving
    landmarks are retargeted onto them, then smoothed over 5 frames.
    `ds[0]` is {"src": clip, "tar": clip}, each clip as a training sample
    (`img`, `lbl`, `bbox`, `names`: the image files' names)."""

    def __init__(self, sub_images_path, sub_labels_path, dri_images_path,
                 dri_labels_path, mean=IMG_MEAN, img_size=(256, 256),
                 max_frame_num: Optional[int] = None,
                 image_ext: str = ".png"):
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


# ------------------------------------------------------------------ pose

POSE_IMG_SIZE = (128, 256)      # (w, h) before the square pad


def _person_crop_coords(pose_pts, size, train, rng, scale=None,
                        aspect_ratio=0.5):
    """Person crop box [xs, ys, xe, ye] and its scale from validated pose
    points (reference get_crop_coords): 1.4-1.6x (train, drawn from `rng`
    with a +-5% centre jitter) or 1.5x the height from the eyes to the
    ankles, aspect `aspect_ratio`, kept inside the image (w, h) = size."""
    w, h = size
    valid = pose_pts[:, 0] != 0
    x, y = pose_pts[valid, 0], pose_pts[valid, 1]
    x_cen = int(x.min() + x.max()) // 2 if x.shape[0] else w // 2
    if y.shape[0]:
        y_min = max(y.min(), min(pose_pts[15, 1], pose_pts[16, 1]))
        y_max = max(pose_pts[11, 1], pose_pts[14, 1])
        if y_max == 0:
            y_max = y.max()
        y_cen = int(y_min + y_max) // 2
        y_len = y_max - y_min
    else:
        y_cen = y_len = h // 2
    if scale is None:
        scale = rng.uniform(1.4, 1.6) if train else 1.5
    bh = int(min(h, max(h // 4, y_len * scale))) // 2
    bw = int(bh * aspect_ratio)
    if train:
        x_cen += int(rng.uniform(-0.05, 0.05) * bw)
        y_cen += int(rng.uniform(-0.05, 0.05) * bh)
    x_cen = max(bw, min(w - bw, x_cen))
    y_cen = max(bh, min(h - bh, y_cen))
    return [x_cen - bw, y_cen - bh, x_cen + bw, y_cen + bh], scale


def _pose_bbox_from_label(lbl: np.ndarray) -> np.ndarray:
    """(H, W, 3) label image -> (H, W) uint8 0/255 box over its non-zero
    pixels with a 1/16 margin (reference get_bbox_image)."""
    arr = np.sum(lbl != 0, axis=2)
    h, w = arr.shape
    mask = np.zeros((h, w), np.uint8)
    nz = np.nonzero(arr)
    if nz[0].size:
        y_min = int(max(0, nz[0].min() - h // 16))
        y_max = int(min(h, nz[0].max() + h // 16))
        x_min = int(max(0, nz[1].min() - w // 16))
        x_max = int(min(w, nz[1].max() + w // 16))
        mask[y_min:y_max, x_min:x_max] = 255
    return mask


def _pose_frame(img, lbl, coords):
    """One frame of a pose clip from the whole image and the label image
    of its crop box `coords`: the image cropped (zero outside), the
    label's bbox, then the image (bicubic) and the label and bbox
    (nearest) resized to 128x256 and padded to a square."""
    xs, ys, xe, ye = coords
    img = crop(img, [ys, ye, xs, xe])
    bbox = _pose_bbox_from_label(lbl)
    return (pad_square(resize_frame(img, POSE_IMG_SIZE)),
            pad_square(resize_nearest(lbl, POSE_IMG_SIZE)),
            pad_square(resize_nearest(bbox, POSE_IMG_SIZE)))


def _pose_arrays(frames, labels, bboxes, mean, basic_point_only,
                 remove_face_labels) -> dict:
    return {
        "img": _bgr_mean_sub(frames, mean),
        "lbl": np.stack([image_to_labels(lbl, "pose", basic_point_only,
                                         remove_face_labels)
                         for lbl in labels]),
        "bbox": np.stack([(b != 0).astype(np.uint8) for b in bboxes]),
    }


class PoseDatasetTrain:
    """Dance clip sampler for pose training: `json_path` is the video
    dict, `label_path/<%05d id>/<frame stem>_keypoints.json` the OpenPose
    output of each frame `image_path/<%05d id>/<frame>`. A clip is
    `n_frame_total` frames `interval` apart (1 apart where the video is
    too short), labels drawn with train-time brush widths; colour jitter
    and a mirror coin per clip."""

    def __init__(self, json_path, label_path, image_path, mean=IMG_MEAN,
                 n_frame_total: int = 10, is_jitter: bool = True,
                 is_mirror: bool = True, basic_point_only: bool = False,
                 remove_face_labels: bool = False, interval: int = 1,
                 rng: Optional[_random.Random] = None):
        self.mean = np.asarray(mean, np.float32)
        self.n_frame_total = n_frame_total
        self.is_jitter = is_jitter
        self.is_mirror = is_mirror
        self.basic_point_only = basic_point_only
        self.remove_face_labels = remove_face_labels
        self.interval = interval
        self.rng = rng or _random.Random()
        with open(json_path) as f:
            video_dict = json.load(f)
        self.videos = []
        for vid in sorted(int(k) for k in video_dict):
            frames = sorted(video_dict[str(vid)])
            vdir = "%05d" % vid
            self.videos.append((
                [os.path.join(label_path, vdir, f[:-4] + "_keypoints.json")
                 for f in frames],
                [os.path.join(image_path, vdir, f) for f in frames],
                ["%03d_frame_%05d" % (vid, int("".join(filter(str.isdigit,
                                                              f))))
                 for f in frames],
            ))

    def __len__(self):
        return len(self.videos)

    def _render(self, json_path, size):
        lbl, pose_pts, _ = render_openpose(
            json_path, size, train=True, rng=self.rng,
            basic_point_only=self.basic_point_only,
            remove_face_labels=self.remove_face_labels)
        return lbl, pose_pts

    def __getitem__(self, index: int) -> dict:
        rng = self.rng
        lbls, imgs, names = self.videos[index % len(self.videos)]
        n, interval = self.n_frame_total, self.interval
        if len(lbls) > (n - 1) * interval:
            start = rng.choice(range(len(lbls) - (n - 1) * interval))
        else:
            start = rng.choice(range(n))
            interval = 1

        size = image_size(imgs[start % len(imgs)])
        _, pose_pts = self._render(lbls[start % len(lbls)], size)
        coords, _ = _person_crop_coords(pose_pts, size, train=True, rng=rng)
        xs, ys, xe, ye = coords

        frames, labels, bboxes, out_names = [], [], [], []
        for i in range(n):
            j = (start + i * interval) % len(lbls)
            img = read_rgb(imgs[j])
            lbl, _ = self._render(lbls[j], img.shape[1::-1])
            f, lb, bb = _pose_frame(img, lbl[ys:ye, xs:xe], coords)
            frames.append(f)
            labels.append(lb)
            bboxes.append(bb)
            out_names.append(names[j])

        if self.is_jitter:
            factors = sample_jitter_factors(rng)
            frames = [apply_jitter(f, factors) for f in frames]
        if self.is_mirror and rng.random() < 0.5:
            frames = [mirror(f) for f in frames]
            labels = [mirror(lb) for lb in labels]
            bboxes = [mirror(bb) for bb in bboxes]

        out = _pose_arrays(frames, labels, bboxes, self.mean,
                           self.basic_point_only, self.remove_face_labels)
        out["names"] = out_names
        return out


class PoseDatasetTest:
    """Dance test pairs ("<subject id> <driving id>"): the subject clip's
    labels are drawn from its OpenPose JSONs, the driving clip's from
    the pre-smoothed keypoints `smooth_label_path/<%05d id>.json`
    (`cli.smooth_keypoints`), moved into the driving crop and, for a
    pair of different builds, retargeted (`retarget_pose`); test-time
    brush widths. `ds[i]` is {"src": clip, "tar": clip, "diff_sex": "",
    "fm" or "mf"}, each clip with the training sample's arrays and
    `names` the frame files."""

    def __init__(self, test_pairs, sub_json_path, msk_json_path, label_path,
                 smooth_label_path, image_path, mean=IMG_MEAN,
                 n_frame_total: int = 30, basic_point_only: bool = False,
                 remove_face_labels: bool = False):
        self.mean = np.asarray(mean, np.float32)
        self.n_frame_total = n_frame_total
        self.basic_point_only = basic_point_only
        self.remove_face_labels = remove_face_labels
        self.img_pth = image_path
        self.lbl_pth = label_path
        self.smooth_lbl_pth = smooth_label_path
        video_dict = {}
        for p in (sub_json_path, msk_json_path):
            with open(p) as f:
                video_dict.update(json.load(f))
        self.video_dict = video_dict
        self.pairs = test_pairs

    def __len__(self):
        return len(self.pairs)

    @staticmethod
    def _is_female(vid: int) -> bool:
        """The dataset's convention (reference dataset_video_pose.py)."""
        return vid <= 91 or vid in (147, 151)

    def _clip(self, frames, labels, bboxes, names) -> dict:
        out = _pose_arrays(frames, labels, bboxes, self.mean,
                           self.basic_point_only, self.remove_face_labels)
        out["names"] = names
        return out

    def __getitem__(self, index: int) -> dict:
        vid1, vid2 = self.pairs[index].split(" ")
        f1, f2 = self._is_female(int(vid1)), self._is_female(int(vid2))
        diff_sex = "" if f1 == f2 else ("fm" if f1 else "mf")

        # the subject clip, labels from its OpenPose JSONs
        parts = ([], [], [], [])
        coords = scale = None
        for frame in sorted(self.video_dict[vid1][:self.n_frame_total]):
            img = read_rgb(os.path.join(self.img_pth, "%05d" % int(vid1),
                                        frame))
            size = img.shape[1::-1]
            lbl, pose_pts, _ = render_openpose(
                os.path.join(self.lbl_pth, "%05d" % int(vid1),
                             frame[:-4] + "_keypoints.json"),
                size, train=False, basic_point_only=self.basic_point_only,
                remove_face_labels=self.remove_face_labels)
            if coords is None:
                coords, scale = _person_crop_coords(pose_pts, size,
                                                    train=False, rng=None)
            xs, ys, xe, ye = coords
            for acc, v in zip(parts, _pose_frame(
                    img, lbl[ys:ye, xs:xe], coords) + (frame,)):
                acc.append(v)
        src = self._clip(*parts)

        # the driving clip: pre-smoothed keypoints, retargeted
        smooth = load_json_tricks(os.path.join(
            self.smooth_lbl_pth, "%05d.json" % int(vid2)))
        tar_frames = sorted(self.video_dict[vid2][:self.n_frame_total])
        parts = ([], [], [], [])
        tcoords = None
        for i, frame in enumerate(
                tar_frames[:len(smooth["pose_keypoints_2d"])]):
            img = read_rgb(os.path.join(self.img_pth, "%05d" % int(vid2),
                                        frame))
            pts = {
                "pose": np.asarray(smooth["pose_keypoints_2d"][i]),
                "face": np.asarray(smooth["face_keypoints_2d"][i]),
                "hand_l": np.asarray(smooth["hand_left_keypoints_2d"][i]),
                "hand_r": np.asarray(smooth["hand_right_keypoints_2d"][i]),
            }
            if tcoords is None:
                tcoords, _ = _person_crop_coords(
                    pts["pose"], img.shape[1::-1], train=False, rng=None,
                    scale=scale)
            xs, ys, xe, ye = tcoords
            local = shift_pts(pts, (xs, ys))
            if diff_sex:
                local = retarget_pose(local, image_h=ye - ys, mode=diff_sex)
            lbl = render_person(
                local["pose"], local["face"], local["hand_l"],
                local["hand_r"], (xe - xs, ye - ys), train=False,
                basic_point_only=self.basic_point_only,
                remove_face_labels=self.remove_face_labels)
            for acc, v in zip(parts, _pose_frame(img, lbl, tcoords)
                              + (frame,)):
                acc.append(v)
        return {"src": src, "tar": self._clip(*parts), "diff_sex": diff_sex}
