"""A synthetic dance set for the pose tests (not a test module).

`write_dance_set(root)` writes what the pose datasets and CLIs read:

- `images/<%05d id>/frame%06d.jpg`: JPEG frames written by Pillow
  (ramps, a filled figure, Gaussian noise of sigma 8);
- `labels/<%05d id>/frame%06d_keypoints.json`: OpenPose output of a
  moving figure with face and hands; video `TWO_PEOPLE` has a second,
  smaller person, video `LOW_CONF` some points below the detection
  thresholds (a finger, a face segment, a knee);
- `clean_video_dict.json` (the subject videos) and
  `clean_unseen_video_dict.json` (the others).

Video ids lie on both sides of the datasets' female rule (id <= 91, or
147 or 151), so that pairs of the same and of different builds exist.
"""

import json
import os

import numpy as np
from PIL import Image

FRAME_WH = (288, 512)
SUBJECTS = (5, 120)          # female, male
UNSEEN = (147, 130)          # female, male
TWO_PEOPLE = 120
LOW_CONF = 147


def person(cx, cy, scale, t, conf=0.9):
    """OpenPose keypoint lists of a standing figure whose arms and legs
    swing with phase t."""
    sw = 0.15 * np.sin(t)

    def pt(dx, dy):
        return [cx + dx * scale, cy + dy * scale, conf]

    layout = {0: (0, -1.6), 1: (0, -1.2), 2: (-0.4, -1.2),
              3: (-0.5 - sw, -0.6), 4: (-0.55 - 2 * sw, 0.0),
              5: (0.4, -1.2), 6: (0.5 + sw, -0.6), 7: (0.55 + 2 * sw, 0.0),
              8: (0, 0.0), 9: (-0.2, 0.0), 10: (-0.25 + sw, 0.8),
              11: (-0.25 + sw, 1.6), 12: (0.2, 0.0), 13: (0.25 - sw, 0.8),
              14: (0.25 - sw, 1.6), 15: (-0.1, -1.7), 16: (0.1, -1.7),
              17: (-0.2, -1.65), 18: (0.2, -1.65), 19: (0.3 - sw, 1.7),
              20: (0.35 - sw, 1.7), 21: (0.2 - sw, 1.72),
              22: (-0.3 + sw, 1.7), 23: (-0.35 + sw, 1.7),
              24: (-0.2 + sw, 1.72)}
    pose = [pt(*layout[k]) for k in range(25)]
    ang = np.linspace(0, 2 * np.pi, 70, endpoint=False)
    face = [pt(0.12 * np.cos(a), -1.6 + 0.14 * np.sin(a) + 0.01 * (i % 3))
            for i, a in enumerate(ang)]

    def hand(wx, wy, side):
        pts = [pt(wx, wy)]
        for f in range(5):
            for j in range(1, 5):
                pts.append(pt(wx + side * (0.02 * f - 0.04) + 0.01 * j * side,
                              wy + 0.03 * j + 0.005 * f))
        return pts

    return {
        "pose_keypoints_2d": sum(pose, []),
        "face_keypoints_2d": sum(face, []),
        "hand_left_keypoints_2d": sum(hand(*layout[7], 1), []),
        "hand_right_keypoints_2d": sum(hand(*layout[4], -1), []),
    }


def _frame(rng, f, vid):
    w, h = FRAME_WH
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([xx * 200 // w + 20 + f, yy * 150 // h + vid % 50,
                    (xx + yy) * 100 // (w + h) + 40], axis=-1).astype(float)
    img[h // 5:4 * h // 5, w // 3:2 * w // 3] = (60, 90, 150)
    img += rng.normal(0, 8, (h, w, 1))
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def write_dance_set(root, n_frames=8, quality=75, seed=0):
    """Write the set under `root` (see the module docstring)."""
    rng = np.random.default_rng(seed)
    dicts = {"clean_video_dict.json": {}, "clean_unseen_video_dict.json": {}}
    for vid in SUBJECTS + UNSEEN:
        vdir = "%05d" % vid
        os.makedirs(os.path.join(root, "images", vdir))
        os.makedirs(os.path.join(root, "labels", vdir))
        frames = []
        scale = 95.0 if vid in (5, 147) else 110.0
        for f in range(n_frames):
            name = f"frame{f:06d}.jpg"
            frames.append(name)
            Image.fromarray(_frame(rng, f, vid)).save(
                os.path.join(root, "images", vdir, name), "JPEG",
                quality=quality)
            people = [person(140 + 3 * f + vid % 7, 260 - f, scale, 0.7 * f)]
            if vid == TWO_PEOPLE:
                people.append(person(60, 300, 40.0, f))
            if vid == LOW_CONF:
                p = people[0]
                p["hand_left_keypoints_2d"][3 * 6 + 2] = 0.005   # a finger
                p["face_keypoints_2d"][3 * 40 + 2] = 0.05        # a segment
                p["pose_keypoints_2d"][3 * 13 + 2] = 0.0         # a knee
            with open(os.path.join(root, "labels", vdir,
                                   f"frame{f:06d}_keypoints.json"), "w") as fh:
                json.dump({"version": 1.3, "people": people}, fh)
        key = ("clean_video_dict.json" if vid in SUBJECTS
               else "clean_unseen_video_dict.json")
        dicts[key][str(vid)] = frames
    for name, d in dicts.items():
        with open(os.path.join(root, name), "w") as fh:
            json.dump(d, fh)
    return root
