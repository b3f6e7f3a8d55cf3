"""Offline keypoint smoothing with the port: raw OpenPose JSONs ->
smooth_openpose/<%05d id>.json (counterpart of the JAX package's
`cli/smooth_keypoints.py`, writing the same files byte for byte).

The pose test set reads its driving keypoints pre-smoothed: each video's
first `--n-frame-total` frames (in name order), first person, validated,
each of the pose / face / hand tracks smoothed by the validity-aware
5-frame average (`data.smoothing.smooth_valid_track`), stored with the
json_tricks ndarray encoding (`data.smoothing.load_json_tricks` reads it).

    python -m wacv23_tsnet_tpu_torch.cli.smooth_keypoints \\
        --video-dict clean_unseen_video_dict.json \\
        --label-dir openpose/ --out-dir smooth_openpose/
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data.rasterize import parse_openpose_json, valid_keypoints
from ..data.smoothing import smooth_valid_track

_KEYMAP = {
    "pose": "pose_keypoints_2d",
    "face": "face_keypoints_2d",
    "hand_l": "hand_left_keypoints_2d",
    "hand_r": "hand_right_keypoints_2d",
}


def _encode_ndarray(arr: np.ndarray) -> dict:
    return {"__ndarray__": arr.tolist(), "dtype": str(arr.dtype),
            "shape": list(arr.shape), "Corder": True}


def smooth_video(label_dir: str, frames: list[str],
                 n_frame_total: int = 30) -> dict:
    """One video's smoothed tracks as the json_tricks payload, and the
    frames' names under "name"."""
    frames = sorted(frames)[:n_frame_total]
    tracks = {k: [] for k in _KEYMAP}
    names = []
    for frame in frames:
        jpth = os.path.join(label_dir, frame[:-4] + "_keypoints.json")
        person = parse_openpose_json(jpth)[0]
        for k in _KEYMAP:
            tracks[k].append(valid_keypoints(person[k]))
        names.append(os.path.basename(jpth).split("_")[0])
    out = {}
    for k, frames_k in tracks.items():
        out[_KEYMAP[k]] = _encode_ndarray(
            smooth_valid_track(np.stack(frames_k)))
    out["name"] = names
    return out


def main(argv=None) -> list[str]:
    """Parse `argv` and smooth every video of the dict; returns the paths
    written."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--video-dict", required=True)
    p.add_argument("--label-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--n-frame-total", type=int, default=30)
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    with open(args.video_dict) as f:
        video_dict = json.load(f)
    written = []
    for vid, frames in video_dict.items():
        payload = smooth_video(
            os.path.join(args.label_dir, "%05d" % int(vid)),
            frames, args.n_frame_total)
        out_path = os.path.join(args.out_dir, "%05d.json" % int(vid))
        with open(out_path, "w") as f:
            json.dump(payload, f)
        print(f"wrote {out_path}")
        written.append(out_path)
    return written


if __name__ == "__main__":
    main()
