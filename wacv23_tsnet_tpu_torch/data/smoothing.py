"""Temporal keypoint smoothing (the port's own copy of the JAX package's
`data/smoothing.py`):

- `smooth_keypoint_track`: the face test set's 5-frame moving average
  with the reference's asymmetric boundary scheme (reference
  dataset_video_face.py:357-379);
- `smooth_valid_track` / `smooth_openpose_people`: the validity-aware
  variant for OpenPose tracks, averaging only the frames where a point
  was detected (reference dataset/smooth_pose_keypoint.py:86-160);
- `load_json_tricks`: reads the smoothed files that smoother writes
  (`cli.smooth_keypoints`).
"""

from __future__ import annotations

import json

import numpy as np


def load_json_tricks(path: str) -> dict:
    """Read a json_tricks-encoded file: every {"__ndarray__": list,
    "dtype": ...} object becomes a numpy array of that dtype."""

    def decode(obj):
        if isinstance(obj, dict):
            if "__ndarray__" in obj:
                return np.asarray(obj["__ndarray__"],
                                  dtype=obj.get("dtype", "float64"))
            return {k: decode(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [decode(v) for v in obj]
        return obj

    with open(path) as f:
        return decode(json.load(f))


def smooth_keypoint_track(track: np.ndarray, win: int = 5) -> np.ndarray:
    """(T, K, 2) -> smoothed (T, K, 2) float64.

    Frame 0 unchanged; frame 1 the mean of frames 0..2; frame 2 of 0..4;
    the interior a centred 5-frame mean; frame T-2 the mean of the last
    3; frame T-1 unchanged. Below 5 frames the track is returned as is
    (the reference's scheme would index past its end).
    """
    if win != 5:
        raise ValueError("the reference hard-codes a 5-frame window")
    track = np.asarray(track, np.float64)
    t = track.shape[0]
    if t < 5:
        return track.copy()
    cs = np.cumsum(track, axis=0)
    out = np.empty_like(track)
    out[0] = track[0]
    out[1] = cs[2] / 3
    out[2] = cs[4] / 5
    out[3:t - 2] = (cs[5:t] - cs[0:t - 5]) / 5
    out[t - 2] = (cs[t - 1] - cs[t - 4]) / 3
    out[t - 1] = track[t - 1]
    return out


def smooth_valid_track(track: np.ndarray) -> np.ndarray:
    """Validity-aware smoother of a (T, K, 2) validated keypoint track.

    A point is valid where neither coordinate is 0. Window sums are
    divided by the number of valid samples in the window (a window with
    none keeps the original point), with `smooth_keypoint_track`'s
    boundary scheme. Invalid frames keep their window averages: the
    reference's reset of invalid points (smooth_pose_keypoint.py:113-114)
    indexes with a comparison of a Python list to 0, an empty selection,
    so it never resets, and the models downstream were trained on that.
    Below 5 frames the track is returned as is.
    """
    track = np.asarray(track, np.float64)
    t, k, _ = track.shape
    if t < 5:
        return track.copy()
    out = np.zeros_like(track)
    for ki in range(k):
        seq = track[:, ki, :]
        cs = np.cumsum(seq, axis=0)
        valid = np.array([0 not in p for p in seq], dtype=np.int64)
        vcs = np.cumsum(valid)
        new = np.zeros_like(seq)
        new[0] = seq[0]
        new[1] = cs[2] / vcs[2] if vcs[2] else seq[1]
        new[2] = cs[4] / vcs[4] if vcs[4] else seq[2]
        for j in range(3, t - 2):
            n = vcs[j + 2] - vcs[j - 3]
            new[j] = (cs[j + 2] - cs[j - 3]) / n if n else seq[j]
        n = vcs[t - 1] - vcs[t - 4]
        new[t - 2] = (cs[t - 1] - cs[t - 4]) / n if n else seq[t - 2]
        new[t - 1] = seq[t - 1]
        out[:, ki, :] = new
    return out


def smooth_openpose_people(frames: list[dict]) -> list[dict]:
    """Smooth each of the validated pose / face / hand tracks of a clip:
    `frames` is one dict of (K, 2) arrays a frame; returns new dicts."""
    keys = [k for k in ("pose", "face", "hand_l", "hand_r")
            if k in frames[0]]
    smoothed = {k: smooth_valid_track(np.stack([f[k] for f in frames]))
                for k in keys}
    return [{k: smoothed[k][i] for k in keys} for i in range(len(frames))]
