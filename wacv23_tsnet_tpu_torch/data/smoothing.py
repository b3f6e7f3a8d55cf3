"""Temporal smoothing of a face keypoint track (the port's own copy of
the face half of the JAX package's `data/smoothing.py`): the face test
set's 5-frame moving average with the reference's asymmetric boundary
scheme (reference dataset_video_face.py:357-379)."""

from __future__ import annotations

import numpy as np


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
