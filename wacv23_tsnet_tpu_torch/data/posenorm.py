"""Cross-build skeleton retargeting of pose test pairs (the port's copy
of the JAX package's `data/posenorm.py`; reference
utils/keypoint2img_posenorm.py `read_pts_posenorm`).

When the subject and the driving dancer differ in build ("fm": a female
driving a male subject, "mf": the reverse), the driving skeleton is
rescaled limb by limb before it is rasterized:

- the shoulders scale about the neck (x0.9 fm, x1.2 mf);
- the torso vector neck->hip scales by 0.85 / 1.2;
- the arm and knee chains translate to follow their re-anchored parents;
- the ankle edges stretch by the ratio of the image height left below
  the new and the old knee, keeping the feet on the ground;
- the hand roots snap to the new wrists (left -> pose 7, right -> pose
  4) and the finger chains translate along.

Keypoints are dicts of validated (K, 2) arrays (zeros: not detected), as
`rasterize.valid_keypoints` gives them.
"""

from __future__ import annotations

import numpy as np

from .rasterize import HAND_FINGERS, pose_edge_colors

# scale factors per gender pair (reference :105-108,117-121)
_TORSO_SCALE = {"fm": 0.85, "mf": 1.2}
_SHOULDER_SCALE = {"fm": 0.9, "mf": 1.2}

# wrist pose-point for each hand key (reference hand_dict :89)
_WRIST = {"hand_l": 7, "hand_r": 4}


def _edge_lengths(pts: np.ndarray, edges) -> np.ndarray:
    out = np.zeros(len(edges))
    for i, (a, b) in enumerate(edges):
        if 0 in pts[a] or 0 in pts[b]:
            continue
        out[i] = np.linalg.norm(pts[a] - pts[b])
    return out


def _hand_edges():
    return [(f[i], f[i + 1]) for f in HAND_FINGERS
            for i in range(len(f) - 1)]


def shift_pts(pts: dict, origin_xy) -> dict:
    """Shift all valid keypoints into crop-local coordinates."""
    shift = np.asarray(origin_xy, np.float64)
    out = {}
    for key, arr in pts.items():
        arr = np.array(arr, np.float64, copy=True)
        valid = ~np.any(arr == 0, axis=1)
        arr[valid] -= shift
        out[key] = arr
    return out


def retarget_pose(pts: dict, image_h: int, mode: str) -> dict:
    """Apply the gender-pair body retarget; `mode` in {"fm", "mf"}."""
    edges, _ = pose_edge_colors(basic_point_only=False)
    edges = [list(e) for e in edges]
    pose = np.array(pts["pose"], np.float64, copy=True)
    new_pose = pose.copy()
    lengths = _edge_lengths(pose, edges)
    torso_len = lengths[5]                      # edge (1, 8)
    new_torso_len = torso_len * _TORSO_SCALE[mode]

    # shoulders about the neck
    for i in (2, 5):
        if 0 in pose[i]:
            continue
        new_pose[i] = new_pose[1] + (pose[i] - pose[1]) * _SHOULDER_SCALE[mode]

    def chain_translate(inner, outer, points, new_points, chain_edges,
                        chain_lengths):
        for anchor in inner:
            for point in outer:
                if [anchor, point] in chain_edges:
                    edge = [anchor, point]
                elif [point, anchor] in chain_edges:
                    edge = [point, anchor]
                else:
                    continue
                if chain_lengths[chain_edges.index(edge)]:
                    new_points[point] = (new_points[anchor]
                                         + points[point] - points[anchor])

    # arms: elbows follow shoulders, wrists follow elbows
    chain_translate([2, 5], [3, 6], pose, new_pose, edges, lengths)
    chain_translate([3, 6], [4, 7], pose, new_pose, edges, lengths)

    # torso: hip re-anchored along the old neck->hip direction
    if torso_len:
        new_pose[8] = pose[1] + new_torso_len * (pose[8] - pose[1]) / torso_len
    # knees follow the hip
    for i in (9, 12):
        new_pose[i] = new_pose[8] + pose[i] - pose[8]
    # ankles: stretch by remaining-height ratio below the knee
    for anchor, point in ((9, 10), (12, 13)):
        edge = [anchor, point]
        if edge not in edges or not lengths[edges.index(edge)]:
            continue
        ln = lengths[edges.index(edge)]
        denom = image_h - pose[anchor][1]
        if denom == 0:
            continue
        new_len = (image_h - new_pose[anchor][1]) * (ln / denom)
        new_pose[point] = new_pose[anchor] + new_len * (
            (pose[point] - pose[anchor]) / ln)

    out = {k: np.array(v, np.float64, copy=True) for k, v in pts.items()}
    out["pose"] = new_pose

    # hands: root to the new wrist, fingers translate joint-by-joint
    hedges = [list(e) for e in _hand_edges()]
    rings = [[0], [1, 5, 9, 13, 17], [2, 6, 10, 14, 18], [3, 7, 11, 15, 19],
             [4, 8, 12, 16, 20]]
    for key in ("hand_l", "hand_r"):
        if key not in pts:
            continue
        hand = np.array(pts[key], np.float64, copy=True)
        hlengths = _edge_lengths(hand, hedges)
        new_hand = hand.copy()
        new_hand[0] = new_pose[_WRIST[key]]
        for j in range(len(rings) - 1):
            chain_translate(rings[j], rings[j + 1], hand, new_hand, hedges,
                            hlengths)
        out[key] = new_hand
    return out
