"""The port's pose data pipeline against the JAX package (CPU): the label
codecs, the OpenPose rasterizer, skeleton retargeting, the validity-aware
smoother, the crop and bbox rules, `PoseDatasetTrain` / `PoseDatasetTest`
and the on-device pose rasterizer.

The dance set (tests/torch_pose_dance.py) has JPEG frames written by
Pillow, which the JAX datasets read through Pillow and the port through
its own decoder. The JAX package's `draw_edge` is pinned to its numpy
tier, as in tests/test_torch_data.py: its native C++ path rounds by its
build flags. `pytest -s` prints the measured agreement.
"""

import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_pose_dance import LOW_CONF, TWO_PEOPLE, person, write_dance_set
from wacv23_tsnet_tpu.data import codecs as j_codecs
from wacv23_tsnet_tpu.data import datasets as j_ds
from wacv23_tsnet_tpu.data import posenorm as j_posenorm
from wacv23_tsnet_tpu.data import rasterize as j_ras
from wacv23_tsnet_tpu.data import rasterize_jax as j_rj
from wacv23_tsnet_tpu.data import smoothing as j_smooth
from wacv23_tsnet_tpu_torch.data import codecs, datasets, posenorm
from wacv23_tsnet_tpu_torch.data import rasterize, rasterize_device, smoothing
from wacv23_tsnet_tpu_torch.data.loader import Loader

torch.set_num_threads(2)


def _report(**values):
    name = os.environ.get("PYTEST_CURRENT_TEST", "").split()[0]
    print(f"[pose_data] {name}: " + " ".join(f"{k}={v}" for k, v in
                                             values.items()))


def _jax_numpy_draw_edge(img, x, y, bw=1, color=(255, 255, 255),
                         endpoints=False):
    cx, cy = j_ras.interp_curve(x, y)
    j_ras.stamp_edge(img, cx, cy, bw=bw, color=color, endpoints=endpoints)


@pytest.fixture
def jax_numpy_tier(monkeypatch):
    monkeypatch.setattr(j_ras, "draw_edge", _jax_numpy_draw_edge)
    monkeypatch.setenv("TSNET_NATIVE", "0")


@pytest.fixture(scope="module")
def dance(tmp_path_factory):
    return str(write_dance_set(str(tmp_path_factory.mktemp("dance"))))


def _json(dance, vid, f):
    return os.path.join(dance, "labels", "%05d" % vid,
                        f"frame{f:06d}_keypoints.json")


def _people(rng, n=2):
    """OpenPose payload text of n people with random confidences."""
    people = []
    for i in range(n):
        p = person(100 + 50 * i, 250, 90.0 - 30 * i, i)
        for key in p:
            arr = np.asarray(p[key]).reshape(-1, 3)
            arr[:, 2] = rng.choice([0.0, 0.005, 0.05, 0.5], arr.shape[0],
                                   p=[0.1, 0.1, 0.1, 0.7])
            p[key] = arr.reshape(-1).tolist()
        people.append(p)
    return json.dumps({"people": people})


# ---------------------------------------------------------------- codecs

@pytest.mark.parametrize("basic,remove", [(False, False), (True, True),
                                          (True, False)])
def test_codecs_match_jax(basic, remove):
    rng = np.random.default_rng(1)
    lbl = rng.integers(0, 25, (2, 19, 23)).astype(np.uint8)
    img = codecs.labels_to_image(lbl, "pose", basic, remove)
    np.testing.assert_array_equal(
        img, j_codecs.labels_to_image(lbl, "pose", basic, remove))
    back = codecs.image_to_labels(img.reshape(-1, 23, 3), "pose")
    np.testing.assert_array_equal(back, j_codecs.image_to_labels(
        img.reshape(-1, 23, 3), "pose"))
    n = 19 if basic and remove else 25
    np.testing.assert_array_equal(back.reshape(lbl.shape),
                                  np.minimum(lbl, n - 1))
    np.testing.assert_array_equal(
        codecs.labels_to_onehot(lbl, "pose", basic, remove),
        j_codecs.labels_to_onehot(lbl, "pose", basic, remove))
    np.testing.assert_array_equal(codecs.POSE_PALETTE, j_codecs.POSE_PALETTE)
    face = (lbl % 2).astype(np.uint8)
    for fn in ("labels_to_image", "labels_to_onehot"):
        np.testing.assert_array_equal(getattr(codecs, fn)(face, "face"),
                                      getattr(j_codecs, fn)(face, "face"))


# ----------------------------------------------------- OpenPose rasterizer

def test_skeleton_tables_match_jax():
    for name in ("POSE_EDGES_BASIC", "POSE_EDGES_FEET", "HAND_FINGERS",
                 "HAND_COLORS", "FACE_SEGMENTS"):
        assert getattr(rasterize, name) == getattr(j_ras, name), name
    for basic in (False, True):
        assert rasterize.pose_edge_colors(basic) == j_ras.pose_edge_colors(
            basic)
    for flags in ((False, False), (True, False), (False, True)):
        for got, want in zip(rasterize_device._build_edge_table(*flags),
                             j_rj._build_edge_table(*flags)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [25, 70, 21])
def test_valid_keypoints_matches_jax(n):
    rng = np.random.default_rng(n)
    pts = np.concatenate([rng.uniform(0, 300, (n, 2)),
                          rng.choice([0.0, 0.005, 0.05, 0.2, 0.9], (n, 1))],
                         axis=1)
    np.testing.assert_array_equal(rasterize.valid_keypoints(pts),
                                  j_ras.valid_keypoints(pts))


def test_parse_openpose_json_matches_jax(dance, tmp_path):
    text = _people(np.random.default_rng(2))
    path = tmp_path / "kp.json"
    path.write_text(text)
    for source in (text, str(path), _json(dance, TWO_PEOPLE, 3)):
        got = rasterize.parse_openpose_json(source)
        want = j_ras.parse_openpose_json(source)
        assert len(got) == len(want) >= 1
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for key in g:
                np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("basic,remove", [(False, False), (True, False),
                                          (False, True)])
@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_render_person_matches_jax(train, basic, remove, jax_numpy_tier):
    p = j_ras.parse_openpose_json(_people(np.random.default_rng(3), 1))[0]
    pts = {k: j_ras.valid_keypoints(v) for k, v in p.items()}
    args = (pts["pose"], pts["face"], pts["hand_l"], pts["hand_r"],
            (288, 512), train)
    rng_p, rng_j = random.Random(7), random.Random(7)
    got = rasterize.render_person(*args, rng=rng_p, basic_point_only=basic,
                                  remove_face_labels=remove)
    want = j_ras.render_person(*args, rng=rng_j, basic_point_only=basic,
                               remove_face_labels=remove)
    np.testing.assert_array_equal(got, want)
    assert rng_p.getstate() == rng_j.getstate()
    assert got.any()


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_render_openpose_matches_jax(dance, train, jax_numpy_tier):
    sources = [_json(dance, vid, 2) for vid in (5, TWO_PEOPLE, LOW_CONF)]
    sources.append(_people(np.random.default_rng(4), 3))
    sources.append(json.dumps({"people": []}))
    for source in sources:
        rng_p, rng_j = random.Random(11), random.Random(11)
        got = rasterize.render_openpose(source, (288, 512), train=train,
                                        rng=rng_p)
        want = j_ras.render_openpose(source, (288, 512), train=train,
                                     rng=rng_j)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert rng_p.getstate() == rng_j.getstate()


# ------------------------------------------------- retargeting, smoothing

@pytest.mark.parametrize("mode", ["fm", "mf"])
def test_retarget_pose_matches_jax(dance, mode):
    p = j_ras.parse_openpose_json(_json(dance, LOW_CONF, 1))[0]
    pts = {k: j_ras.valid_keypoints(v) for k, v in p.items()}
    got = posenorm.shift_pts(pts, (30, 40))
    want = j_posenorm.shift_pts(pts, (30, 40))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    got = posenorm.retarget_pose(got, image_h=400, mode=mode)
    want = j_posenorm.retarget_pose(want, image_h=400, mode=mode)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert not np.array_equal(got["pose"], pts["pose"])


@pytest.mark.parametrize("t", [3, 5, 12])
def test_smooth_valid_track_matches_jax(t):
    rng = np.random.default_rng(t)
    track = rng.uniform(1, 200, (t, 25, 2))
    track[rng.random((t, 25)) < 0.2] = 0.0        # undetected points
    track[:, 3] = 0.0                             # never detected
    got = smoothing.smooth_valid_track(track)
    np.testing.assert_array_equal(got, j_smooth.smooth_valid_track(track))
    frames = [{"pose": track[i], "face": track[i, :20]} for i in range(t)]
    for g, w in zip(smoothing.smooth_openpose_people(frames),
                    j_smooth.smooth_openpose_people(frames)):
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_array_equal(g[key], w[key])


def test_load_json_tricks_matches_jax(tmp_path):
    arr = np.random.default_rng(0).random((3, 4, 2))
    payload = {"a": {"__ndarray__": arr.tolist(), "dtype": "float64",
                     "shape": [3, 4, 2], "Corder": True},
               "b": [{"__ndarray__": [1, 2], "dtype": "int32"}, "x"],
               "name": ["f1", "f2"]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(payload))
    got = smoothing.load_json_tricks(str(path))
    want = j_smooth.load_json_tricks(str(path))
    np.testing.assert_array_equal(got["a"], want["a"])
    assert got["b"][0].dtype == want["b"][0].dtype == np.int32
    assert got["b"][1] == "x" and got["name"] == want["name"]


# ------------------------------------------------------ crops and boxes

@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_person_crop_coords_matches_jax(dance, train):
    cases = [j_ras.render_openpose(_json(dance, vid, f), (288, 512))[1]
             for vid in (5, TWO_PEOPLE, LOW_CONF) for f in (0, 5)]
    cases += [np.zeros((25, 2)), np.zeros((25, 3))]
    for pose_pts in cases:
        for scale in (None, 1.5):
            rng_p, rng_j = random.Random(5), random.Random(5)
            got = datasets._person_crop_coords(pose_pts, (288, 512), train,
                                               rng_p, scale)
            want = j_ds._person_crop_coords(pose_pts, (288, 512), train,
                                            rng_j, scale)
            assert got == want
            assert rng_p.getstate() == rng_j.getstate()


def test_pose_bbox_from_label_matches_jax():
    from PIL import Image
    rng = np.random.default_rng(6)
    for h, w in ((256, 128), (37, 91)):
        lbl = np.zeros((h, w, 3), np.uint8)
        lbl[h // 3:h // 2, w // 4:w // 2] = rng.integers(0, 255, 3)
        want = np.asarray(j_ds._pose_bbox_from_label(Image.fromarray(lbl)))
        np.testing.assert_array_equal(datasets._pose_bbox_from_label(lbl),
                                      want)
    empty = np.zeros((8, 8, 3), np.uint8)
    assert not datasets._pose_bbox_from_label(empty).any()


# ------------------------------------------------------------ datasets

def _assert_sample_equal(got, want, n):
    assert got["img"].shape == (n, 3, 256, 256)
    assert got["img"].dtype == want["img"].dtype == np.float32
    assert got["lbl"].dtype == want["lbl"].dtype == np.uint8
    for key in ("img", "lbl", "bbox"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["names"] == want["names"]


@pytest.mark.parametrize("seed,index,interval", [(0, 0, 2), (3, 1, 2),
                                                 (5, 2, 4), (9, 3, 1)])
def test_pose_dataset_train_matches_jax(dance, jax_numpy_tier, seed, index,
                                        interval):
    kw = dict(json_path=os.path.join(dance, "clean_unseen_video_dict.json"),
              label_path=os.path.join(dance, "labels"),
              image_path=os.path.join(dance, "images"), n_frame_total=4,
              is_jitter=True, is_mirror=True, interval=interval)
    ds = datasets.PoseDatasetTrain(rng=random.Random(seed), **kw)
    jds = j_ds.PoseDatasetTrain(rng=random.Random(seed), **kw)
    assert len(ds) == len(jds) == 2
    got, want = ds[index], jds[index]
    _assert_sample_equal(got, want, 4)
    assert ds.rng.getstate() == jds.rng.getstate()
    assert got["lbl"].max() <= 24 and got["lbl"].any() and got["bbox"].any()
    # the square pad: nothing in the outer quarter columns
    assert not got["lbl"][:, :, :64].any()


def test_pose_dataset_train_label_subsets(dance, jax_numpy_tier):
    kw = dict(json_path=os.path.join(dance, "clean_video_dict.json"),
              label_path=os.path.join(dance, "labels"),
              image_path=os.path.join(dance, "images"), n_frame_total=3,
              basic_point_only=True, remove_face_labels=True, interval=1)
    got = datasets.PoseDatasetTrain(rng=random.Random(2), **kw)[1]
    want = j_ds.PoseDatasetTrain(rng=random.Random(2), **kw)[1]
    _assert_sample_equal(got, want, 3)
    assert got["lbl"].max() <= 18


@pytest.mark.parametrize("pair,diff_sex", [("5 147", ""), ("5 130", "fm"),
                                           ("120 147", "mf")])
def test_pose_dataset_test_matches_jax(dance, jax_numpy_tier, tmp_path, pair,
                                       diff_sex):
    from wacv23_tsnet_tpu_torch.cli import smooth_keypoints
    smooth = str(tmp_path / "smooth_openpose")
    smooth_keypoints.main(["--video-dict", os.path.join(
        dance, "clean_unseen_video_dict.json"), "--label-dir",
        os.path.join(dance, "labels"), "--out-dir", smooth])
    kw = dict(test_pairs=[pair],
              sub_json_path=os.path.join(dance, "clean_video_dict.json"),
              msk_json_path=os.path.join(dance,
                                         "clean_unseen_video_dict.json"),
              label_path=os.path.join(dance, "labels"),
              smooth_label_path=smooth,
              image_path=os.path.join(dance, "images"), n_frame_total=6)
    got = datasets.PoseDatasetTest(**kw)[0]
    want = j_ds.PoseDatasetTest(**kw)[0]
    assert got["diff_sex"] == want["diff_sex"] == diff_sex
    for part in ("src", "tar"):
        _assert_sample_equal(got[part], want[part], 6)
    assert got["tar"]["lbl"].any()


def test_pose_loader_batch(dance):
    ds = datasets.PoseDatasetTrain(
        json_path=os.path.join(dance, "clean_video_dict.json"),
        label_path=os.path.join(dance, "labels"),
        image_path=os.path.join(dance, "images"), n_frame_total=3,
        interval=2, rng=random.Random(4))
    with Loader(ds, batch_size=2, num_workers=2, seed=0) as loader:
        batch = next(iter(loader))
    assert batch["img"].shape == (2, 3, 3, 256, 256)
    assert batch["lbl"].shape == (2, 3, 256, 256)
    assert batch["bbox"].dtype == np.uint8 and len(batch["names"]) == 2
    # the worker draws each sample from random.Random(seed): the same
    # sample rebuilt here from the seed the loader drew for it
    order = list(range(len(ds)))
    random.Random(0).shuffle(order)
    seed = random.Random(4).getrandbits(64)
    ds.rng = random.Random(seed)
    np.testing.assert_array_equal(batch["lbl"][0], ds[order[0]]["lbl"])


# ---------------------------------------------------- device rasterizer

def _clip_keypoints(dance, n, hw):
    """Crop-local validated keypoints of n frames, as the serving path
    gets them: (n, 137, 2) pose | face | hand_l | hand_r."""
    frames = []
    for f in range(n):
        vid = (5, TWO_PEOPLE, LOW_CONF)[f % 3]
        p = j_ras.parse_openpose_json(_json(dance, vid, f % 8))[0]
        pts = {k: j_ras.valid_keypoints(v) for k, v in p.items()}
        local = j_posenorm.shift_pts(pts, (30, 40))
        scale = hw / 256.0
        frames.append(np.concatenate([local[k] for k in (
            "pose", "face", "hand_l", "hand_r")]) * scale)
    return np.stack(frames).astype(np.float32)


def _pose_args(kp, pbw, hbw):
    return (kp[:, :25], kp[:, 25:95], kp[:, 95:116], kp[:, 116:137], pbw, hbw)


def test_rasterize_pose_clip_op_by_op(dance):
    """Equal to the JAX rasterizer run op by op (`jax.disable_jit`), over
    frames that group into several edge and frame groups."""
    kp = _clip_keypoints(dance, 3, 48)
    kp[1, 30:40] = 0.0
    pbw = np.array([1, 2, 3], np.float32)
    hbw = np.array([1, 1, 2], np.float32)
    with jax.disable_jit():
        want = np.asarray(j_rj.rasterize_pose_clip(
            *(jnp.asarray(x) for x in _pose_args(kp, pbw, hbw)), h=48, w=40))
    got = rasterize_device.rasterize_pose_clip(
        *(torch.as_tensor(x) for x in _pose_args(kp, pbw, hbw)), h=48, w=40)
    assert got.dtype == torch.int32 and got.shape == (3, 48, 40)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 10


@pytest.mark.parametrize("flags", [(False, False), (True, False),
                                   (False, True)],
                         ids=["all", "basic", "no_face"])
def test_rasterize_pose_clip_matches_jit(dance, flags):
    """Against the jitted JAX rasterizer at 256^2: XLA fuses the
    expressions and can move a sample onto a window edge, so pixels agree
    to the face rasterizer's bound (tests/test_torch_serve.py)."""
    kp = _clip_keypoints(dance, 4, 256)
    bw = np.array([1, 2, 2, 3], np.float32)
    hbw = np.maximum(bw / 3, 1).astype(np.float32)
    want = np.asarray(j_rj.rasterize_pose_clip(
        *(jnp.asarray(x) for x in _pose_args(kp, bw, hbw)), h=256, w=256,
        basic_point_only=flags[0], remove_face_labels=flags[1]))
    got = rasterize_device.rasterize_pose_clip(
        *(torch.as_tensor(x) for x in _pose_args(kp, bw, hbw)), h=256,
        w=256, basic_point_only=flags[0], remove_face_labels=flags[1])
    agree = float((got.numpy() == want).mean())
    _report(agreement=agree, classes=len(np.unique(want)))
    assert agree >= 0.9999
