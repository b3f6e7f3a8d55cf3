"""The port's pose CLIs of test time against the JAX package (CPU):
`cli.smooth_keypoints`, `cli.demo_pose` and `cli.eval_snapshots --task
pose` (`cli.train_pose` is tests/test_torch_pose_train_cli.py, pose
serving tests/test_torch_pose_serve.py).

Each CLI runs as `main(argv, base_config=..., device="cpu")` on a toy
pose model with the 25 pose classes (the datasets' labels), the JAX CLI
with `pose_config` monkeypatched in its module namespace to the same
model and its `ClipInference` on the plain path (`use_pallas=False`; the
port's CPU path is every kernel's plain version). The JAX datasets'
`draw_edge` is pinned to its numpy tier, as in tests/test_torch_data.py.
`pytest -s` prints the errors.
"""

import dataclasses
import filecmp
import functools
import os
import re

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import wacv23_tsnet_tpu.cli.demo_pose as j_demo_pose
import wacv23_tsnet_tpu.cli.eval_snapshots as j_eval
import wacv23_tsnet_tpu.cli.smooth_keypoints as j_smooth_cli
from torch_pose_dance import LOW_CONF, TWO_PEOPLE, write_dance_set
from wacv23_tsnet_tpu.configs import toy_pose_config as j_toy_pose_config
from wacv23_tsnet_tpu.data import rasterize as j_ras
from wacv23_tsnet_tpu.infer.pipeline import ClipInference as JClipInference
from wacv23_tsnet_tpu.models import TSNetModules as JTSNetModules
from wacv23_tsnet_tpu.train.checkpoint import (
    save_checkpoint as j_save_checkpoint)
from wacv23_tsnet_tpu.train.state import (
    create_train_state as j_create_train_state)
from wacv23_tsnet_tpu_torch.cli import (demo_pose, eval_snapshots,
                                        smooth_keypoints)
from wacv23_tsnet_tpu_torch.configs import toy_pose_config
from wacv23_tsnet_tpu_torch.data.image_io import read_png

torch.set_num_threads(2)
CFG = dataclasses.replace(toy_pose_config(), label_nc=25)
J_CFG = dataclasses.replace(j_toy_pose_config(), label_nc=25)
PLAIN_J_CLIP = functools.partial(JClipInference, use_pallas=False)


def _report(**values):
    name = os.environ.get("PYTEST_CURRENT_TEST", "").split()[0]
    print(f"[pose_cli] {name}: " + " ".join(f"{k}={v}" for k, v in
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
    """The dance set with its smoothed driving keypoints (the port's
    smoother) under smooth_openpose/."""
    root = str(tmp_path_factory.mktemp("dance"))
    write_dance_set(root)
    smooth_keypoints.main(["--video-dict", os.path.join(
        root, "clean_unseen_video_dict.json"), "--label-dir",
        os.path.join(root, "labels"), "--out-dir",
        os.path.join(root, "smooth_openpose")])
    return root


# ------------------------------------------------------ smooth_keypoints

def test_smooth_keypoints_matches_jax(dance, tmp_path, capsys):
    args = ["--video-dict", os.path.join(dance, "clean_video_dict.json"),
            "--label-dir", os.path.join(dance, "labels"),
            "--n-frame-total", "6"]
    j_smooth_cli.main(args + ["--out-dir", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    written = smooth_keypoints.main(args + ["--out-dir",
                                            str(tmp_path / "port")])
    port_out = capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "00005.json", "00120.json"]
    assert [os.path.basename(p) for p in written] == ["00005.json",
                                                      "00120.json"]
    for name in names:
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name,
                           shallow=False), name
    assert port_out.replace("port", "jax") == jax_out


# ------------------------------------------------------- demo and eval

@pytest.fixture(scope="module")
def generator_file(tmp_path_factory):
    """A toy pose generator written by the JAX package."""
    params = JTSNetModules(J_CFG).init_generator_params(
        jax.random.PRNGKey(11))
    path = str(tmp_path_factory.mktemp("gen") / "gen.msgpack")
    j_save_checkpoint(path, params)
    return path


@pytest.mark.parametrize("pair", ["5 147", "120 147"],
                         ids=["same_build", "mf"])
def test_demo_pose_matches_jax(dance, generator_file, tmp_path, monkeypatch,
                               jax_numpy_tier, capsys, pair):
    args = ["--data-root", dance, "--json-root", dance, "--pair", pair,
            "--restore-from", generator_file, "--max-frames", "5",
            "--chunk", "4", "--n-source", "2"]
    monkeypatch.setattr(j_demo_pose, "pose_config", lambda: J_CFG)
    monkeypatch.setattr(j_demo_pose, "ClipInference", PLAIN_J_CLIP)
    j_demo_pose.main(args + ["--out-dir", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    res = demo_pose.main(args + ["--out-dir", str(tmp_path / "port")],
                         base_config=CFG, device="cpu")
    port_out = capsys.readouterr().out
    sex = re.search(r"gender pair: '(\w+)'", jax_out).group(1)
    assert f"gender pair: '{sex}'" in port_out
    assert (res["diff_sex"] or "same") == sex
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert len(names) == 6 and names[-1] == pair.replace(" ", "_") + ".gif"
    assert sorted(res["names"]) == names[:-1]
    worst = 0
    for name in names[:-1]:
        want = np.asarray(Image.open(tmp_path / "jax" / name).convert("RGB"))
        got = read_png(str(tmp_path / "port" / name))
        assert got.shape == want.shape == (256, 4 * 256, 3)
        # source, label (palette) and driving columns equal
        np.testing.assert_array_equal(got[:, :768], want[:, :768])
        worst = max(worst, int(np.abs(got.astype(int) - want).max()))
    _report(max_abs_levels=worst)
    assert worst <= 1
    with Image.open(res["gif"]) as gif:
        assert gif.size == (1024, 256) and gif.n_frames == 5


@pytest.fixture(scope="module")
def pose_snapshot_dir(tmp_path_factory):
    """Two toy pose trainer snapshots written by the JAX package."""
    mods = JTSNetModules(J_CFG)
    root = tmp_path_factory.mktemp("pose_snapshots")
    for step, seed in ((7, 1), (14, 2)):
        state = j_create_train_state(mods, jax.random.PRNGKey(seed))
        j_save_checkpoint(str(root / f"TSNet_S{step:06d}.msgpack"), state)
    return str(root)


def _csv_rows(path):
    lines = open(path).read().splitlines()
    assert lines[0] == "step,l1,psnr,ssim"
    return [[float(v) for v in line.split(",")] for line in lines[1:]]


def test_eval_snapshots_pose_matches_jax(dance, pose_snapshot_dir, tmp_path,
                                         monkeypatch, jax_numpy_tier):
    args = ["--snapshot-dir", pose_snapshot_dir, "--task", "pose",
            "--data-root", dance, "--subject", "%05d" % LOW_CONF,
            "--n-source", "2", "--max-frames", "5"]
    monkeypatch.setattr(j_eval, "pose_config", lambda: J_CFG)
    monkeypatch.setattr(j_eval, "ClipInference", PLAIN_J_CLIP)
    j_eval.main(args + ["--out-dir", str(tmp_path / "jax")])
    rows = eval_snapshots.main(args + ["--out-dir", str(tmp_path / "port")],
                               base_config=CFG, device="cpu")
    want = _csv_rows(tmp_path / "jax" / "eval_metrics.csv")
    got = _csv_rows(tmp_path / "port" / "eval_metrics.csv")
    assert len(got) == len(want) == 2 and [r["step"] for r in rows] == [7, 14]
    err = max(abs(a - b) / max(1.0, abs(b))
              for ga, wa in zip(got, want) for a, b in zip(ga, wa))
    _report(max_rel_err=f"{err:.3e}")
    assert err <= 1e-4
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))


def test_load_pose_self_clip_matches_jax(dance, jax_numpy_tier):
    mean = CFG.img_mean_array()
    for vid in (5, TWO_PEOPLE):
        got = eval_snapshots.load_pose_self_clip(dance, "%05d" % vid, 4,
                                                 mean)
        want = j_eval.load_pose_self_clip(dance, "%05d" % vid, 4, mean)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


