"""The port's `cli.train_pose` against the JAX package's (CPU), with the
train loop's pose image shot.

Both CLIs run on a toy pose model with the 25 pose classes (the
datasets' labels): the port's as `main(argv, base_config=...,
device="cpu")`, the JAX one with `pose_config` monkeypatched in its
module namespace to the same model and its `TSNet` on the plain path
(`use_pallas=False`; the port's CPU path is every kernel's plain
version). Both start from one mid-training snapshot written by the JAX
package (seeded Adam moments, at softmax temperature 10, as
tests/test_torch_loop.py compares steps: from fresh moments Adam's first
update is lr * sign(g)) and are fed the same clip batch of the JAX
dataset through a stand-in for their `Loader` (the port's loader seeds
each sample apart, the JAX one draws from one rng, so their own batches
differ); each records the dataset its CLI built, which is then held
equal across the packages. The JAX datasets' `draw_edge` is pinned to
its numpy tier, as in tests/test_torch_data.py. `pytest -s` prints the
errors.
"""

import dataclasses
import functools
import os
import random
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import wacv23_tsnet_tpu.cli.train_pose as j_train_pose
from torch_pose_dance import write_dance_set
from wacv23_tsnet_tpu.configs import toy_pose_config as j_toy_pose_config
from wacv23_tsnet_tpu.data import rasterize as j_ras
from wacv23_tsnet_tpu.data.datasets import PoseDatasetTrain as JPoseTrain
from wacv23_tsnet_tpu.data.loader import collate as j_collate
from wacv23_tsnet_tpu.models import TSNet as JTSNet
from wacv23_tsnet_tpu.models import TSNetModules as JTSNetModules
from wacv23_tsnet_tpu.nn import load_vgg19_params
from wacv23_tsnet_tpu.train.checkpoint import (
    restore_checkpoint as j_restore_checkpoint)
from wacv23_tsnet_tpu.train.checkpoint import (
    save_checkpoint as j_save_checkpoint)
from wacv23_tsnet_tpu.train.state import (
    create_train_state as j_create_train_state)
from wacv23_tsnet_tpu_torch.cli import train_pose
from wacv23_tsnet_tpu_torch.compat import export_train_state
from wacv23_tsnet_tpu_torch.configs import toy_pose_config
from wacv23_tsnet_tpu_torch.data import codecs
from wacv23_tsnet_tpu_torch.data.image_io import read_png
from wacv23_tsnet_tpu_torch.models import TSNet

torch.set_num_threads(2)
CFG = dataclasses.replace(toy_pose_config(), label_nc=25)
J_CFG = dataclasses.replace(j_toy_pose_config(), label_nc=25)
TEMP = 10.0
START_STEP = 99          # one step to 100: the loop's image-shot step


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
    return str(write_dance_set(str(tmp_path_factory.mktemp("dance"))))


# -------------------------------------------------------------- training

class _Batches:
    """Stands in for a CLI's `Loader`: records the dataset and the
    loader arguments the CLI gave, and yields `BATCHES`."""

    BATCHES: list = []
    made: list = []

    def __init__(self, dataset, batch_size, shuffle=True, num_workers=8,
                 seed=0, **_):
        self.dataset = dataset
        self.args = (batch_size, shuffle, num_workers, seed)
        _Batches.made.append(self)

    def start(self):
        pass

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def __len__(self):
        return len(self.BATCHES)

    def __iter__(self):
        yield from self.BATCHES


@pytest.fixture(scope="module")
def warm_snapshot(tmp_path_factory):
    """A JAX trainer snapshot of the toy pose model at temperature 10,
    step START_STEP, with seeded Adam moments (count START_STEP)."""
    cfg = dataclasses.replace(J_CFG, softmax_temp=TEMP)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        vgg = jax.tree.map(np.asarray, load_vgg19_params())
    state = j_create_train_state(JTSNetModules(cfg), jax.random.PRNGKey(4),
                                 vgg_params=vgg)
    rng = np.random.default_rng(3)

    def seeded(opt):
        def rand(tree):
            tree = jax.tree.map(lambda x: jnp.asarray(
                1e-3 * rng.standard_normal(x.shape), jnp.float32), tree)
            if "fuse_net" in tree:   # its gradient is 0: zero moments
                conv2 = tree["fuse_net"]["block0"]["conv2"]
                conv2["bias"] = jnp.zeros_like(conv2["bias"])
            return tree
        return opt._replace(count=jnp.int32(START_STEP), mu=rand(opt.mu),
                            nu=jax.tree.map(jnp.abs, rand(opt.nu)))

    state = state.replace(step=jnp.int32(START_STEP),
                          gen_opt_state=seeded(state.gen_opt_state),
                          disc_opt_state=seeded(state.disc_opt_state))
    path = str(tmp_path_factory.mktemp("warm") / "warm.msgpack")
    j_save_checkpoint(path, state)
    return path, state


@pytest.fixture(scope="module")
def train_runs(dance, warm_snapshot, tmp_path_factory):
    """Both train CLIs, one step each from the warm snapshot on one clip
    batch of the JAX dataset; returns {tag: (run dir, recorded steps,
    stand-in loader, model)}."""
    mp = pytest.MonkeyPatch()
    mp.setattr(j_ras, "draw_edge", _jax_numpy_draw_edge)
    mp.setenv("TSNET_NATIVE", "0")
    root = tmp_path_factory.mktemp("train")
    common = ["--json-path", os.path.join(dance, "clean_video_dict.json"),
              "--label-path", os.path.join(dance, "labels"),
              "--image-path", os.path.join(dance, "images"),
              "--batch-size", "2", "--n-source", "2", "--n-frame-total", "4",
              "--n-blocks", "1", "--n-downsampling", "2", "--num-videos", "2",
              "--num-workers", "1", "--print-freq", "1",
              "--restore-from", warm_snapshot[0], "--set-start",
              "--final-step", str(START_STEP + 1)]
    jds = JPoseTrain(json_path=os.path.join(dance, "clean_video_dict.json"),
                     label_path=os.path.join(dance, "labels"),
                     image_path=os.path.join(dance, "images"),
                     n_frame_total=4, interval=2, rng=random.Random(8))
    _Batches.BATCHES = [j_collate([jds[0], jds[1]])]
    _Batches.made = []
    steps = {"jax": [], "port": []}

    def recorder(cls, tag):
        inner = cls.optimize_parameters_on

        def record(self, batch):
            inner(self, batch)
            steps[tag].append({k: float(v)
                               for k, v in self._metrics_dev.items()})
        mp.setattr(cls, "optimize_parameters_on", record)

    recorder(JTSNet, "jax")
    recorder(TSNet, "port")
    mp.setattr(j_train_pose, "pose_config",
               lambda: dataclasses.replace(J_CFG, softmax_temp=TEMP))
    mp.setattr(j_train_pose, "TSNet",
               functools.partial(JTSNet, use_pallas=False))
    mp.setattr(j_train_pose, "Loader", _Batches)
    mp.setattr(train_pose, "Loader", _Batches)
    mp.setattr(sys, "stdout", sys.stdout)    # the JAX CLI replaces it
    try:
        j_train_pose.main(common + ["--root-dir", str(root / "jax")])
        model, _ = train_pose.main(
            common + ["--root-dir", str(root / "port")],
            base_config=dataclasses.replace(CFG, softmax_temp=TEMP),
            device="cpu")
    finally:
        mp.undo()
    loaders = {"jax": _Batches.made[0], "port": _Batches.made[1]}
    return {tag: (root / tag, steps[tag], loaders[tag]) for tag in steps}, \
        model


def test_train_pose_matches_jax(train_runs, warm_snapshot):
    """One step from the same mid-training state on the same batch: the
    16 pose metrics within 1e-4 relative (tests/test_torch_loop.py's
    bar); the port's snapshot read back by the JAX package."""
    runs, model = train_runs
    want, got = runs["jax"][1], runs["port"][1]
    assert len(want) == len(got) == 1 and sorted(got[0]) == sorted(want[0])
    errs = {k: abs(got[0][k] - want[0][k]) / max(1.0, abs(want[0][k]))
            for k in want[0]}
    _report(**{k: f"{v:.2e}" for k, v in errs.items()})
    assert max(errs.values()) <= 1e-4, errs
    assert model.state.step == START_STEP + 1
    assert model.mods.cfg.label_nc == 25
    snaps = [sorted(os.listdir(runs[t][0] / "snapshots")) for t in runs]
    assert snaps[0] == snaps[1] == ["B0002E0900.log",
                                    f"TSNet_S{START_STEP + 1:06d}.msgpack"]
    restored = j_restore_checkpoint(
        str(runs["port"][0] / "snapshots" / snaps[1][1]), warm_snapshot[1])
    assert int(restored.step) == START_STEP + 1
    gen, disc, _ = export_train_state(model.state)
    for ours, theirs in ((gen, restored.gen_params),
                         (disc, restored.disc_params)):
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_train_pose_builds_the_jax_dataset(train_runs, jax_numpy_tier):
    """The CLIs' datasets and loaders take the same arguments (interval
    4, labels, jitter, mirror, mean, seed), and draw the same clips."""
    runs, _ = train_runs
    jl, pl = runs["jax"][2], runs["port"][2]
    assert jl.args == pl.args == (2, True, 1, 1234)
    jd, pd = jl.dataset, pl.dataset
    for key in ("n_frame_total", "interval", "is_jitter", "is_mirror",
                "basic_point_only", "remove_face_labels"):
        assert getattr(pd, key) == getattr(jd, key), key
    assert pd.interval == 4
    np.testing.assert_array_equal(pd.mean, jd.mean)
    assert pd.rng.getstate() == jd.rng.getstate()
    pd.rng, jd.rng = random.Random(3), random.Random(3)
    got, want = pd[1], jd[1]
    for key in ("img", "lbl", "bbox"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["names"] == want["names"]


def test_train_pose_imgshot_matches_jax(train_runs):
    """The loop's image shot at step 100: source, label and target
    columns equal to the JAX loop's (the label column in the pose
    palette), the step's reconstruction within 1 level. The warp preview
    is rendered with the weights after the step, which the step's
    gradients (1e-3 apart between the packages,
    tests/test_torch_train_step.py) moved apart: held on its mean, within
    1 level."""
    runs, _ = train_runs
    name = f"step_{START_STEP + 1:06d}.png"
    want = np.asarray(Image.open(runs["jax"][0] / "imgshots" / name))
    got = read_png(str(runs["port"][0] / "imgshots" / name))
    assert got.shape == want.shape == (256, 5 * 256, 3)
    np.testing.assert_array_equal(got[:, :768], want[:, :768])
    colors = {tuple(c) for c in np.unique(got[:, 256:512].reshape(-1, 3),
                                          axis=0)}
    palette = {tuple(c) for c in codecs.POSE_PALETTE.tolist()}
    assert colors <= palette | {(0, 0, 0)} and len(colors) > 5
    diff = np.abs(got.astype(int) - want)
    rec, warp = diff[:, 768:1024], diff[:, 1024:]
    _report(label_colours=len(colors), rec_max_levels=rec.max(),
            warp_max_levels=warp.max(), warp_mean_levels=warp.mean())
    assert rec.max() <= 1 and warp.mean() <= 1.0


def test_train_pose_label_classes(monkeypatch, dance, tmp_path):
    """`--basic-point-only --remove-face-labels` trains 19 classes, as
    the JAX CLI; either flag alone keeps 25."""
    seen = []

    class Stop(Exception):
        pass

    def record(cfg, **_):
        seen.append(cfg.label_nc)
        raise Stop

    monkeypatch.setattr(train_pose, "TSNet", record)
    monkeypatch.setattr(train_pose, "Loader", _Batches)
    monkeypatch.setattr(_Batches, "made", [], raising=False)
    base = ["--json-path", os.path.join(dance, "clean_video_dict.json"),
            "--label-path", os.path.join(dance, "labels"),
            "--image-path", os.path.join(dance, "images"),
            "--root-dir", str(tmp_path)]
    for flags in (["--basic-point-only", "--remove-face-labels"],
                  ["--basic-point-only"], []):
        with pytest.raises(Stop):
            train_pose.main(base + flags, base_config=CFG, device="cpu")
    assert seen == [19, 25, 25]
    ds = _Batches.made[0].dataset
    assert ds.basic_point_only and ds.remove_face_labels


