"""The port's training loop, its `TSNet` update and its CLI against the
JAX package (CPU, toy config).

One JAX `TSNet` (plain path, `use_pallas=False`; the port's CPU path is
every kernel's plain version) is compiled once for the module and reset
to a copy of its initial state for each use. Its weights and VGG tree
are carried into the port's `TSNet`; both are fed the same batches (the
JAX dataset's output, so the dataset's own tolerance does not enter).

Both run at softmax temperature 10, as tests/test_torch_train_step.py
holds gradients: at the toy config's 100, random features saturate the
attention to one-hot and its gradient compares rounding noise. The loops
start from a mid-training state (seeded Adam moments, count 3, as
tests/test_torch_checkpoint.py seeds them): from fresh moments Adam's
first update is lr * sign(g), so a gradient element that is rounding
noise in both packages moves its weight by up to 2 lr between them.
Every metric is held within 1e-4 relative of the JAX package's from the
same state: a loop's second step starts from weights that the first
step's gradients, 1e-3 apart between the packages
(tests/test_torch_train_step.py), moved apart, and the JAX package's
own second-step metrics move by up to 5e-2 under a 1e-6 nudge of its
weights; so the port's second step is taken from the JAX loop's state
after its first. `pytest -s` prints the errors.
"""

import dataclasses
import os
import random
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from wacv23_tsnet_tpu.configs import TrainConfig as JTrainConfig
from wacv23_tsnet_tpu.configs import toy_config as j_toy_config
from wacv23_tsnet_tpu.data.datasets import FaceDatasetTrain as JFaceDataset
from wacv23_tsnet_tpu.data.loader import Loader as JLoader
from wacv23_tsnet_tpu.models import TSNet as JTSNet
from wacv23_tsnet_tpu.nn import load_vgg19_params
from wacv23_tsnet_tpu.train.checkpoint import (
    restore_checkpoint as j_restore_checkpoint)
from wacv23_tsnet_tpu.train.loop import run_training as j_run_training
from wacv23_tsnet_tpu_torch.cli.train_face import main
from wacv23_tsnet_tpu_torch.compat import (export_opt_states,
                                           export_train_state,
                                           load_train_state)
from wacv23_tsnet_tpu_torch.configs import TrainConfig, toy_config
from wacv23_tsnet_tpu_torch.data.datasets import FaceDatasetTrain
from wacv23_tsnet_tpu_torch.data.image_io import read_png
from wacv23_tsnet_tpu_torch.data.loader import Loader, collate
from wacv23_tsnet_tpu_torch.models import TSNet
from wacv23_tsnet_tpu_torch.train.checkpoint import (find_latest_checkpoint,
                                                     restore_checkpoint)
from wacv23_tsnet_tpu_torch.train.loop import run_training

torch.set_num_threads(2)
RNG = np.random.default_rng(77)
TEMP = 10.0
J_CFG = dataclasses.replace(j_toy_config(), softmax_temp=TEMP)
CFG = dataclasses.replace(toy_config(), softmax_temp=TEMP)


def _report(**values):
    name = os.environ.get("PYTEST_CURRENT_TEST", "").split()[0]
    print(f"[parity] {name}: " + " ".join(
        f"{k}={v:.3e}" for k, v in values.items()))


def _face_landmarks(cx, cy, r):
    """tests/test_train_loop.py's 68-point layout."""
    t = np.linspace(np.pi * 0.1, np.pi * 0.9, 17)
    jaw = np.stack([cx + r * np.cos(t + np.pi / 2) * 1.2,
                    cy + r * np.sin(t)], 1)
    rest = RNG.uniform(-r * 0.5, r * 0.5, (51, 2)) + [cx, cy - r * 0.2]
    return np.concatenate([jaw, rest])


@pytest.fixture(scope="module")
def synthetic_face_dataset(tmp_path_factory):
    """tests/test_train_loop.py's dataset: 2 videos x 6 frames, 192x192
    noise PNGs and landmark files."""
    root = tmp_path_factory.mktemp("faces")
    lbl_root, img_root = root / "labels", root / "images"
    for vid in range(2):
        (lbl_root / f"vid{vid}").mkdir(parents=True)
        (img_root / f"vid{vid}").mkdir(parents=True)
        for f in range(6):
            kp = _face_landmarks(100 + 5 * f, 90 + 3 * vid, 40)
            np.savetxt(lbl_root / f"vid{vid}" / f"{f:03d}.txt", kp,
                       delimiter=",")
            img = (RNG.random((192, 192, 3)) * 255).astype(np.uint8)
            Image.fromarray(img).save(img_root / f"vid{vid}" / f"{f:03d}.png")
    return str(lbl_root), str(img_root)


@pytest.fixture(scope="module")
def vgg_tree():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jax.tree.map(np.asarray, load_vgg19_params())


@pytest.fixture(scope="module")
def jax_model(vgg_tree):
    """A JAX TSNet and its initial state (restored before each use)."""
    model = JTSNet(J_CFG, is_train=True, use_pallas=False,
                   vgg_params=vgg_tree)
    return model, _fresh(model.state)


def _fresh(state):
    """A copy of a JAX train state: the JAX step donates its input."""
    return jax.tree.map(jnp.copy, state)


@pytest.fixture(scope="module")
def warm_state(jax_model):
    """The JAX initial state with seeded Adam moments (count 3, step 3)."""
    _, state0 = jax_model
    rng = np.random.default_rng(3)

    def seeded(opt):
        def rand(tree):
            tree = jax.tree.map(lambda x: jnp.asarray(
                1e-3 * rng.standard_normal(x.shape), jnp.float32), tree)
            if "fuse_net" in tree:   # its gradient is 0: zero moments
                conv2 = tree["fuse_net"]["block0"]["conv2"]
                conv2["bias"] = jnp.zeros_like(conv2["bias"])
            return tree
        return opt._replace(count=jnp.int32(3), mu=rand(opt.mu),
                            nu=jax.tree.map(jnp.abs, rand(opt.nu)))

    return state0.replace(step=jnp.int32(3),
                          gen_opt_state=seeded(state0.gen_opt_state),
                          disc_opt_state=seeded(state0.disc_opt_state))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_model(jstate, seed=9, moments=False):
    """A port TSNet holding the JAX state's weights (and with `moments`
    its Adam moments, counts and step)."""
    model = TSNet(CFG, is_train=True, device="cpu", seed=seed)
    opt = {}
    if moments:
        opt = {f"{k}_opt_state": {"count": np.asarray(o.count),
                                  "mu": _np(o.mu), "nu": _np(o.nu)}
               for k, o in (("gen", jstate.gen_opt_state),
                            ("disc", jstate.disc_opt_state))}
        opt["step"] = int(jstate.step)
    load_train_state(model.state, _np(jstate.gen_params),
                     _np(jstate.disc_params), _np(jstate.vgg_params), **opt)
    return model


def _rel(got, want):
    return {k: abs(got[k] - want[k]) / max(1.0, abs(want[k])) for k in want}


# ------------------------------------------------------- TSNet update

def _random_inputs(bs, size, label_nc, n_source):
    """tests/test_model_smoke.py's reference-layout inputs."""
    srcs, lbls, boxes = [], [], []
    for _ in range(n_source):
        srcs.append(RNG.random((bs, 3, size, size), dtype=np.float32) * 255)
        lbls.append(RNG.integers(0, 2, (bs, label_nc, size, size))
                    .astype(np.float32))
        boxes.append(RNG.integers(0, 2, (bs, size, size)).astype(np.float32))
    tar_img = RNG.random((bs, 3, size, size), dtype=np.float32) * 255
    tar_lbl = RNG.integers(0, 2, (bs, label_nc, size, size)).astype(
        np.float32)
    tar_bbox = RNG.integers(0, 2, (bs, size, size)).astype(np.float32)
    return srcs, lbls, boxes, tar_img, tar_lbl, tar_bbox


def _optimize(model, inputs):
    model.setup(actual_step=3, batch_size=2, initial_iter=1, max_iter=100,
                power=1.0)
    model.set_train_input(*inputs)
    model.optimize_parameters()
    return model.get_current_losses()


def test_tsnet_optimize_parameters_matches_jax(jax_model):
    """One `optimize_parameters` from the JAX TSNet's initial weights
    carried across, on the same staged inputs: every metric within 1e-4
    relative (the bar of tests/test_torch_train_step.py)."""
    jmodel, state0 = jax_model
    inputs = _random_inputs(2, 64, 2, 2)
    jmodel.state = _fresh(state0)
    want = _optimize(jmodel, inputs)
    model = _port_model(state0)
    got = _optimize(model, inputs)
    assert list(got) == list(want) and model.state.step == 1
    errs = _rel(got, want)
    _report(**errs)
    assert max(errs.values()) <= 1e-4
    assert np.abs(model.rec_tar_img - jmodel.rec_tar_img).max() <= 1e-3


# ------------------------------------------------------------ the loop

class _Recording:
    """Records each step's metrics (a test-side sync per step), and with
    `states` a copy of a JAX model's state after its first step."""

    def __init__(self, model, states=None):
        self.model, self.steps = model, []
        inner = model.optimize_parameters_on

        def record(batch):
            inner(batch)
            self.steps.append({k: float(v)
                               for k, v in model._metrics_dev.items()})
            if states is not None and len(self.steps) == 1:
                states.append(_fresh(model.state))
        model.optimize_parameters_on = record


def _jax_batches(dataset, n_frame_total=4):
    """The JAX dataset's clips, batched by the JAX loader (one worker:
    the dataset's rng is drawn in sample order)."""
    ds = JFaceDataset(*dataset, n_frame_total=n_frame_total,
                      is_jitter=True, is_mirror=True, img_size=(64, 64),
                      rng=random.Random(3))
    return list(JLoader(ds, batch_size=2, num_workers=1, seed=0))


def _line_shape(line):
    return re.sub(r"-?\d+\.?\d*(e-?\d+)?", "#", line)


def _numbers(line):
    return [float(x) for x in re.findall(r"=(-?\d+\.\d+)", line)]


def test_run_training_matches_jax(synthetic_face_dataset, jax_model,
                                  warm_state, tmp_path, capsys):
    """2 steps of the port's loop and the JAX loop on the same clip from
    the same mid-training state: the metrics of each step from the same
    state (the port's second step is taken from the JAX loop's state
    after its first, on a clip of the same sources and the second
    target), the print lines, the `history.csv` columns; the port's
    snapshot read back by the JAX package's `restore_checkpoint`; an
    image shot written."""
    jmodel, _ = jax_model
    batches = _jax_batches(synthetic_face_dataset)
    tcfg = TrainConfig(batch_size=2, n_frame_total=4, num_videos=2,
                       print_freq=1, save_img_freq=2)
    jtcfg = JTrainConfig(batch_size=2, n_frame_total=4, num_videos=2,
                         print_freq=1, save_img_freq=100)
    runs, after_first = {}, []
    for tag in ("jax", "port"):
        if tag == "port":
            model, loop, cfg, tc = (_port_model(warm_state, moments=True),
                                    run_training, CFG, tcfg)
        else:
            model, loop, cfg, tc = (jmodel, j_run_training, J_CFG, jtcfg)
            jmodel.state = _fresh(warm_state)
        rec = _Recording(model, after_first if tag == "jax" else None)
        out = tmp_path / tag
        capsys.readouterr()
        steps = loop(model, batches, cfg, tc, final_step=5, start_step=3,
                     snapshot_dir=str(out / "snapshots"),
                     imgshot_dir=str(out / "imgshots"), save_every=1000,
                     n_source=2, history_path=str(out / "history.csv"))
        assert steps == 5
        runs[tag] = (rec.steps, capsys.readouterr().out.splitlines(), out,
                     model)

    want_steps, want_lines, want_dir, _ = runs["jax"]
    got_steps, got_lines, got_dir, model = runs["port"]
    # the second step from the JAX loop's state after its first: sources
    # (frames 0, 1) and the second target (frame 3) as a clip of 3
    second = _port_model(after_first[0], moments=True)
    rec = _Recording(second)
    clip = [dict(b, **{k: b[k][:, [0, 1, 3]] for k in ("img", "lbl", "bbox")})
            for b in batches]
    run_training(second, clip, CFG, tcfg, final_step=5, start_step=4,
                 snapshot_dir=str(tmp_path / "second"),
                 imgshot_dir=str(tmp_path / "second_shots"),
                 save_every=1000, n_source=2)
    errs = {f"step1_{k}": e for k, e in _rel(got_steps[0],
                                             want_steps[0]).items()}
    errs.update({f"step2_{k}": e for k, e in _rel(rec.steps[0],
                                                  want_steps[1]).items()})
    _report(**errs)
    assert max(errs.values()) <= 1e-4, errs
    assert capsys.readouterr().out.startswith("step 5/5")

    # the same print lines (numbers aside) and history columns
    got_print = [ln for ln in got_lines if ln.startswith(("step", "lr="))]
    want_print = [ln for ln in want_lines if ln.startswith(("step", "lr="))]
    assert [_line_shape(x) for x in got_print] == \
        [_line_shape(x) for x in want_print]
    assert [g for g in got_print if g.startswith("lr=")] == \
        [w for w in want_print if w.startswith("lr=")]
    # the first step's line (3 decimals); later lines average in step 2
    np.testing.assert_allclose(_numbers(got_print[0]),
                               _numbers(want_print[0]), atol=2e-3)
    got_hist = (got_dir / "history.csv").read_text().splitlines()
    want_hist = (want_dir / "history.csv").read_text().splitlines()
    assert got_hist[0] == want_hist[0]
    assert [r.split(",")[0] for r in got_hist] == \
        [r.split(",")[0] for r in want_hist]

    # the port's snapshot, in the JAX package
    snap = find_latest_checkpoint(str(got_dir / "snapshots"))
    assert os.path.basename(snap) == "TSNet_S000005.msgpack"
    restored = j_restore_checkpoint(snap, warm_state)
    assert int(restored.step) == 5
    gen, disc, _ = export_train_state(model.state)
    for ours, theirs in ((gen, restored.gen_params),
                         (disc, restored.disc_params)):
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
            np.testing.assert_array_equal(a, np.asarray(b))
    shot = read_png(str(got_dir / "imgshots" / "step_000004.png"))
    assert shot.shape == (64, 5 * 64, 3)


def test_run_training_resumes_to_the_exact_step(synthetic_face_dataset,
                                                jax_model, tmp_path):
    """Train 2 steps, restore the snapshot into a fresh model, train 1
    more: the step counter, every parameter and every Adam moment equal
    a straight 3-step run's."""
    _, state0 = jax_model
    clips = _jax_batches(synthetic_face_dataset)
    tcfg = TrainConfig(batch_size=2, n_frame_total=4, num_videos=2,
                       print_freq=100, save_img_freq=100)
    kw = dict(save_every=1000, n_source=2)

    straight = _port_model(state0)
    run_training(straight, clips, CFG, tcfg, final_step=3,
                 snapshot_dir=str(tmp_path / "a"),
                 imgshot_dir=str(tmp_path / "ia"), **kw)
    first = _port_model(state0)
    run_training(first, clips, CFG, tcfg, final_step=2,
                 snapshot_dir=str(tmp_path / "b"),
                 imgshot_dir=str(tmp_path / "ib"), **kw)
    resumed = _port_model(state0, seed=4)
    restore_checkpoint(find_latest_checkpoint(str(tmp_path / "b")),
                       resumed.state)
    assert resumed.state.step == 2
    run_training(resumed, clips, CFG, tcfg, final_step=3,
                 start_step=resumed.state.step,
                 snapshot_dir=str(tmp_path / "c"),
                 imgshot_dir=str(tmp_path / "ic"), **kw)
    assert resumed.state.step == straight.state.step == 3
    for a, b in zip(jax.tree.leaves((export_train_state(resumed.state),
                                     export_opt_states(resumed.state))),
                    jax.tree.leaves((export_train_state(straight.state),
                                     export_opt_states(straight.state)))):
        np.testing.assert_array_equal(a, b)


# ------------------------------- tests/test_train_loop.py on the port

def test_face_dataset_and_loader(synthetic_face_dataset):
    lbl_root, img_root = synthetic_face_dataset
    ds = FaceDatasetTrain(lbl_root, img_root, n_frame_total=4,
                          is_jitter=True, is_mirror=True,
                          img_size=(64, 64), rng=random.Random(0))
    sample = ds[0]
    assert sample["img"].shape == (4, 3, 64, 64)
    assert sample["lbl"].shape == (4, 64, 64)
    assert set(np.unique(sample["lbl"])) <= {0, 1}
    assert sample["lbl"].sum() > 0

    with Loader(ds, batch_size=2, shuffle=True, num_workers=2,
                seed=0) as loader:
        batch = next(iter(loader))
    assert batch["img"].shape == (2, 4, 3, 64, 64)
    assert collate([sample, sample])["bbox"].shape == (2, 4, 64, 64)


def test_run_training_and_resume(synthetic_face_dataset, tmp_path):
    lbl_root, img_root = synthetic_face_dataset
    cfg = dataclasses.replace(toy_config(), n_source=2)
    tcfg = TrainConfig(batch_size=2, n_frame_total=4, num_videos=2,
                       print_freq=1, save_img_freq=100)
    ds = FaceDatasetTrain(lbl_root, img_root, mean=cfg.img_mean_array(),
                          n_frame_total=4, is_jitter=False, is_mirror=False,
                          img_size=(cfg.image_size, cfg.image_size),
                          rng=random.Random(0))
    model = TSNet(cfg, is_train=True, device="cpu")

    snap = str(tmp_path / "snapshots")
    with Loader(ds, batch_size=2, shuffle=True, num_workers=2,
                seed=0) as loader:
        steps = run_training(model, loader, cfg, tcfg, final_step=2,
                             snapshot_dir=snap,
                             imgshot_dir=str(tmp_path / "imgshots"),
                             save_every=1000, n_source=2)
    assert steps == 2
    latest = find_latest_checkpoint(snap)
    assert latest is not None

    model2 = TSNet(cfg, is_train=True, device="cpu")
    restore_checkpoint(latest, model2.state)
    assert model2.state.step == 2
    for a, b in zip(model.mods.state_dict().values(),
                    model2.mods.state_dict().values()):
        assert torch.equal(a, b)


# -------------------------------------------------------------- the CLI

def test_cli_trains_and_resumes(synthetic_face_dataset, tmp_path):
    """`cli.train_face.main` on the toy model and the CPU (its test
    hook): flags, log, history, snapshots; `--restore-from --set-start`
    continues at the snapshot's step."""
    lbl_root, img_root = synthetic_face_dataset
    root = str(tmp_path / "run")
    args = ["--label-path", lbl_root, "--image-path", img_root,
            "--root-dir", root, "--batch-size", "2", "--n-source", "2",
            "--n-frame-total", "4", "--n-blocks", "1",
            "--n-downsampling", "2", "--print-freq", "1",
            "--num-workers", "2", "--num-videos", "2"]
    model, timer = main(args + ["--final-step", "2"],
                        base_config=toy_config(), device="cpu")
    assert model.state.step == 2 and timer.batch.count == 1
    snaps = os.path.join(root, "snapshots")
    assert sorted(os.listdir(snaps)) == ["B0002E0900.log",
                                         "TSNet_S000002.msgpack"]
    log = open(os.path.join(snaps, "B0002E0900.log")).read()
    assert "step 2/2" in log and "final snapshot" in log
    assert len(open(os.path.join(root, "history.csv")).readlines()) == 3

    model, _ = main(args + ["--final-step", "3", "--set-start",
                            "--restore-from",
                            os.path.join(snaps, "TSNet_S000002.msgpack")],
                    base_config=toy_config(), device="cpu")
    assert model.state.step == 3
    assert os.path.exists(os.path.join(snaps, "TSNet_S000003.msgpack"))
    if not torch.cuda.is_available():    # the command line's default
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(args + ["--final-step", "1"])
