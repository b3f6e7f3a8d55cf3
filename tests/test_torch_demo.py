"""The port's face test-time workflow against the JAX package (CPU):
keypoint smoothing, the cross-identity retargeter, `FaceDatasetTest`, the
GIF writer, the demo, snapshot evaluation, quick start and the stage
profiler.

The JAX datasets' `draw_edge` is pinned to its numpy tier, as in
tests/test_torch_data.py: its native C++ path rounds by its build flags.
The JAX CLIs run at the toy config with `face_config` monkeypatched in
their module namespace, and their `FaceDatasetTest` at the toy config's
64^2 (the port's CLIs size the test set by the config; at the face
config both are 256^2). `pytest -s` prints the measured errors.
"""

import dataclasses
import functools
import io
import os
import re
import shutil

import imageio
import jax
import numpy as np
import pytest
import torch
from PIL import Image

import wacv23_tsnet_tpu.cli.demo_face as j_demo
import wacv23_tsnet_tpu.cli.eval_snapshots as j_eval
import wacv23_tsnet_tpu.cli.quick_start as j_quick
from wacv23_tsnet_tpu.configs import toy_config as j_toy_config
from wacv23_tsnet_tpu.data import face as j_face
from wacv23_tsnet_tpu.data import rasterize as j_ras
from wacv23_tsnet_tpu.data.datasets import FaceDatasetTest as JFaceDatasetTest
from wacv23_tsnet_tpu.data.smoothing import (
    smooth_keypoint_track as j_smooth_keypoint_track)
from wacv23_tsnet_tpu.models import TSNet as JTSNet
from wacv23_tsnet_tpu.models import TSNetModules as JTSNetModules
from wacv23_tsnet_tpu.train.checkpoint import (
    save_checkpoint as j_save_checkpoint)
from wacv23_tsnet_tpu.train.state import (
    create_train_state as j_create_train_state)
from wacv23_tsnet_tpu_torch.cli import (demo_face, eval_snapshots,
                                        profile_stages, quick_start)
from wacv23_tsnet_tpu_torch.configs import toy_config, toy_pose_config
from wacv23_tsnet_tpu_torch.data import gif
from wacv23_tsnet_tpu_torch.data.datasets import FaceDatasetTest
from wacv23_tsnet_tpu_torch.data.face import (FaceRetargeter,
                                              retarget_face_keypoints)
from wacv23_tsnet_tpu_torch.data.image_io import read_png
from wacv23_tsnet_tpu_torch.data.smoothing import smooth_keypoint_track
from wacv23_tsnet_tpu_torch.infer import save_gif
from wacv23_tsnet_tpu_torch.models import TSNet, TSNetModules
from wacv23_tsnet_tpu_torch.utils.profiling import span, spans, trace

torch.set_num_threads(2)
RNG = np.random.default_rng(31)
N_FRAMES = 10
CLIP_HW = 160


def _report(**values):
    name = os.environ.get("PYTEST_CURRENT_TEST", "").split()[0]
    print(f"[demo] {name}: " + " ".join(f"{k}={v}" for k, v in
                                        values.items()))


def _jax_numpy_draw_edge(img, x, y, bw=1, color=(255, 255, 255),
                         endpoints=False):
    cx, cy = j_ras.interp_curve(x, y)
    j_ras.stamp_edge(img, cx, cy, bw=bw, color=color, endpoints=endpoints)


@pytest.fixture
def jax_numpy_tier(monkeypatch):
    monkeypatch.setattr(j_face, "draw_edge", _jax_numpy_draw_edge)
    monkeypatch.setenv("TSNET_NATIVE", "0")


def _face_landmarks(rng, cx, cy, r):
    """tests/test_train_loop.py's 68-point layout."""
    t = np.linspace(np.pi * 0.1, np.pi * 0.9, 17)
    jaw = np.stack([cx + r * np.cos(t + np.pi / 2) * 1.2,
                    cy + r * np.sin(t)], 1)
    rest = rng.uniform(-r * 0.5, r * 0.5, (51, 2)) + [cx, cy - r * 0.2]
    return np.concatenate([jaw, rest])


@pytest.fixture(scope="module")
def face_pair(tmp_path_factory):
    """A subject clip and a driving clip of different face sizes (so the
    retargeter rescales), N_FRAMES noise PNGs at CLIP_HW^2 each, with
    landmark files; returns the data root."""
    root = tmp_path_factory.mktemp("face_examples")
    rng = np.random.default_rng(5)
    for clip, r in (("subject", 36.0), ("driving", 24.0)):
        (root / "labels" / clip).mkdir(parents=True)
        (root / "images" / clip).mkdir(parents=True)
        for f in range(N_FRAMES):
            kp = _face_landmarks(rng, 80 + 2 * f, 84 - f, r + f % 3)
            np.savetxt(root / "labels" / clip / f"{f:05d}.txt", kp,
                       delimiter=",")
            img = rng.integers(0, 256, (CLIP_HW, CLIP_HW, 3), np.uint8)
            Image.fromarray(img).save(root / "images" / clip / f"{f:05d}.png")
    return str(root)


def _clip_paths(root):
    return [os.path.join(root, kind, clip)
            for clip in ("subject", "driving") for kind in ("images", "labels")]


# ------------------------------------------------ smoothing, retargeting

@pytest.mark.parametrize("t", [3, 5, 6, 30])
def test_smooth_keypoint_track_matches_jax(t):
    track = RNG.uniform(0, 255, (t, 68, 2))
    got = smooth_keypoint_track(track)
    np.testing.assert_array_equal(got, j_smooth_keypoint_track(track))
    if t < 5:
        np.testing.assert_array_equal(got, track)


def test_face_retargeter_matches_jax():
    subject = [RNG.uniform(40, 200, (68, 2)) for _ in range(5)]
    driving = [RNG.uniform(10, 120, (68, 2)) * 1.3 for _ in range(7)]
    mine, ref = FaceRetargeter(), j_face.FaceRetargeter()
    mine.fit_reference(subject)
    ref.fit_reference(subject)
    assert mine.ref_dist_x == ref.ref_dist_x
    assert mine.ref_dist_y == ref.ref_dist_y
    assert mine.img_scale == ref.img_scale
    for a, b in zip(mine.retarget(driving), ref.retarget(driving)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(retarget_face_keypoints(subject, driving),
                    j_face.retarget_face_keypoints(subject, driving)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match="fit_reference"):
        FaceRetargeter().retarget(driving)


def test_face_retarget_identity_invariance():
    """tests/test_data_rasterize.py's case on the port: retargeting a clip
    onto its own statistics is ~identity."""
    rng = np.random.default_rng(0)
    frames = [rng.uniform(10, 200, (68, 2)) + i for i in range(4)]
    r = FaceRetargeter()
    r.fit_reference(frames)
    out = r.retarget([f.copy() for f in frames])
    for a, b in zip(out, frames):
        np.testing.assert_allclose(a, b, atol=1e-6)


# -------------------------------------------------------- FaceDatasetTest

@pytest.mark.parametrize("max_frames", [6, None])
def test_face_dataset_test_matches_jax(face_pair, jax_numpy_tier, max_frames):
    paths = _clip_paths(face_pair)
    got = FaceDatasetTest(*paths, max_frame_num=max_frames)[0]
    want = JFaceDatasetTest(*paths, max_frame_num=max_frames)[0]
    n = max_frames or N_FRAMES
    for part in ("src", "tar"):
        assert got[part]["img"].shape == (n, 3, 256, 256)
        assert got[part]["img"].dtype == want[part]["img"].dtype
        for key in ("img", "lbl", "bbox"):
            np.testing.assert_array_equal(got[part][key], want[part][key])
        assert got[part]["names"] == want[part]["names"]
    assert got["tar"]["lbl"].any() and got["tar"]["bbox"].any()


def test_face_dataset_test_refuses_jpeg(face_pair, jax_numpy_tier,
                                       tmp_path):
    """`image_ext=".jpg"` reads JPEG frames (the port's decoder, bit-equal
    to Pillow's) as the JAX test set does; a frame that is neither PNG
    nor JPEG is refused."""
    root = tmp_path / "jpeg"
    shutil.copytree(os.path.join(face_pair, "labels"), root / "labels")
    for clip in ("subject", "driving"):
        os.makedirs(root / "images" / clip)
        for name in sorted(os.listdir(os.path.join(face_pair, "images",
                                                   clip))):
            Image.open(os.path.join(face_pair, "images", clip, name)).save(
                root / "images" / clip / name.replace(".png", ".jpg"),
                quality=85)
    paths = _clip_paths(str(root))
    got = FaceDatasetTest(*paths, max_frame_num=4, image_ext=".jpg")[0]
    want = JFaceDatasetTest(*paths, max_frame_num=4, image_ext=".jpg")[0]
    for part in ("src", "tar"):
        for key in ("img", "lbl", "bbox"):
            np.testing.assert_array_equal(got[part][key], want[part][key])
        assert got[part]["names"] == want[part]["names"]
    assert got["src"]["names"][0].endswith(".jpg")
    (root / "images" / "subject" / "00000.jpg").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        FaceDatasetTest(*paths, max_frame_num=4, image_ext=".jpg")[0]


# ---------------------------------------------------------------- GIF

def _montage_frames(n, h=256, w=768, seed=0):
    """Ramp-plus-noise frames, as the palette rule was measured on."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    out = []
    for i in range(n):
        ramp = np.stack([(xx // 3 + 5 * i) % 256, (yy + xx // 6) % 256,
                         (2 * yy + 9 * i) % 256], axis=-1)
        out.append(np.clip(ramp + rng.integers(0, 24, (h, w, 3)), 0,
                           255).astype(np.uint8))
    return out


def _pillow_frames(data):
    im = Image.open(io.BytesIO(data))
    frames, durations = [], []
    for k in range(im.n_frames):
        im.seek(k)
        frames.append(np.asarray(im.convert("RGB")))
        durations.append(im.info.get("duration"))
    return im.size, frames, durations


def test_gif_reads_back_in_pillow_within_imageio_palette_error(tmp_path):
    frames = _montage_frames(4)
    path = str(tmp_path / "clip.gif")
    save_gif(path, frames, duration_ms=100)
    with open(path, "rb") as f:
        data = f.read()
    assert data[:6] == b"GIF89a"
    size, decoded, durations = _pillow_frames(data)
    assert size == (768, 256) and len(decoded) == 4
    assert durations == [100] * 4
    ref = io.BytesIO()
    imageio.mimsave(ref, frames, format="GIF", duration=100)
    _, ref_frames, _ = _pillow_frames(ref.getvalue())
    for frame, got, theirs in zip(frames, decoded, ref_frames):
        palette, idx = gif.quantize(frame)
        np.testing.assert_array_equal(got, palette[idx])
        mine = np.abs(got.astype(np.int64) - frame).mean()
        imageio_err = np.abs(theirs.astype(np.int64) - frame).mean()
        _report(mean_abs_levels=f"{mine:.4f}",
                imageio_mean_abs_levels=f"{imageio_err:.4f}")
        assert mine <= 1.25 * imageio_err


def _frame(kind, rng):
    if kind == "one_colour":
        return np.full((40, 50, 3), (12, 200, 77), np.uint8)
    if kind == "200_colours":
        colours = rng.integers(0, 256, (200, 3), np.uint8)
        return colours[rng.integers(0, 200, (61, 37))]
    if kind == "noise_ragged":          # not a multiple of the segment
        return rng.integers(0, 256, (97, 131, 3), np.uint8)
    if kind == "one_pixel":
        return np.array([[[3, 4, 5]]], np.uint8)
    # runs of few colours: long LZW strings
    return np.repeat(rng.integers(0, 3, (64, 16, 1), np.uint8) * 100,
                     48, axis=1).repeat(3, axis=2)


@pytest.mark.parametrize("kind", ["one_colour", "200_colours",
                                  "noise_ragged", "one_pixel", "runs"])
def test_gif_frame_kinds(kind):
    """Pillow decodes each frame to the writer's palette lookup of its
    indices; frames of at most 256 colours come back exactly."""
    rng = np.random.default_rng(7)
    frames = [_frame(kind, rng) for _ in range(3)]
    size, decoded, durations = _pillow_frames(gif.encode_gif(frames, 40))
    assert size == frames[0].shape[1::-1] and len(decoded) == 3
    assert durations == [40] * 3
    for frame, got in zip(frames, decoded):
        palette, idx = gif.quantize(frame)
        np.testing.assert_array_equal(got, palette[idx])
        if kind != "noise_ragged":
            np.testing.assert_array_equal(got, frame)
        else:
            assert len(palette) == 256


@pytest.mark.parametrize("segment", [gif.SEGMENT, 3800])
def test_gif_code_widths(monkeypatch, segment):
    """Noise indices, one LZW code a pixel or so: at 3800 pixels a segment
    the string table passes 2048 entries, so the codes reach 12 bits."""
    monkeypatch.setattr(gif, "SEGMENT", segment)
    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, (97, 131, 3), np.uint8)
              for _ in range(2)]
    _, decoded, _ = _pillow_frames(gif.encode_gif(frames))
    for frame, got in zip(frames, decoded):
        palette, idx = gif.quantize(frame)
        np.testing.assert_array_equal(got, palette[idx])


def test_gif_refuses_bad_frames():
    with pytest.raises(ValueError, match="uint8"):
        gif.encode_gif([np.zeros((4, 4, 3), np.float32)])
    with pytest.raises(ValueError, match="differ in size"):
        gif.encode_gif([np.zeros((4, 4, 3), np.uint8),
                        np.zeros((4, 5, 3), np.uint8)])


# ---------------------------------------------------------------- CLIs

@pytest.fixture(scope="module")
def generator_file(tmp_path_factory):
    """A toy generator written by the JAX package's save_checkpoint."""
    params = JTSNetModules(j_toy_config()).init_generator_params(
        jax.random.PRNGKey(11))
    path = str(tmp_path_factory.mktemp("gen") / "gen.msgpack")
    j_save_checkpoint(path, params)
    return path


def _jax_toy(monkeypatch, module):
    monkeypatch.setattr(module, "face_config", j_toy_config)
    monkeypatch.setattr(module, "FaceDatasetTest", functools.partial(
        JFaceDatasetTest, img_size=(64, 64)))


def test_demo_face_matches_jax(face_pair, generator_file, tmp_path,
                               monkeypatch, jax_numpy_tier, capsys):
    args = ["--data-root", face_pair, "--subject", "subject", "--driving",
            "driving", "--restore-from", generator_file, "--max-frames", "7",
            "--chunk", "4", "--n-source", "2"]
    _jax_toy(monkeypatch, j_demo)
    j_demo.main(args + ["--out-dir", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    res = demo_face.main(args + ["--out-dir", str(tmp_path / "port")],
                         base_config=toy_config(), device="cpu")
    port_out = capsys.readouterr().out
    ref_idx = re.search(r"reference frames: (\[.*\])", jax_out).group(1)
    assert str(res["ref_idx"]) == ref_idx
    assert f"reference frames: {ref_idx}" in port_out
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert len(names) == 8 and names[-1] == "subject_driving.gif"
    worst = 0
    for name in names[:-1]:
        want = np.asarray(Image.open(tmp_path / "jax" / name).convert("RGB"))
        got = read_png(str(tmp_path / "port" / name))
        assert got.shape == want.shape == (64, 192, 3)
        worst = max(worst, int(np.abs(got.astype(int) - want).max()))
    _report(max_abs_levels=worst)
    assert worst <= 1
    size, frames, durations = _pillow_frames(
        open(tmp_path / "port" / names[-1], "rb").read())
    assert size == (192, 64) and len(frames) == 7
    assert durations == [100] * 7
    for name, frame in zip(names[:-1], frames):
        palette, idx = gif.quantize(read_png(str(tmp_path / "port" / name)))
        np.testing.assert_array_equal(frame, palette[idx])


@pytest.fixture(scope="module")
def snapshot_dir(tmp_path_factory):
    """Two toy trainer snapshots written by the JAX package."""
    mods = JTSNetModules(j_toy_config())
    root = tmp_path_factory.mktemp("snapshots")
    for step, seed in ((7, 1), (14, 2)):
        state = j_create_train_state(mods, jax.random.PRNGKey(seed))
        j_save_checkpoint(str(root / f"TSNet_S{step:06d}.msgpack"), state)
    return str(root)


def _csv_rows(path):
    lines = open(path).read().splitlines()
    assert lines[0] == "step,l1,psnr,ssim"
    return [[float(v) for v in line.split(",")] for line in lines[1:]]


def test_eval_snapshots_matches_jax(face_pair, snapshot_dir, tmp_path,
                                    monkeypatch, jax_numpy_tier):
    args = ["--snapshot-dir", snapshot_dir, "--data-root", face_pair,
            "--subject", "subject", "--n-source", "2", "--max-frames", "6"]
    _jax_toy(monkeypatch, j_eval)
    j_eval.main(args + ["--out-dir", str(tmp_path / "jax")])
    rows = eval_snapshots.main(args + ["--out-dir", str(tmp_path / "port")],
                               base_config=toy_config(), device="cpu")
    want = _csv_rows(tmp_path / "jax" / "eval_metrics.csv")
    got = _csv_rows(tmp_path / "port" / "eval_metrics.csv")
    assert len(got) == len(want) == 2 and [r["step"] for r in rows] == [7, 14]
    err = max(abs(a - b) / max(1.0, abs(b))
              for ga, wa in zip(got, want) for a, b in zip(ga, wa))
    _report(max_rel_err=f"{err:.3e}")
    assert err <= 1e-4
    assert all(np.isfinite([r["restore_s"], r["infer_s"]]).all()
               for r in rows)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))


def test_eval_snapshots_refuses_pose(snapshot_dir, tmp_path):
    """`--task pose` evaluates pose snapshots on a dance video
    (tests/test_torch_pose_cli.py); the face model's snapshots it
    refuses, their encoders being of another width."""
    from torch_pose_dance import write_dance_set
    dance = write_dance_set(str(tmp_path / "dance"), n_frames=4)
    pose_cfg = dataclasses.replace(toy_pose_config(), label_nc=25)
    with pytest.raises(RuntimeError, match="size mismatch"):
        eval_snapshots.main(["--snapshot-dir", snapshot_dir, "--task", "pose",
                             "--data-root", dance, "--subject", "00005",
                             "--n-source", "2", "--max-frames", "4",
                             "--out-dir", str(tmp_path / "out")],
                            base_config=pose_cfg, device="cpu")


def test_quick_start_matches_jax_draws(monkeypatch):
    staged = {}

    class Recorder:
        """Stands in for the JAX TSNet: keeps what the CLI stages."""

        def __init__(self, *_, **__):
            pass

        def setup(self, *args):
            staged["jax_setup"] = args

        def set_train_input(self, *args):
            staged["jax"] = args

        def optimize_parameters(self):
            pass

        def get_current_losses(self):
            return {}

    monkeypatch.setattr(j_quick, "TSNet", Recorder)
    j_quick.main(["--toy"])
    inner = TSNet.set_train_input

    def record(self, *args, **kwargs):
        staged["port"] = args
        return inner(self, *args, **kwargs)

    monkeypatch.setattr(TSNet, "set_train_input", record)
    model = quick_start.main(["--toy"], device="cpu")
    assert staged["jax_setup"] == (0, 4, 100, 10000, 1.0)
    assert len(staged["port"]) == len(staged["jax"]) == 6
    for got, want in zip(staged["port"], staged["jax"]):
        for a, b in zip(got if isinstance(got, list) else [got],
                        want if isinstance(want, list) else [want]):
            np.testing.assert_array_equal(a, b)
    losses = model.get_current_losses()
    j_keys = list(JTSNet(j_toy_config(), is_train=False).get_current_losses())
    assert list(losses) == j_keys
    assert model.state.step == 1
    assert all(np.isfinite(v) for v in losses.values())


@pytest.mark.parametrize("fast_tail", [False, True], ids=["f32", "bf16_tail"])
def test_profile_stages_compose_to_forward_clip(fast_tail, tmp_path,
                                                monkeypatch):
    """The clip profile reads the stages that compose `tsnet_forward_clip`
    from the entry point's own spans: each of the five once a call, at
    ms >= 0, and `sum_ms` their sum; its trace is written."""
    monkeypatch.chdir(tmp_path)
    cfg = toy_config()
    argv = ["--frames", "3", "--size", str(cfg.image_size), "--n-source",
            str(cfg.n_source)] + ([] if fast_tail else ["--no-fast-tail"])
    res = profile_stages.main(argv, device="cpu", base_config=cfg)
    assert tuple(res["stage_ms"]) == profile_stages.CLIP_SPANS
    assert all(n == 1 for n in res["count"].values()), res["count"]
    assert all(ms >= 0 for ms in res["stage_ms"].values())
    assert res["sum_ms"] == sum(res["stage_ms"].values())
    assert os.path.isfile(tmp_path / profile_stages.TRACE_DIR / "trace.json")


def test_profile_stages_reads_each_train_phase_once_a_step(tmp_path,
                                                           monkeypatch):
    """The train profile reads `make_train_step`'s six phase spans and
    the step's own span, each once a step, at ms >= 0; `sum_ms` is the
    phases' sum."""
    monkeypatch.chdir(tmp_path)
    res = profile_stages.main(["--train", "--batch-size", "2",
                               "--precision", "highest"], device="cpu",
                              base_config=toy_config())
    names = profile_stages.TRAIN_SPANS + (profile_stages.STEP_SPAN,)
    assert tuple(res["stage_ms"]) == names
    assert all(n == 1 for n in res["count"].values()), res["count"]
    assert all(ms >= 0 for ms in res["stage_ms"].values())
    assert res["sum_ms"] == sum(res["stage_ms"][name]
                                for name in profile_stages.TRAIN_SPANS)


def test_entry_points_refuse_cuda_less_device(face_pair, snapshot_dir,
                                              tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    out = ["--out-dir", str(tmp_path)]
    calls = [
        lambda: demo_face.main(["--data-root", face_pair, "--subject",
                                "subject", "--driving", "driving"] + out,
                               base_config=toy_config()),
        lambda: eval_snapshots.main(["--snapshot-dir", snapshot_dir] + out,
                                    base_config=toy_config()),
        lambda: quick_start.main(["--toy"]),
        lambda: profile_stages.main(["--frames", "2"]),
        lambda: profile_stages.main(["--train"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_profiling_helpers(tmp_path):
    log_dir = str(tmp_path / "trace")
    with trace(log_dir) as prof:
        with span("tsnet_region"):
            torch.ones(8).sum()
    assert "tsnet_region" in open(os.path.join(log_dir, "trace.json")).read()
    assert any(e.key == "tsnet_region" for e in prof.key_averages())
    got = spans()["tsnet_region"]
    assert got["count"] == 1 and got["self_ms"] == got["ms"] >= 0.0
    with span("tsnet_region"):          # no profiler: not recorded
        torch.ones(8).sum()
    assert spans()["tsnet_region"]["count"] == 1
