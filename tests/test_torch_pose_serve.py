"""Pose serving in the port against the JAX package (CPU, a toy pose
model with the 25 pose classes): `RetargetSession.push_keypoints` on
(F, 137, 2) OpenPose points and the pose `Server`. The same flax weights
go to both packages through `compat.flax_params`. Jitted JAX fuses the
rasterizer's expressions and can move a pixel or two against the port
(which equals it op by op, tests/test_torch_pose_data.py); with random
weights that moves a whole frame, so every frame is held against JAX's
decode (`push_labels`) of the port's label maps, and JAX's own keypoint
path on all frames but at most one, as tests/test_torch_serve.py holds
the face path. `pytest -s` prints the errors.
"""

import base64
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_pose_dance import LOW_CONF, TWO_PEOPLE, write_dance_set
from wacv23_tsnet_tpu.cli.serve import Server as JServer
from wacv23_tsnet_tpu.configs import toy_pose_config as j_toy_pose_config
from wacv23_tsnet_tpu.data import rasterize as j_ras
from wacv23_tsnet_tpu.data.rasterize_jax import (
    rasterize_pose_clip as j_rasterize_pose_clip)
from wacv23_tsnet_tpu.infer.streaming import RetargetSession as JSession
from wacv23_tsnet_tpu.models import TSNetModules as JTSNetModules
from wacv23_tsnet_tpu_torch.cli.serve import Server
from wacv23_tsnet_tpu_torch.compat import load_flax_params
from wacv23_tsnet_tpu_torch.configs import toy_pose_config
from wacv23_tsnet_tpu_torch.data.rasterize_device import rasterize_pose_clip
from wacv23_tsnet_tpu_torch.infer import RetargetSession
from wacv23_tsnet_tpu_torch.models import TSNetModules

torch.set_num_threads(2)
CFG = dataclasses.replace(toy_pose_config(), label_nc=25)
J_CFG = dataclasses.replace(j_toy_pose_config(), label_nc=25)


def _report(**values):
    name = os.environ.get("PYTEST_CURRENT_TEST", "").split()[0]
    print(f"[pose_serve] {name}: " + " ".join(f"{k}={v}" for k, v in
                                              values.items()))


@pytest.fixture(scope="module")
def dance(tmp_path_factory):
    return str(write_dance_set(str(tmp_path_factory.mktemp("dance"))))


# ---------------------------------------------------------------- serving

HW = CFG.image_size


@pytest.fixture(scope="module")
def weights():
    """Toy pose generator params of the JAX package, and port modules on
    the CPU carrying them."""
    params = JTSNetModules(J_CFG).init_generator_params(
        jax.random.PRNGKey(0))
    mods = TSNetModules(CFG, device="cpu", seed=1)
    load_flax_params(mods, jax.tree.map(np.asarray, params))
    return params, mods


def _pose_keypoints(dance, f):
    """f frames of (137, 2) validated keypoints inside the toy crop, with
    some points undetected (zeros)."""
    out = []
    for i in range(f):
        vid = (5, TWO_PEOPLE, LOW_CONF)[i % 3]
        path = os.path.join(dance, "labels", "%05d" % vid,
                            f"frame{i % 8:06d}_keypoints.json")
        p = j_ras.parse_openpose_json(path)[0]
        pts = np.concatenate([j_ras.valid_keypoints(p[k]) for k in (
            "pose", "face", "hand_l", "hand_r")])
        valid = np.all(pts != 0, axis=1, keepdims=True)
        # the figure's box (x 70-230, y 90-430) into the 64^2 crop
        local = (pts - [60.0, 80.0]) * (HW / 360.0)
        out.append(np.where(valid, local, 0.0))
    return np.stack(out).astype(np.float32)


def _sources(rng):
    return (rng.random((CFG.n_source, HW, HW, 3)).astype(np.float32),
            np.eye(25, dtype=np.float32)[rng.integers(
                0, 25, (CFG.n_source, HW, HW))],
            rng.integers(0, 2, (CFG.n_source, HW, HW)).astype(np.float32))


def _pose_parts(kp, bw):
    return (kp[:, :25], kp[:, 25:95], kp[:, 95:116], kp[:, 116:137], bw,
            np.maximum(bw / 3.0, 1.0).astype(np.float32))


def _port_labels(kp, bw):
    """The port's label maps (CPU rasterizer) and the JAX session's pose
    extent bboxes of `kp`: what JAX's `push_labels` decodes to hold every
    frame of the port's keypoint path against JAX's decode."""
    lbl = rasterize_pose_clip(*(torch.from_numpy(x) for x in _pose_parts(
        kp, bw)), HW, HW).numpy()
    k = jnp.asarray(kp)
    valid = jnp.all(k != 0, axis=-1)
    xs, ys = k[..., 0], k[..., 1]
    bbox = np.asarray(JSession._extent_bbox(
        jnp.stack([jnp.min(jnp.where(valid, xs, jnp.inf), 1),
                   jnp.max(jnp.where(valid, xs, -jnp.inf), 1)], 1),
        jnp.stack([jnp.min(jnp.where(valid, ys, jnp.inf), 1),
                   jnp.max(jnp.where(valid, ys, -jnp.inf), 1)], 1), HW))
    return lbl, bbox


def _label_agreement(kp, bw):
    want = np.asarray(j_rasterize_pose_clip(
        *(jnp.asarray(x) for x in _pose_parts(kp, bw)), h=HW, w=HW))
    got = _port_labels(kp, bw)[0]
    return (got == want).all(axis=(1, 2)), float((got == want).mean())


@pytest.mark.parametrize("output", ["model", "display"])
def test_push_keypoints_pose_matches_jax(dance, weights, output):
    """7 frames in chunks of 4: every frame within 1e-3 (model space) or
    1 LSB (display) of JAX's decode of the port's label maps and pose
    extent bboxes, and of JAX's own `push_keypoints` on the frames whose
    label maps agree (at most one left out)."""
    params, mods = weights
    rng = np.random.default_rng(5)
    src = _sources(rng)
    kp = _pose_keypoints(dance, 7)
    kp[6] = 0.0                              # nobody detected
    bw = np.asarray([1, 2, 3, 1, 4, 1, 2], np.float32)
    jsess = JSession(J_CFG, params, *src, chunk=4, output=output)
    want = np.asarray(jsess.push_keypoints(kp, bw))
    want_all = np.asarray(jsess.push_labels(*_port_labels(kp, bw)))
    got = RetargetSession(mods, *src, chunk=4, output=output,
                          device="cpu").push_keypoints(kp, bw)
    assert got.shape == want.shape == (7, HW, HW, 3)
    assert got.dtype == want.dtype
    got = got.astype(np.float64)
    same, agree = _label_agreement(kp, bw)
    err = float(np.abs(got[same] - want[same]).max())
    err_all = float(np.abs(got - want_all).max())
    _report(max_abs=err, max_abs_every_frame=err_all,
            frames_with_other_labels=int((~same).sum()),
            label_agreement=agree)
    tol = 1e-3 if output == "model" else 1.0
    assert err_all <= tol
    assert agree >= 0.9999 and same.sum() >= len(same) - 1
    assert err <= tol


def test_pose_server_answers_like_jax(dance, weights):
    """A pose `Server` (no brush widths: 1) on one session and request,
    against the JAX pose server's session on the port's label maps."""
    params, mods = weights
    rng = np.random.default_rng(6)
    payload = {"src_img": rng.integers(0, 256, (2, HW, HW, 3)).tolist(),
               "src_lbl": rng.integers(0, 25, (2, HW, HW)).tolist(),
               "src_bbox": rng.integers(0, 2, (2, HW, HW)).tolist()}
    kp = _pose_keypoints(dance, 3)
    server, jserver = Server(CFG, mods, chunk=4), JServer(J_CFG, params,
                                                          chunk=4)
    sid, jsid = server.create_session(payload), jserver.create_session(
        payload)
    body = server.run_frames({"session": sid, "keypoints": kp.tolist(),
                              "encoding": "base64"})
    got = np.frombuffer(base64.b64decode(body["frames_b64"]),
                        np.uint8).reshape(body["shape"])
    assert got.shape == (3, HW, HW, 3)
    ones = np.ones(3, np.float32)
    want = np.asarray(jserver.sessions[jsid].push_labels(
        *_port_labels(kp, ones)))[..., ::-1]
    err = int(np.abs(got.astype(int) - want).max())
    _report(max_levels=err)
    assert err <= 1
    with pytest.raises(ValueError, match="137"):
        server.run_frames({"session": sid, "keypoints": kp[:, :68].tolist()})
