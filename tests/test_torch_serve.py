"""The port's keypoint serving path against the JAX package's (CPU, toy
config): the on-device face rasterizer, the extent bbox,
`RetargetSession.push_keypoints`, and the HTTP server (the nine cases of
tests/test_serve.py on the port's `Server`, and one payload answered by
both servers). The same flax weights go to both packages through
`compat.flax_params`. `pytest -s` prints each measured agreement.
"""

import base64
import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wacv23_tsnet_tpu.cli.serve import Server as JServer
from wacv23_tsnet_tpu.cli.serve import make_handler as j_make_handler
from wacv23_tsnet_tpu.configs import toy_config as j_toy_config
from wacv23_tsnet_tpu.data.face import render_face_edges
from wacv23_tsnet_tpu.data.rasterize_jax import (
    rasterize_face_clip as j_rasterize_face_clip)
from wacv23_tsnet_tpu.infer.streaming import RetargetSession as JSession
from wacv23_tsnet_tpu.models import TSNetModules as JTSNetModules
from wacv23_tsnet_tpu_torch.cli.serve import Server, make_handler
from wacv23_tsnet_tpu_torch.compat import load_flax_params
from wacv23_tsnet_tpu_torch.configs import toy_config
from wacv23_tsnet_tpu_torch.data.rasterize_device import rasterize_face_clip
from wacv23_tsnet_tpu_torch.infer import RetargetSession
from wacv23_tsnet_tpu_torch.models import TSNetModules

torch.set_num_threads(2)
CFG = toy_config()
HW = CFG.image_size
S = CFG.n_source
N_FRAMES = 3
CHUNK = 4  # > N_FRAMES: the JAX server wraps the chunk, the port runs 3


def _report(**values):
    name = os.environ.get("PYTEST_CURRENT_TEST", "").split()[0]
    print(f"[serve] {name}: " + " ".join(f"{k}={v}" for k, v in
                                         values.items()))


def _face_landmarks(rng, f, hw):
    """f face-like 68-landmark sets inside an hw x hw crop: a jaw arc,
    brows, nose, eyes and lips in the 68-point order, seeded scale,
    shift and jitter."""
    def arc(n, cx, cy, rx, ry, t0, t1):
        t = np.linspace(t0, t1, n)
        return np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)], 1)

    base = np.concatenate([
        arc(17, 0, 0.15, 0.42, 0.5, np.pi, 0.0)[::-1] * [1, -1] + [0, 0.3],
        arc(5, -0.2, -0.22, 0.12, 0.05, np.pi, 2 * np.pi),       # brows
        arc(5, 0.2, -0.22, 0.12, 0.05, np.pi, 2 * np.pi),
        np.stack([np.zeros(4), np.linspace(-0.12, 0.08, 4)], 1),  # nose
        arc(5, 0, 0.1, 0.08, 0.03, np.pi * 0.9, np.pi * 0.1),
        arc(7, -0.18, -0.1, 0.07, 0.03, np.pi, 3 * np.pi)[:6],   # eyes
        arc(7, 0.18, -0.1, 0.07, 0.03, np.pi, 3 * np.pi)[:6],
        arc(13, 0, 0.28, 0.16, 0.07, np.pi, 3 * np.pi)[:12],     # lips
        arc(9, 0, 0.28, 0.1, 0.03, np.pi, 3 * np.pi)[:8],
    ])
    scale = rng.uniform(0.55, 0.75, (f, 1, 1)) * hw
    centre = hw / 2 + rng.uniform(-0.05, 0.05, (f, 1, 2)) * hw
    jitter = rng.normal(0, 0.004, (f, 68, 2)) * hw
    return (base[None] * scale + centre + jitter).astype(np.float32)


def _keypoints(rng, f, hw=HW):
    # landmarks inside the crop, in pixel coords (tests/test_serve.py)
    return rng.uniform(8, hw - 8, (f, 68, 2))


def _agreement(got, want):
    inter = ((got > 0) & (want > 0)).sum()
    union = ((got > 0) | (want > 0)).sum()
    return float((got == want).mean()), float(inter / union)


# ------------------------------------------------------------ rasterizer

@pytest.mark.parametrize("hw, bw", [(64, 1), (64, 2), (256, 1), (256, 2)])
def test_rasterizer_matches_jax(hw, bw):
    """Uniform in-crop landmarks and face-like ones through the port's
    rasterizer (CPU) and JAX `rasterize_face_clip`."""
    rng = np.random.default_rng(hw + bw)
    kp = np.concatenate([_keypoints(rng, 3, hw).astype(np.float32),
                         _face_landmarks(rng, 3, hw)])
    width = np.full((len(kp),), bw, np.float32)
    want = np.asarray(j_rasterize_face_clip(jnp.asarray(kp),
                                            jnp.asarray(width), h=hw, w=hw))
    got = rasterize_face_clip(torch.from_numpy(kp), torch.from_numpy(width),
                              hw, hw)
    assert got.dtype == torch.int32 and got.shape == (len(kp), hw, hw)
    got = got.numpy()
    agree, iou = _agreement(got, want)
    _report(exact=bool(np.array_equal(got, want)),
            pixels_differing=int((got != want).sum()), agreement=agree,
            iou=iou)
    assert want.sum() > 0
    assert agree >= 0.9999 and iou >= 0.999


@pytest.mark.parametrize("hw, bw", [(64, 1), (64, 2), (256, 1), (256, 2)])
def test_rasterizer_equals_jax_op_by_op(hw, bw):
    """The port evaluates JAX's expressions one operation at a time, each
    rounded once, as JAX does without `jit`: bit for bit the same maps.
    (The jitted program fuses the expressions and can round a few pixels'
    window bounds the other way; `test_rasterizer_matches_jax` bounds
    that.)"""
    rng = np.random.default_rng(hw + bw)
    kp = np.concatenate([_keypoints(rng, 3, hw).astype(np.float32),
                         _face_landmarks(rng, 3, hw),
                         _request()[1]])
    width = np.full((len(kp),), bw, np.float32)
    with jax.disable_jit():
        want = np.asarray(j_rasterize_face_clip(
            jnp.asarray(kp), jnp.asarray(width), h=hw, w=hw))
    got = rasterize_face_clip(torch.from_numpy(kp), torch.from_numpy(width),
                              hw, hw).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw, bw", [(64, 1), (64, 2), (256, 1), (256, 2)])
def test_rasterizer_matches_the_host_tier(hw, bw):
    """Against the numpy tier `render_face_edges`, with the JAX test's own
    bounds (tests/test_rasterize_jax.py: IoU > 0.99, pixels > 0.999)."""
    kp = _face_landmarks(np.random.default_rng(10 * hw + bw), 4, hw)
    got = rasterize_face_clip(torch.from_numpy(kp),
                              torch.full((len(kp),), float(bw)), hw,
                              hw).numpy()
    host = np.stack([render_face_edges(k.astype(np.float64), (hw, hw), bw=bw)
                     > 0 for k in kp]).astype(np.int32)
    agree, iou = _agreement(got, host)
    _report(agreement=agree, iou=iou)
    assert got.sum() > 0
    assert iou > 0.99 and agree > 0.999


def test_face_bbox_mask_matches_jax():
    """The host form of the extent bbox, a copy of the JAX package's."""
    from wacv23_tsnet_tpu.data.face import face_bbox_mask as j_mask
    from wacv23_tsnet_tpu_torch.data.face import face_bbox_mask
    rng = np.random.default_rng(8)
    for kp in (_keypoints(rng, 1, 64)[0], rng.uniform(-10, 74, (68, 2))):
        np.testing.assert_array_equal(face_bbox_mask(kp, (64, 64)),
                                      j_mask(kp, (64, 64)))


def test_extent_bbox_matches_jax():
    rng = np.random.default_rng(4)
    kp = np.concatenate([_keypoints(rng, 3, 64),
                         rng.uniform(-10, 74, (3, 68, 2))]).astype(np.float32)
    want = np.asarray(JSession._extent_bbox(jnp.asarray(kp[..., 0]),
                                            jnp.asarray(kp[..., 1]), 64))
    t = torch.from_numpy(kp)
    got = RetargetSession._extent_bbox(t[..., 0], t[..., 1], 64)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------- sessions

@pytest.fixture(scope="module")
def weights():
    """Toy generator params of the JAX package, and port modules on the
    CPU carrying them."""
    params = JTSNetModules(j_toy_config()).init_generator_params(
        jax.random.PRNGKey(0))
    mods = TSNetModules(CFG, device="cpu", seed=1)
    load_flax_params(mods, jax.tree.map(np.asarray, params))
    return params, mods


def _label_agreement(kp, bw):
    """Per frame, do the port's rasterizer (CPU) and the jitted JAX one
    give the same label map; and the pixel agreement over all frames. A
    frame whose maps differ (a few pixels: the rasterizer tests bound
    them) decodes to another frame altogether under random weights, whose
    temp-100 attention turns any change of the label features into
    another flow (ROADMAP.md, the fast tiers' drift)."""
    hw = CFG.image_size
    want = np.asarray(j_rasterize_face_clip(jnp.asarray(kp), jnp.asarray(bw),
                                            h=hw, w=hw))
    got = rasterize_face_clip(torch.from_numpy(kp), torch.from_numpy(bw),
                              hw, hw).numpy()
    return (got == want).all(axis=(1, 2)), float((got == want).mean())


def _port_labels(kp, bw):
    """The port's label maps (CPU rasterizer) of `kp`, and JAX's extent
    bboxes: what JAX's `push_labels` decodes to hold every frame of the
    port's keypoint path against JAX's decode."""
    lbl = rasterize_face_clip(torch.from_numpy(kp), torch.from_numpy(bw),
                              HW, HW).numpy()
    bbox = np.asarray(JSession._extent_bbox(jnp.asarray(kp[..., 0]),
                                            jnp.asarray(kp[..., 1]), HW))
    return lbl, bbox


def _sources(rng):
    return (rng.random((S, HW, HW, 3)).astype(np.float32),
            rng.integers(0, 2, (S, HW, HW, CFG.label_nc)).astype(np.float32),
            rng.integers(0, 2, (S, HW, HW)).astype(np.float32))


@pytest.mark.parametrize("output", ["model", "display"])
def test_push_keypoints_matches_jax(weights, output):
    """7 frames in chunks of 4 (the JAX session wraps its last chunk, the
    port runs it at 3): model space within 1e-3 max abs (the bit-parity
    tier's bound), display frames within 1 LSB. Every frame is held
    against JAX's decode of the port's label maps and extent bboxes; JAX's
    own `push_keypoints` on the frames whose label maps agree, at most
    one frame left out."""
    params, mods = weights
    rng = np.random.default_rng(5)
    src = _sources(rng)
    kp = np.concatenate([_keypoints(rng, 4), _face_landmarks(rng, 3, HW)]
                        ).astype(np.float32)
    bw = np.asarray([1, 2, 1, 2, 1, 1, 2], np.float32)
    jsess = JSession(j_toy_config(), params, *src, chunk=CHUNK,
                     output=output)
    want = np.asarray(jsess.push_keypoints(kp, bw))
    want_all = np.asarray(jsess.push_labels(*_port_labels(kp, bw)))
    got = RetargetSession(mods, *src, chunk=CHUNK, output=output,
                          device="cpu").push_keypoints(kp, bw)
    assert got.shape == want.shape == want_all.shape == (7, HW, HW, 3)
    assert got.dtype == want.dtype == want_all.dtype
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


def test_push_keypoints_refuses_the_pose_task():
    mods = TSNetModules(dataclasses.replace(CFG, task="pose"), device="cpu")
    rng = np.random.default_rng(0)
    sess = RetargetSession(mods, *_sources(rng), device="cpu")
    with pytest.raises(NotImplementedError, match="pose"):
        sess.push_keypoints(_keypoints(rng, 2))


def test_session_inputs_match_the_jax_server(weights):
    """A /session payload as the port's server reads it: the labels
    one-hot as the JAX server's codec gives them (out-of-range classes
    to all-zero rows), the images and bboxes as it converts them."""
    from wacv23_tsnet_tpu.data.codecs import labels_to_onehot
    _, mods = weights
    payload = _session_payload(np.random.default_rng(9))
    payload["src_lbl"][0][0][:3] = [2, 7, 255]
    src_img, src_lbl, src_bbox = Server(CFG, mods).session_inputs(payload)
    want = np.transpose(labels_to_onehot(
        np.asarray(payload["src_lbl"], np.uint8), CFG.task), (0, 2, 3, 1))
    assert src_lbl.dtype == np.float32 and src_lbl.shape == want.shape
    np.testing.assert_array_equal(src_lbl, want)
    np.testing.assert_array_equal(
        src_img, (np.asarray(payload["src_img"], np.uint8).astype(np.float32)
                  - CFG.img_mean_array()) / 255.0)
    np.testing.assert_array_equal(
        src_bbox, np.asarray(payload["src_bbox"], np.float32))


def test_server_refuses_modules_of_another_config(weights):
    _, mods = weights
    with pytest.raises(ValueError, match="another config"):
        Server(dataclasses.replace(CFG, fast_tail=True), mods)


# ---------------------------------------------------------------- HTTP

def _post(url, payload, raw=None):
    body = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _get(url):
    try:
        with urllib.request.urlopen(url) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _start(server, handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def served(weights):
    _, mods = weights
    server = Server(CFG, mods, chunk=CHUNK)
    httpd, thread, base = _start(server, make_handler)
    yield base, server
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _session_payload(rng):
    return {
        "src_img": rng.integers(0, 256, (S, HW, HW, 3)).tolist(),
        "src_lbl": rng.integers(0, CFG.label_nc, (S, HW, HW)).tolist(),
        "src_bbox": rng.integers(0, 2, (S, HW, HW)).tolist(),
    }


def _request():
    """The payloads of `test_port_and_jax_servers_answer_alike`: its 4th
    frame's labels differ on 2 pixels between the port and jitted JAX."""
    rng = np.random.default_rng(6)
    payload = _session_payload(rng)
    kp = np.concatenate([_keypoints(rng, 3), _face_landmarks(rng, 2, HW)])
    return payload, kp.astype(np.float32)


def test_healthz(served):
    base, _ = served
    status, body = _get(base + "/healthz")
    assert status == 200 and body["ok"] is True
    assert body["backend"] == "cpu"


def test_session_lifecycle_and_short_chunk(served, weights):
    base, server = served
    _, mods = weights
    rng = np.random.default_rng(0)
    payload = _session_payload(rng)
    status, body = _post(base + "/session", payload)
    assert status == 200
    sid = body["session"]
    assert sid in server.sessions

    kp = _keypoints(rng, N_FRAMES)
    status, body = _post(base + "/frames",
                         {"session": sid, "keypoints": kp.tolist()})
    assert status == 200
    frames = np.asarray(body["frames"], np.uint8)
    assert frames.shape == (N_FRAMES, HW, HW, 3)
    assert body["ms"] > 0

    # the server's chunk (4) holds the whole 3-frame clip; a session of
    # exactly 3 frames, model space, gives the same frames
    mean = CFG.img_mean_array()
    src_img = (np.asarray(payload["src_img"], np.float32) - mean) / 255.0
    src_lbl = np.eye(CFG.label_nc, dtype=np.float32)[
        np.asarray(payload["src_lbl"])]
    src_bbox = np.asarray(payload["src_bbox"], np.float32)
    session = RetargetSession(mods, src_img, src_lbl, src_bbox,
                              chunk=N_FRAMES, device="cpu")
    rec = session.push_keypoints(kp.astype(np.float32))
    want = np.clip(rec + mean / 255.0, 0.0, 1.0)[..., ::-1] * 255.0
    assert np.abs(frames.astype(np.float32) - want).max() <= 1.0  # uint8 LSB


def test_frames_unknown_session(served):
    base, _ = served
    status, body = _post(base + "/frames",
                         {"session": "nope", "keypoints": [[[0, 0]]]})
    assert status == 404 and "unknown session" in body["error"]


def test_session_missing_key_is_400(served):
    base, _ = served
    payload = _session_payload(np.random.default_rng(1))
    del payload["src_lbl"]
    status, body = _post(base + "/session", payload)
    assert status == 400 and "src_lbl" in body["error"]


def test_session_ragged_shape_is_400(served):
    base, _ = served
    payload = _session_payload(np.random.default_rng(2))
    payload["src_img"][0] = payload["src_img"][0][:-1]  # ragged rows
    status, _ = _post(base + "/session", payload)
    assert status == 400


def test_frames_missing_session_key_is_404(served):
    base, _ = served
    status, _ = _post(base + "/frames", {"keypoints": [[[0, 0]]]})
    # payload.get("session") -> None -> not in sessions -> 404 contract
    assert status == 404


def test_frames_wrong_keypoint_shape_is_400(served):
    """The port's server validates the landmarks before any device work
    (a landmark gather out of range would fail inside a GPU kernel)."""
    base, _ = served
    status, body = _post(base + "/session",
                         _session_payload(np.random.default_rng(4)))
    assert status == 200
    status, body = _post(base + "/frames", {"session": body["session"],
                                            "keypoints": [[[0, 0]]]})
    assert status == 400 and "(F, 68, 2)" in body["error"]


def test_malformed_json_is_400(served):
    base, _ = served
    status, _ = _post(base + "/session", None, raw=b"{not json")
    assert status == 400


def test_unknown_paths_are_404(served):
    base, _ = served
    assert _get(base + "/nope")[0] == 404
    assert _post(base + "/nope", {})[0] == 404


def test_frames_base64_encoding(served):
    base, _ = served
    rng = np.random.default_rng(3)
    status, body = _post(base + "/session", _session_payload(rng))
    assert status == 200
    sid = body["session"]
    kp = _keypoints(rng, N_FRAMES)
    status, plain = _post(base + "/frames",
                          {"session": sid, "keypoints": kp.tolist()})
    assert status == 200
    status, b64 = _post(base + "/frames",
                        {"session": sid, "keypoints": kp.tolist(),
                         "encoding": "base64"})
    assert status == 200 and b64["dtype"] == "uint8"
    frames = np.frombuffer(base64.b64decode(b64["frames_b64"]),
                           np.uint8).reshape(b64["shape"])
    np.testing.assert_array_equal(frames,
                                  np.asarray(plain["frames"], np.uint8))


def test_port_and_jax_servers_answer_alike(served, weights):
    """One payload to the port's server and to the JAX one (same
    weights): frames within 1 LSB where both rasterized the same labels
    (`_label_agreement`), at most one frame left out; every frame within
    1 LSB of the JAX server's session decoding the port's label maps."""
    base, _ = served
    params, _ = weights
    jserver = JServer(j_toy_config(), params, chunk=CHUNK)
    jhttpd, jthread, jbase = _start(jserver, j_make_handler)
    try:
        payload, kp = _request()
        frames, sids = [], []
        for url in (base, jbase):
            status, body = _post(url + "/session", payload)
            assert status == 200
            sids.append(body["session"])
            status, body = _post(url + "/frames", {
                "session": body["session"], "keypoints": kp.tolist(),
                "encoding": "base64"})
            assert status == 200
            frames.append(np.frombuffer(base64.b64decode(body["frames_b64"]),
                                        np.uint8).reshape(body["shape"]))
    finally:
        jhttpd.shutdown()
        jhttpd.server_close()
        jthread.join(timeout=30)
    assert frames[0].shape == frames[1].shape == (5, HW, HW, 3)
    ones = np.ones(len(kp), np.float32)
    want_all = np.asarray(jserver.sessions[sids[1]].push_labels(
        *_port_labels(kp, ones)))[..., ::-1]
    got = frames[0].astype(np.int16)
    same, agree = _label_agreement(kp, ones)
    err = int(np.abs(got[same] - frames[1][same]).max())
    err_all = int(np.abs(got - want_all).max())
    _report(max_levels=err, max_levels_every_frame=err_all,
            frames_with_other_labels=int((~same).sum()),
            label_agreement=agree)
    assert err_all <= 1
    assert agree >= 0.9999 and same.sum() >= len(same) - 1
    assert err <= 1
