"""A train step that gives the same bits on every call (CPU).

- K4's da: on the card a stable counting sort buckets each (group,
  source)'s 4 F T bilinear corner contributions by the source pixel they
  hit, and one warp a pixel sums its bucket in that order
  (`csrc/transform_warp_bwd.cu`, da_sort and da_sum). The CUDA kernel
  cannot run here, so a numpy model of that order (keys, stable ranks
  taken 32 items a step as the kernel's warp takes them, the scan, the
  placement, the in-order sums) is held against the JAX package's K4 in
  interpret mode, the port's plain da and the JAX and port grid_sample
  VJPs, and its sums against a sequential sum in item order.
- `sample_separable` (the pose variant's `crop_faces`): the forward is the
  gather form bit for bit; the backward, two matmuls of the transposed
  interpolation weights, against `jax.vjp` of the JAX crop.
- `ops.precision.deterministic_cudnn` around the train step: cuDNN's
  flags inside it, and the caller's afterwards, also when the step raises.

`pytest -s` prints each measured error.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wacv23_tsnet_tpu.models.tsnet import crop_faces as j_crop_faces
from wacv23_tsnet_tpu.ops.grid_sample import grid_sample as j_grid_sample
from wacv23_tsnet_tpu.ops.pallas_similarity import (
    transform_warp_pairs as j_warp_pairs)
from wacv23_tsnet_tpu_torch.configs import toy_config
from wacv23_tsnet_tpu_torch.models.tsnet import crop_faces
from wacv23_tsnet_tpu_torch.ops.grid_sample import grid_sample
from wacv23_tsnet_tpu_torch.ops.precision import deterministic_cudnn
from wacv23_tsnet_tpu_torch.ops.resize import _gather_axis, sample_separable
from wacv23_tsnet_tpu_torch.ops.warp_kernels import (
    transform_warp_pairs_bwd_plain, transform_warp_pairs_plain)
from wacv23_tsnet_tpu_torch.train import create_train_state, make_train_step
from wacv23_tsnet_tpu_torch.train import step as train_step_module

torch.set_num_threads(2)
WARP = 32      # items a step of da_sort's ranking warp


def _report(**errors):
    name = os.environ.get("PYTEST_CURRENT_TEST", "").split()[0]
    print(f"[parity] {name}: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in errors.items()))


# ------------------------------------------------------- K4's da order

def _taps(flow, h, w):
    """Each flow row's corner pixels (-1 off the canvas) and weights, as
    grid_sample takes them: corner q is (y0 + q // 2, x0 + q % 2).
    flow (..., 2) f32 -> (..., 4) int, (..., 4) f32."""
    f = flow.astype(np.float32)
    ix = ((f[..., 0] + np.float32(1)) * np.float32(w) - np.float32(1)) \
        * np.float32(0.5)
    iy = ((f[..., 1] + np.float32(1)) * np.float32(h) - np.float32(1)) \
        * np.float32(0.5)
    x0, y0 = np.floor(ix), np.floor(iy)
    wx, wy = ix - x0, iy - y0
    one = np.float32(1)
    xs = x0.astype(np.int64)[..., None] + np.array([0, 1, 0, 1])
    ys = y0.astype(np.int64)[..., None] + np.array([0, 0, 1, 1])
    weight = np.stack([(one - wy) * (one - wx), (one - wy) * wx,
                       wy * (one - wx), wy * wx], -1).astype(np.float32)
    inside = (xs >= 0) & (xs <= w - 1) & (ys >= 0) & (ys <= h - 1)
    return np.where(inside, ys * w + xs, -1), weight


def _fma(a, b, c):
    """a * b + c rounded once to f32 (the kernel's fmaf), through f64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def da_order_model(flow, gw, h, w):
    """K4's da as da_sort and da_sum compute it, per (group, source):
    keys of the items k = 4 (f T + t) + q, ranks taken in k order WARP
    items a step (a step's equal keys rank by lane after the earlier
    steps' count), the exclusive scan of the counts, each item placed at
    offset + rank, then each pixel's bucket summed in order.

    flow (G, S, F, T, 2), gw (G, S, F, T, C). Returns da (G, S, T, C) and
    each (group, source)'s (order, offsets)."""
    g, s, nf, t, c = gw.shape
    keys, weights = _taps(flow, h, w)                   # (G, S, F, T, 4)
    da = np.zeros((g, s, t, c), np.float32)
    buckets = {}
    for gi in range(g):
        for si in range(s):
            key = keys[gi, si].reshape(-1)              # k order
            wq = weights[gi, si].reshape(-1)
            rows = gw[gi, si].reshape(nf * t, c)
            n = key.size
            count = np.zeros(t, np.int64)
            rank = np.full(n, -1, np.int64)
            for base in range(0, n, WARP):
                step = key[base:base + WARP]
                seen = {}
                for lane, u in enumerate(step):
                    if u < 0:
                        continue
                    rank[base + lane] = count[u] + seen.get(u, 0)
                    seen[u] = seen.get(u, 0) + 1
                for u, m in seen.items():
                    count[u] += m
            offs = np.concatenate([[0], np.cumsum(count)])
            order = np.full(offs[-1], -1, np.int64)
            hit = key >= 0
            order[offs[key[hit]] + rank[hit]] = np.flatnonzero(hit)
            for u in range(t):
                acc = np.zeros(c, np.float32)
                for k in order[offs[u]:offs[u + 1]]:
                    acc = _fma(wq[k], rows[k // 4], acc)
                da[gi, si, u] = acc
            buckets[gi, si] = (order, offs)
    return da, buckets


def _da_in_item_order(flow, gw, h, w):
    """da summed item by item in k order, each pixel its own sum."""
    g, s, nf, t, c = gw.shape
    keys, weights = _taps(flow, h, w)
    da = np.zeros((g, s, t, c), np.float32)
    for gi in range(g):
        for si in range(s):
            key = keys[gi, si].reshape(-1)
            wq = weights[gi, si].reshape(-1)
            rows = gw[gi, si].reshape(nf * t, c)
            for k in np.flatnonzero(key >= 0):
                da[gi, si, key[k]] = _fma(wq[k], rows[k // 4],
                                          da[gi, si, key[k]])
    return da


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(1.0, np.abs(want).max()))


def _assert_stable_buckets(keys, buckets):
    """Every on-canvas item once, in its own pixel's bucket, each bucket
    in increasing k."""
    for (gi, si), (order, offs) in buckets.items():
        key = keys[gi, si].reshape(-1)
        assert sorted(order.tolist()) == np.flatnonzero(key >= 0).tolist()
        for u in range(offs.size - 1):
            items = order[offs[u]:offs[u + 1]]
            assert (key[items] == u).all()
            assert (np.diff(items) > 0).all()


def _pairs_inputs(seed, g, ns, nf, h, w, c):
    rng = np.random.default_rng(seed)
    t = h * w

    def norm(x):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                              1e-12)
    ys, xs = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    src = rng.standard_normal((g, ns, t, c)).astype(np.float32)
    return (src, norm(rng.standard_normal((g, nf, t, c))).astype(np.float32),
            norm(src).astype(np.float32),
            rng.integers(0, 2, (g, nf, t)).astype(np.float32),
            rng.integers(0, 2, (g, ns, t)).astype(np.float32),
            np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32))


def _one_pixel_inputs(seed, g, ns, nf, h, w, c):
    """Every target row of a (group, source) attends to one of its pixels
    alone, on the last row or column: the softmax is exactly one-hot at
    temp 100 and the flow is that pixel's grid point, so every sample
    position is an integer (a cell edge, weights 1 and 0) and the
    corners past the last row or column fall off the canvas."""
    rng = np.random.default_rng(seed)
    t = h * w
    v = rng.standard_normal((g, 1, 1, c))
    v = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    src_n = np.repeat(-v, ns, 1).repeat(t, 2)
    for gi in range(g):
        for si in range(ns):
            j = gi + si
            u = (h - 1) * w + j % w if j % 2 else (j % h) * w + w - 1
            src_n[gi, si, u] = v[gi, 0, 0]
    xs = (2 * np.arange(w) + 1) / w - 1
    ys = (2 * np.arange(h) + 1) / h - 1
    grid = np.stack(np.meshgrid(xs, ys, indexing="xy"), -1).reshape(t, 2)
    return (rng.standard_normal((g, ns, t, c)).astype(np.float32),
            np.repeat(v, nf, 1).repeat(t, 2), src_n,
            np.ones((g, nf, t), np.float32), np.ones((g, ns, t), np.float32),
            grid.astype(np.float32))


# (G, NS, NF, H, W, C, temp, inputs): T = 100 and 96, not multiples of 64
# (both still one Pallas tile, so the JAX side runs its K4 kernel); C = 5
# and 37, not multiples of 4; F = 1 and 2
DA_CASES = {
    "f1_t100_c5": (2, 2, 1, 10, 10, 5, 10.0, _pairs_inputs),
    "f2_t96_c37": (1, 3, 2, 8, 12, 37, 10.0, _pairs_inputs),
    "one_pixel_f2_c37": (2, 2, 2, 8, 8, 37, 100.0, _one_pixel_inputs),
}


@pytest.mark.parametrize("case", list(DA_CASES))
def test_da_order_model_matches_jax_k4_and_the_plain_da(case):
    """The model's da on the port's plain flow against the JAX K4's da
    (interpret mode) and the port's plain da, within K4's 2e-4 of
    max(1, max |reference|); its buckets stable; its sums bit for bit a
    sequential sum in item order."""
    g, ns, nf, h, w, c, temp, make = DA_CASES[case]
    args = make(40 + len(case), g, ns, nf, h, w, c)
    t = h * w
    rng = np.random.default_rng(41)
    gw = rng.standard_normal((g, ns, nf, t, c)).astype(np.float32)
    gf = rng.standard_normal((g, ns, nf, t, 2)).astype(np.float32)
    targs = [torch.from_numpy(a) for a in args]
    _, flow, _ = transform_warp_pairs_plain(*targs, h, w, temp)
    flow = flow.numpy()
    got, buckets = da_order_model(flow, gw, h, w)
    _assert_stable_buckets(_taps(flow, h, w)[0], buckets)
    np.testing.assert_array_equal(got, _da_in_item_order(flow, gw, h, w))
    _, vjp = jax.vjp(functools.partial(j_warp_pairs, h=h, w=w, temp=temp),
                     *map(jnp.asarray, args))
    want_jax = np.asarray(vjp((jnp.asarray(gw), jnp.asarray(gf)))[0])
    want_plain = transform_warp_pairs_bwd_plain(
        *targs, torch.from_numpy(gw), torch.from_numpy(gf), h, w,
        temp)[0].numpy()
    sizes = [offs[1:] - offs[:-1] for _, offs in buckets.values()]
    errs = {"vs_jax_k4": _rel(got, want_jax),
            "vs_plain": _rel(got, want_plain),
            "largest_bucket": int(max(s.max() for s in sizes))}
    _report(**errs)
    assert errs["vs_jax_k4"] <= 2e-4 and errs["vs_plain"] <= 2e-4, errs
    if make is _one_pixel_inputs:
        # all 4 F T items of a (group, source) hit its one pixel or fall
        # off the canvas: a bucket of F T items (weight 1 at the pixel)
        assert errs["largest_bucket"] == nf * t
        assert all((s > 0).sum() <= 4 for s in sizes)


def _flows(kind, rng, b, n, h, w):
    """(B, n, 2) flows: `random` over [-1.2, 1.2] (corners past every
    edge), `edges` exactly on pixel centres and cell edges of a power-of-
    two canvas, `one_pixel` all on one corner pixel, `outside` all off
    the canvas."""
    if kind == "random":
        return rng.uniform(-1.2, 1.2, (b, n, 2)).astype(np.float32)
    if kind == "edges":
        x = rng.integers(-1, 2 * w + 1, (b, n)) / w - 1
        y = rng.integers(-1, 2 * h + 1, (b, n)) / h - 1
        return np.stack([x, y], -1).astype(np.float32)
    if kind == "one_pixel":
        pt = np.array([(2 * (w - 1) + 1) / w - 1, 1 / h - 1], np.float32)
        return np.broadcast_to(pt, (b, n, 2)).copy()
    return np.broadcast_to(np.float32([1.5, -1.5]), (b, n, 2)).copy()


@pytest.mark.parametrize("nf", [1, 2])
@pytest.mark.parametrize("kind", ["random", "edges", "one_pixel", "outside"])
def test_da_order_model_matches_grid_sample_vjps(kind, nf):
    """On given flows (C = 6, T = 8 x 8): the model's da against the VJP of
    the port's grid_sample (autograd) and the JAX grid_sample's `jax.vjp`
    in the image, each source warped into F frames."""
    h, w, c, t = 8, 8, 6, 64
    rng = np.random.default_rng(50 + nf)
    flow = _flows(kind, rng, 2 * nf, t, h, w).reshape(1, 2, nf, t, 2)
    gw = rng.standard_normal((1, 2, nf, t, c)).astype(np.float32)
    img = rng.standard_normal((2, h, w, c)).astype(np.float32)
    got, buckets = da_order_model(flow, gw, h, w)
    _assert_stable_buckets(_taps(flow, h, w)[0], buckets)
    np.testing.assert_array_equal(got, _da_in_item_order(flow, gw, h, w))

    def warp(x):   # (S, H, W, C) -> (S, F, T, C), each frame's flow
        xs = x[:, None].expand(2, nf, h, w, c).reshape(2 * nf, h, w, c)
        return grid_sample(xs, torch.from_numpy(flow).reshape(
            2 * nf, 1, t, 2)).reshape(2, nf, t, c)
    x = torch.from_numpy(img).requires_grad_(True)
    (warp(x) * torch.from_numpy(gw[0])).sum().backward()

    def j_warp(x):
        xs = jnp.broadcast_to(x[:, None], (2, nf, h, w, c)).reshape(
            2 * nf, h, w, c)
        return j_grid_sample(xs, jnp.asarray(flow).reshape(
            2 * nf, 1, t, 2)).reshape(2, nf, t, c)
    _, vjp = jax.vjp(j_warp, jnp.asarray(img))
    want_jax = np.asarray(vjp(jnp.asarray(gw[0]))[0]).reshape(2, t, c)
    errs = {"vs_port_grid_sample": _rel(got[0], x.grad.reshape(2, t, c)),
            "vs_jax_grid_sample": _rel(got[0], want_jax)}
    _report(**errs)
    assert max(errs.values()) <= 1e-6, errs
    if kind == "outside":
        assert not got.any()


# --------------------------------------------------- the crops' backward

def _gather_form(x, ys, xs):
    """`sample_separable` as the gather form, differentiable by autograd."""
    _, h, w, _ = x.shape
    y0 = torch.floor(ys).long().clamp(0, h - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    wy = (ys - y0.to(ys.dtype))[:, :, None, None]
    x0 = torch.floor(xs).long().clamp(0, w - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wx = (xs - x0.to(xs.dtype))[:, None, :, None]
    rows = _gather_axis(x, 1, y0) * (1.0 - wy) + _gather_axis(x, 1, y1) * wy
    return (_gather_axis(rows, 2, x0) * (1.0 - wx)
            + _gather_axis(rows, 2, x1) * wx)


@pytest.mark.parametrize("shape", [(3, 20, 24, 5, 7, 9), (2, 16, 16, 3, 64,
                                                         64)],
                         ids=["down", "up"])
def test_sample_separable_forward_is_the_gather_form_bit_for_bit(shape):
    """Positions inside and outside the image (the clamps); "up" samples
    each source row four times (three or more samples a row)."""
    b, h, w, c, ny, nx = shape
    rng = np.random.default_rng(60)
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(
        np.float32))
    ys = torch.from_numpy((rng.random((b, ny)) * (h + 2) - 1).astype(
        np.float32))
    xs = torch.from_numpy((rng.random((b, nx)) * (w + 2) - 1).astype(
        np.float32))
    g = torch.from_numpy(rng.standard_normal((b, ny, nx, c)).astype(
        np.float32))
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    got, want = sample_separable(xa, ys, xs), _gather_form(xb, ys, xs)
    assert torch.equal(got, want)
    (got * g).sum().backward()
    (want * g).sum().backward()
    err = _rel(xa.grad.numpy(), xb.grad.numpy())
    _report(grad_vs_gather_backward=err)
    assert err <= 1e-6


def _face_labels(hw, nl, boxes):
    """One-hot pose label maps, background 0, a body block of class 5,
    and per sample a face (class nl - 1) over the box (y, x, side)."""
    cls = np.zeros((len(boxes), hw, hw), np.int64)
    u = hw // 16
    for i, (y, x, side) in enumerate(boxes):
        cls[i, 8 * u:14 * u, 6 * u:10 * u] = 5
        cls[i, y:y + side, x:x + side] = nl - 1
    return np.eye(nl, dtype=np.float32)[cls]


def test_crop_faces_gradient_matches_jax_on_small_and_border_faces():
    """256² images, 64² crops: faces of 6 and 10 pixels (boxes of 32 and
    30 -> the 32-pixel floor, so three or more samples share a source row
    and column), one of 30 at the border (its box pushed inside), one of
    40; the forward against the JAX crop and the gradient against
    `jax.vjp`."""
    hw, nl = 256, 25
    lbl = _face_labels(hw, nl, [(100, 120, 6), (60, 70, 10), (0, 0, 30),
                                (240, 230, 16), (90, 100, 40)])
    rng = np.random.default_rng(61)
    img = rng.standard_normal((5, hw, hw, 3)).astype(np.float32)
    ct = rng.standard_normal((5, 64, 64, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: j_crop_faces(x, jnp.asarray(lbl)),
                        jnp.asarray(img))
    (want_g,) = vjp(jnp.asarray(ct))
    x = torch.from_numpy(img).requires_grad_(True)
    got = crop_faces(x, torch.from_numpy(lbl))
    (got * torch.from_numpy(ct)).sum().backward()
    errs = {"crop_max_abs": float(np.abs(got.detach().numpy()
                                         - np.asarray(want)).max()),
            "grad_max_abs": float(np.abs(x.grad.numpy()
                                         - np.asarray(want_g)).max())}
    _report(**errs)
    assert errs["crop_max_abs"] <= 1e-6 and errs["grad_max_abs"] <= 1e-5


# ---------------------------------------------- the step's cuDNN flags

@pytest.fixture
def cudnn_flags():
    """cuDNN's flags set to the opposite of what the step runs with, and
    the process's own put back afterwards."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _flags():
    return torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark


def test_deterministic_cudnn_sets_and_restores_the_flags(cudnn_flags):
    with deterministic_cudnn():
        assert _flags() == (True, False)
        with deterministic_cudnn():
            assert _flags() == (True, False)
        assert _flags() == (True, False)
    assert _flags() == (False, True)
    with pytest.raises(ZeroDivisionError):
        with deterministic_cudnn():
            1 / 0
    assert _flags() == (False, True)


def _toy_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    s, hw, nl = cfg.n_source, cfg.image_size, cfg.label_nc
    return {"src_img": rng.random((1, s, hw, hw, 3), np.float32),
            "src_lbl": rng.integers(0, 2, (1, s, hw, hw, nl)).astype(
                np.float32),
            "src_bbox": np.ones((1, s, hw, hw), np.float32),
            "tar_img": rng.random((1, hw, hw, 3), np.float32),
            "tar_lbl": rng.integers(0, 2, (1, hw, hw, nl)).astype(
                np.float32),
            "tar_bbox": np.ones((1, hw, hw), np.float32)}


def test_train_step_runs_under_deterministic_cudnn(cudnn_flags,
                                                   monkeypatch):
    """Each of the six phases of a toy step (CPU) opens its span under
    deterministic cuDNN; the caller's flags come back after the step and
    after a step that raises (in its grad hook, before the first Adam
    update)."""
    cfg = dataclasses.replace(toy_config(), image_size=32)
    state = create_train_state(cfg, device="cpu", seed=0)
    seen = []
    inner = train_step_module.span

    def span(name, device=None):
        seen.append((name, _flags()))
        return inner(name, device)

    monkeypatch.setattr(train_step_module, "span", span)
    make_train_step(state)(state, _toy_batch(cfg), 2e-4)
    phases = [flags for name, flags in seen if name != "tsnet.train.step"]
    assert len(phases) == 6 and set(phases) == {(True, False)}
    assert _flags() == (False, True)

    def fail(opt):
        raise RuntimeError("hook")
    with pytest.raises(RuntimeError, match="hook"):
        make_train_step(state, grad_hook=fail)(state, _toy_batch(cfg), 2e-4)
    assert _flags() == (False, True)
