"""The port's ring-pad convs (`ops/reflectconv.py`, `TSNetConfig.ring_pad`)
against its padded formulation and against the JAX package's ring path
(CPU).

The five cases of tests/test_ring_pad.py with its bars: the raw op
(relative error 1e-5, interiors bit-identical to the padded conv), its
gradients (1e-5), the ResNet block (1e-5), the train forward and the
generator gradients (relative error 1e-4, cosine > 0.9999) and the clip
(relative error 5e-4). Each holds the port's ring path against the
port's pad path and against the JAX ring path on the same seeded inputs
and flax weights (`compat.flax_params`). The clip runs at the toy
config's own softmax temperature (100), as the JAX test does. The train
forward runs at temperature 10: at 100 the attention of random toy
features is near one-hot, and the pad path's reconstruction alone moves
by 1.8e-4 relative under a 1e-6 input nudge, above the 1e-4 bar; the
train test prints that and the ring path against the pad path at 100
(1.2e-4) beside what it holds at 10 (tests/test_torch_train_step.py
runs both temperatures). The op's range (p >= 1, H and W > 2p) is held
at its edge against the padded conv, refused outside it, and shown to
hold every reflect conv of the toy, face and pose configs with
`ring_pad` on. `pytest -s` prints each measured error.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wacv23_tsnet_tpu.configs import toy_config as j_toy_config
from wacv23_tsnet_tpu.models import TSNetModules as JTSNetModules
from wacv23_tsnet_tpu.models.tsnet import tsnet_forward as j_tsnet_forward
from wacv23_tsnet_tpu.models.tsnet import (
    tsnet_forward_clip as j_tsnet_forward_clip)
from wacv23_tsnet_tpu.nn.blocks import ResnetBlock as JResnetBlock
from wacv23_tsnet_tpu.ops.reflectconv import (
    conv2d_reflect_dp as j_conv2d_reflect_dp)
from wacv23_tsnet_tpu_torch.compat import load_flax_params, state_dict_to_flax
from wacv23_tsnet_tpu_torch.configs import face_config, pose_config, toy_config
from wacv23_tsnet_tpu_torch.models import (TSNetModules, tsnet_forward,
                                           tsnet_forward_clip)
from wacv23_tsnet_tpu_torch.nn import blocks
from wacv23_tsnet_tpu_torch.nn.blocks import ResnetBlock, conv2d, reflect_pad
from wacv23_tsnet_tpu_torch.ops.reflectconv import conv2d_reflect_dp
from wacv23_tsnet_tpu_torch.train import GEN_SUBNETS

torch.set_num_threads(2)
TRAIN_TEMP = 10.0
KEYS = ("src_img", "src_lbl", "src_bbox", "tar_lbl", "tar_bbox")


def _report(**values):
    name = os.environ.get("PYTEST_CURRENT_TEST", "").split()[0]
    print(f"[ring_pad] {name}: " + " ".join(f"{k}={v:.3e}"
                                            for k, v in values.items()))


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-8))


def _oihw(k: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(k).permute(3, 2, 0, 1).contiguous()


@pytest.mark.parametrize("p,h,w,ci,co", [
    (1, 10, 12, 5, 7), (3, 16, 9, 4, 6), (1, 34, 34, 8, 8), (2, 12, 12, 3, 3),
])
def test_reflect_conv_matches_padded(p, h, w, ci, co):
    rng = np.random.default_rng(p * 100 + h)
    x = rng.standard_normal((2, h, w, ci)).astype(np.float32)
    k = rng.standard_normal((2 * p + 1, 2 * p + 1, ci, co)).astype(np.float32)
    xt, kt = torch.from_numpy(x), _oihw(k)
    ref = conv2d(reflect_pad(xt, p), kt).numpy()
    got = conv2d_reflect_dp(xt, kt, p).numpy()
    want = np.asarray(j_conv2d_reflect_dp(jnp.asarray(x), jnp.asarray(k), p,
                                          precision="highest"))
    errs = {"vs_pad": _rel(got, ref), "vs_jax": _rel(got, want)}
    _report(**errs)
    assert max(errs.values()) < 1e-5, errs
    # interiors are bit-identical (zero padding contributes nothing there)
    np.testing.assert_array_equal(ref[:, p:-p, p:-p], got[:, p:-p, p:-p])


def test_reflect_conv_gradients_match():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 12, 14, 6)).astype(np.float32)
    k = rng.standard_normal((3, 3, 6, 5)).astype(np.float32)
    want = jax.grad(lambda a, b: jnp.sum(jnp.sin(j_conv2d_reflect_dp(
        a, b, 1, precision="highest"))), argnums=(0, 1))(jnp.asarray(x),
                                                         jnp.asarray(k))

    def grads(ring):
        xt = torch.from_numpy(x).requires_grad_()
        kt = _oihw(k).requires_grad_()
        y = (conv2d_reflect_dp(xt, kt, 1) if ring
             else conv2d(reflect_pad(xt, 1), kt))
        torch.sin(y).sum().backward()
        return xt.grad.numpy(), kt.grad.permute(2, 3, 1, 0).numpy()

    ring, pad = grads(True), grads(False)
    errs = {f"{what}_{i}": _rel(ring[i], ref[i])
            for what, ref in (("vs_pad", pad), ("vs_jax", want))
            for i in range(2)}
    _report(**errs)
    assert max(errs.values()) < 1e-5, errs


def test_resnet_block_ring_same_params_same_output():
    x = np.random.default_rng(1234).standard_normal(
        (2, 16, 16, 8)).astype(np.float32)
    jblk = JResnetBlock(8, precision="highest", ring_pad=True)
    params = JResnetBlock(8, precision="highest").init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jblk.apply({"params": params}, jnp.asarray(x))
    blocks = {}
    for ring in (False, True):
        blocks[ring] = ResnetBlock(8, ring_pad=ring)
        load_flax_params(blocks[ring], jax.tree.map(np.asarray, params))
    with torch.no_grad():
        y_pad = blocks[False](torch.from_numpy(x)).numpy()
        y_ring = blocks[True](torch.from_numpy(x)).numpy()
    errs = {"vs_pad": _rel(y_ring, y_pad), "vs_jax": _rel(y_ring, want)}
    _report(**errs)
    assert max(errs.values()) < 1e-5, errs


def _configs(ring, **over):
    port = dataclasses.replace(toy_config(), ring_pad=ring, **over)
    jax_cfg = dataclasses.replace(j_toy_config(), ring_pad=ring, **over)
    return port, jax_cfg


def _ported(cfg, params, train):
    mods = TSNetModules(cfg, device="cpu")
    load_flax_params(mods, jax.tree.map(np.asarray, params))
    mods.requires_grad_(train)
    return mods


def _toy_batch(bs=2, s=2, hw=64, nl=2):
    rng = np.random.default_rng(5)
    return {
        "src_img": rng.random((bs, s, hw, hw, 3)).astype(np.float32),
        "src_lbl": rng.integers(0, 2, (bs, s, hw, hw, nl)).astype(np.float32),
        "src_bbox": rng.integers(0, 2, (bs, s, hw, hw)).astype(np.float32),
        "tar_img": rng.random((bs, hw, hw, 3)).astype(np.float32),
        "tar_lbl": rng.integers(0, 2, (bs, hw, hw, nl)).astype(np.float32),
        "tar_bbox": rng.integers(0, 2, (bs, hw, hw)).astype(np.float32),
    }


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in jax.tree.leaves(tree)])


def _cos(a, b) -> float:
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_train_forward_and_grads_match_ring():
    """rec_img (relative 1e-4) and the generator gradient of
    sum|rec_img| + loss_warp (cosine > 0.9999) of the ring path against
    the port's pad path and against the JAX ring path."""
    jcfg = _configs(True, softmax_temp=TRAIN_TEMP)[1]
    params = JTSNetModules(jcfg).init_generator_params(jax.random.PRNGKey(0))
    batch = _toy_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def j_loss(p):
        out = j_tsnet_forward(JTSNetModules(jcfg), p,
                              *(jb[k] for k in KEYS), tar_img=jb["tar_img"],
                              train=True, use_pallas=False)
        rec = out["rec_img"]
        return jnp.sum(jnp.abs(rec)) + out["loss_warp"], rec

    (_, j_rec), j_grad = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        params)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    rec, grad = {}, {}
    for ring in (False, True):
        mods = _ported(_configs(ring, softmax_temp=TRAIN_TEMP)[0], params,
                       train=True)
        out = tsnet_forward(mods, *(b[k] for k in KEYS), tar_img=b["tar_img"],
                            train=True)
        (out["rec_img"].abs().sum() + out["loss_warp"]).backward()
        rec[ring] = out["rec_img"].detach().numpy()
        grad[ring] = _flat({n: state_dict_to_flax({
            k: p.grad if p.grad is not None else torch.zeros_like(p)
            for k, p in getattr(mods, n).named_parameters()})
            for n in GEN_SUBNETS})
    want_g = _flat({n: j_grad[n] for n in GEN_SUBNETS})
    errs = {"rec_vs_pad": _rel(rec[True], rec[False]),
            "rec_vs_jax": _rel(rec[True], j_rec),
            "grad_cos_vs_pad": _cos(grad[True], grad[False]),
            "grad_cos_vs_jax": _cos(grad[True], want_g)}
    _report(**errs)
    assert errs["rec_vs_pad"] < 1e-4 and errs["rec_vs_jax"] < 1e-4, errs
    assert min(errs["grad_cos_vs_pad"], errs["grad_cos_vs_jax"]) > 0.9999, \
        errs
    # at the toy config's own temperature (100): the ring path against the
    # pad path, and the pad path against itself under a 1e-6 nudge of the
    # input images, printed (see the module docstring)
    nudge = np.random.default_rng(3)
    nudged = dict(b)
    for k in ("src_img", "tar_img"):
        nudged[k] = b[k] * (1 + 1e-6 * torch.from_numpy(
            nudge.standard_normal(b[k].shape).astype(np.float32)))
    top = {}
    for name, ring, inputs in (("pad", False, b), ("ring", True, b),
                               ("pad_nudged", False, nudged)):
        mods = _ported(_configs(ring)[0], params, train=False)
        with torch.no_grad():
            top[name] = tsnet_forward(mods, *(inputs[k] for k in KEYS),
                                      tar_img=inputs["tar_img"],
                                      train=True)["rec_img"].numpy()
    _report(temp100_rec_vs_pad=_rel(top["ring"], top["pad"]),
            temp100_pad_nudged_vs_pad=_rel(top["pad_nudged"], top["pad"]))


def test_clip_forward_matches_ring():
    jcfg = _configs(True)[1]
    params = JTSNetModules(jcfg).init_generator_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(9)
    s, f, hw, nl = 2, 3, 64, 2
    args = (rng.random((s, hw, hw, 3)).astype(np.float32),
            rng.integers(0, 2, (s, hw, hw, nl)).astype(np.float32),
            rng.integers(0, 2, (s, hw, hw)).astype(np.float32),
            rng.integers(0, 2, (f, hw, hw, nl)).astype(np.float32),
            rng.integers(0, 2, (f, hw, hw)).astype(np.float32))
    want = np.asarray(jax.jit(lambda p, *a: j_tsnet_forward_clip(
        JTSNetModules(jcfg), p, *a, use_pallas=False))(
            params, *map(jnp.asarray, args)))
    rec = {ring: tsnet_forward_clip(
        _ported(_configs(ring)[0], params, train=False), *args,
        device="cpu").numpy() for ring in (False, True)}
    errs = {"vs_pad": _rel(rec[True], rec[False]),
            "vs_jax": _rel(rec[True], want)}
    _report(**errs)
    assert max(errs.values()) < 5e-4, errs


class _TwoShards:
    """A stand-in for `parallel.mesh.Mesh` on the `model` axis of two
    ranks, run one after the other in this process: `reduce_from` records
    the first rank's partial sum and adds it to the second's."""

    def __init__(self):
        self.first = None

    def reduce_from(self, x, axis):
        if self.first is None:
            self.first = x
            return x
        return x + self.first


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_ring_conv_matches_the_whole(dtype):
    """Under tensor parallelism a ResNet block's conv2 sums partial convs
    over in-channel shards (`nn.blocks.conv2d_split_in`); with `ring_pad`
    each partial is a ring conv, and the sum over two shards equals the
    whole ring conv (f32: 1e-5 relative; bf16: one rounding, 2^-7)."""
    from wacv23_tsnet_tpu_torch.nn.blocks import conv2d_split_in
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 12, 10, 8)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((6, 8, 3, 3)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal(6).astype(np.float32))
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    prec = "default" if dtype == "bfloat16" else "highest"
    whole = conv2d_reflect_dp(x, w, 1, b, prec, dt).float()
    mesh = _TwoShards()
    got = None
    for sl in (slice(0, 4), slice(4, 8)):
        got = conv2d_split_in(x[..., sl], w[:, sl], b, mesh, "model", prec,
                              dt, ring_pad=True)
    err = _rel(got.float().numpy(), whole.numpy())
    _report(split_vs_whole=err)
    assert got.dtype == dt
    assert err < (1e-5 if dtype == "float32" else 2.0 ** -7), err


@pytest.mark.parametrize("p,h,w", [(1, 3, 3), (2, 5, 9), (3, 7, 7),
                                   (3, 8, 7)])
def test_reflect_conv_takes_its_edge_shapes(p, h, w):
    """H or W = 2p + 1, the smallest the op takes, against the padded
    conv at the bar of test_reflect_conv_matches_padded."""
    rng = np.random.default_rng(p * 10 + h + w)
    x = torch.from_numpy(rng.standard_normal((2, h, w, 4)).astype(np.float32))
    k = _oihw(rng.standard_normal((2 * p + 1, 2 * p + 1, 4, 5))
              .astype(np.float32))
    err = _rel(conv2d_reflect_dp(x, k, p), conv2d(reflect_pad(x, p), k))
    _report(vs_pad=err)
    assert err < 1e-5


@pytest.mark.parametrize("p,h,w", [(0, 6, 6), (1, 2, 5), (1, 5, 2),
                                   (2, 4, 9), (3, 6, 9), (3, 9, 6)])
def test_reflect_conv_refuses_shapes_outside_its_range(p, h, w):
    x = torch.zeros(1, h, w, 3)
    k = torch.zeros(4, 3, 2 * p + 1, 2 * p + 1)
    with pytest.raises(ValueError, match="needs p >= 1"):
        conv2d_reflect_dp(x, k, p)


@pytest.mark.parametrize("config", [toy_config, face_config, pose_config])
def test_no_model_path_reaches_a_refused_shape(config, monkeypatch):
    """Every reflect conv of the train forward and the clip with
    `ring_pad` on, on the `meta` device (shapes only, full width), lies
    in the op's range."""
    seen = set()
    ring = blocks.conv2d_reflect_dp

    def spy(x, weight, p, *args, **kwargs):
        seen.add((p, x.shape[1], x.shape[2]))
        return ring(x, weight, p, *args, **kwargs)

    monkeypatch.setattr(blocks, "conv2d_reflect_dp", spy)
    cfg = dataclasses.replace(config(), ring_pad=True)
    mods = TSNetModules(cfg, device="meta", train=True)
    s, hw, nl = cfg.n_source, cfg.image_size, cfg.label_nc

    def meta(*shape):
        return torch.zeros(*shape, device="meta")

    tsnet_forward(mods, meta(1, s, hw, hw, 3), meta(1, s, hw, hw, nl),
                  meta(1, s, hw, hw), meta(1, hw, hw, nl), meta(1, hw, hw),
                  tar_img=meta(1, hw, hw, 3), train=True, use_kernels=False)
    tsnet_forward_clip(mods, meta(s, hw, hw, 3), meta(s, hw, hw, nl),
                       meta(s, hw, hw), meta(2, hw, hw, nl), meta(2, hw, hw),
                       use_kernels=False, device="meta")
    print(f"[ring_pad] {config.__name__}: (p, H, W) {sorted(seen)}")
    assert {p for p, _, _ in seen} == {1, 3}
    assert all(min(h, w) > 2 * p for p, h, w in seen), seen
