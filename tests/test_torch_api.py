"""The port's training knobs, its reference-style `TSNet`, `ClipInference`
and the metrics against the JAX package (CPU, toy config).

- `conv2d_dp`: with `bwd_precision=None` the plain conv, bit for bit;
  "highest" gradients against the JAX `conv2d_dp` at fp32 tolerance;
  "default" against the port's own bf16-cast autograd exactly and
  against JAX within bf16 resolution (XLA on the CPU runs "default" in
  fp32).
- `remat=True`: the same parameters, forward and gradients as
  `remat=False` (tests/test_model_smoke.py holds the JAX package so).
- `TSNet`: tests/test_model_smoke.py's sequence on the port (its
  update against the JAX `TSNet` is in tests/test_torch_loop.py, which
  shares one compiled JAX train step between it and the loop).
- The fast train tier: tests/test_fast_tail_train.py's two contracts.
- `ClipInference` against the JAX `ClipInference`, and the metrics
  against `infer/metrics.py`.

`pytest -s` prints each measured error.
"""

import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wacv23_tsnet_tpu.configs import toy_config as j_toy_config
from wacv23_tsnet_tpu.infer import metrics as jm
from wacv23_tsnet_tpu.infer.pipeline import ClipInference as JClipInference
from wacv23_tsnet_tpu.models import TSNetModules as JTSNetModules
from wacv23_tsnet_tpu.nn import VGG19Features as JVGG
from wacv23_tsnet_tpu.nn import load_vgg19_params
from wacv23_tsnet_tpu.ops.dpconv import conv2d_dp as j_conv2d_dp
from wacv23_tsnet_tpu_torch.compat import load_flax_params
from wacv23_tsnet_tpu_torch.configs import toy_config
from wacv23_tsnet_tpu_torch.infer import ClipInference
from wacv23_tsnet_tpu_torch.infer import metrics as pm
from wacv23_tsnet_tpu_torch.models import TSNet, TSNetModules, tsnet_forward
from wacv23_tsnet_tpu_torch.nn.blocks import conv2d
from wacv23_tsnet_tpu_torch.nn.vgg import VGG19Features
from wacv23_tsnet_tpu_torch.ops.dpconv import conv2d_dp
from wacv23_tsnet_tpu_torch.train import create_train_state, make_train_step

torch.set_num_threads(2)
RNG = np.random.default_rng(42)
KEYS = ("src_img", "src_lbl", "src_bbox", "tar_lbl", "tar_bbox")


def _report(**errors):
    name = os.environ.get("PYTEST_CURRENT_TEST", "").split()[0]
    print(f"[parity] {name}: " + " ".join(
        f"{k}={v:.3e}" for k, v in errors.items()))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def vgg_tree():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jax.tree.map(np.asarray, load_vgg19_params())


# ------------------------------------------------------------ conv2d_dp

CONV_CASES = [(1, 0), (2, 1)]


def _conv_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 12, 12, 5)).astype(np.float32)
    w = rng.standard_normal((7, 5, 3, 3)).astype(np.float32)   # OIHW
    b = rng.standard_normal(7).astype(np.float32)
    return x, w, b


def _port_grads(fn, x, w, b):
    xs, ws, bs = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    y = fn(xs, ws, bs)
    (y * torch.cos(y)).sum().backward()
    return y.detach(), xs.grad, ws.grad, bs.grad


def _jax_grads(x, w, stride, pad, precision, bwd_precision):
    def loss(x_, w_):
        y = j_conv2d_dp(x_, w_, (stride, stride), ((pad, pad), (pad, pad)),
                        precision=precision, bwd_precision=bwd_precision)
        return jnp.sum(y * jnp.cos(y))
    return jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)))


@pytest.mark.parametrize("stride, pad", CONV_CASES)
def test_conv2d_dp_without_bwd_precision_is_the_plain_conv(stride, pad):
    """None, or equal to `precision`: output and every gradient equal to
    plain autograd of F.conv2d."""
    x, w, b = _conv_inputs()

    def plain(xs, ws, bs):
        return F.conv2d(xs.permute(0, 3, 1, 2), ws, bs, stride,
                        pad).permute(0, 2, 3, 1)

    want = _port_grads(plain, x, w, b)
    for bwd in (None, "highest"):
        for fn in (lambda xs, ws, bs: conv2d_dp(xs, ws, bs, stride, pad,
                                                "highest", bwd),
                   lambda xs, ws, bs: conv2d(xs, ws, bs, stride, pad,
                                             bwd_precision=bwd)):
            for g, t in zip(_port_grads(fn, x, w, b), want):
                assert torch.equal(g, t)


@pytest.mark.parametrize("stride, pad", CONV_CASES)
def test_conv2d_dp_highest_matches_jax(stride, pad):
    x, w, b = _conv_inputs(1)
    _, gx, gw, _ = _port_grads(lambda xs, ws, bs: conv2d_dp(
        xs, ws, None, stride, pad, "high", "highest"), x, w, b)
    jgx, jgw = _jax_grads(x, w, stride, pad, "high", "highest")
    errs = {"grad_x": _rel(gx, jgx),
            "grad_w": _rel(gw.permute(2, 3, 1, 0), jgw)}
    _report(**errs)
    assert max(errs.values()) <= 1e-5


@pytest.mark.parametrize("stride, pad", CONV_CASES)
def test_conv2d_dp_default_backward_is_one_bf16_pass(stride, pad):
    """bwd_precision="default" under a "highest" forward: the forward is
    the fp32 conv, bit for bit; grad-input and grad-weight are exactly
    those of autograd through a bf16 conv; the bias gradient is the fp32
    sum. Against JAX (fp32 on the CPU) within bf16 resolution."""
    x, w, b = _conv_inputs(2)
    y, gx, gw, gb = _port_grads(lambda xs, ws, bs: conv2d_dp(
        xs, ws, bs, stride, pad, "highest", "default"), x, w, b)
    y32, _, _, gb32 = _port_grads(lambda xs, ws, bs: conv2d_dp(
        xs, ws, bs, stride, pad, "highest", None), x, w, b)
    assert torch.equal(y, y32)
    assert torch.equal(gb, gb32)
    xs, ws = (torch.tensor(a, requires_grad=True) for a in (x, w))
    yb = F.conv2d(xs.permute(0, 3, 1, 2).bfloat16(), ws.bfloat16(), None,
                  stride, pad).float()
    yb.backward((torch.cos(y32) - y32 * torch.sin(y32)).permute(0, 3, 1, 2))
    assert torch.equal(gx, xs.grad) and torch.equal(gw, ws.grad)
    _, gx, gw, _ = _port_grads(lambda xs, ws, bs: conv2d_dp(
        xs, ws, None, stride, pad, "highest", "default"), x, w, b)
    jgx, jgw = _jax_grads(x, w, stride, pad, "highest", "default")
    errs = {"grad_x": _rel(gx, jgx),
            "grad_w": _rel(gw.permute(2, 3, 1, 0), jgw)}
    _report(**errs)
    assert 0.0 < max(errs.values()) <= 2 ** -7


# ---------------------------------------------------------------- remat

def _batch(cfg, bs=2, seed=0):
    """A random batch, as tests/test_fast_tail_train.py makes it."""
    r = np.random.default_rng(seed)
    hw, nl, s = cfg.image_size, cfg.label_nc, cfg.n_source
    return {"src_img": r.random((bs, s, hw, hw, 3), np.float32),
            "src_lbl": r.integers(0, 2, (bs, s, hw, hw, nl)).astype(
                np.float32),
            "src_bbox": r.integers(0, 2, (bs, s, hw, hw)).astype(np.float32),
            "tar_img": r.random((bs, hw, hw, 3), np.float32),
            "tar_lbl": r.integers(0, 2, (bs, hw, hw, nl)).astype(np.float32),
            "tar_bbox": r.integers(0, 2, (bs, hw, hw)).astype(np.float32)}


def _gen_grads(mods, batch):
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    mods.zero_grad(set_to_none=True)
    out = tsnet_forward(mods, *(b[k] for k in KEYS), tar_img=b["tar_img"],
                        train=True)
    loss = ((out["rec_img"] - b["tar_img"]).abs().mean()
            + 1e-3 * out["loss_warp"])
    loss.backward()
    flat = torch.cat([p.grad.reshape(-1) if p.grad is not None
                      else torch.zeros(p.numel())
                      for n, p in mods.named_parameters()
                      if not n.startswith("netD.")])
    return out, flat.double().numpy()


def test_remat_keeps_params_forward_and_gradients():
    cfg = toy_config()
    batch = _batch(cfg)
    plain = TSNetModules(cfg, device="cpu", train=True)
    remat = TSNetModules(dataclasses.replace(cfg, remat=True), device="cpu",
                         train=True)
    sd, sd_r = plain.state_dict(), remat.state_dict()
    assert list(sd) == list(sd_r)
    assert all(torch.equal(sd[k], sd_r[k]) for k in sd)
    out, g = _gen_grads(plain, batch)
    out_r, g_r = _gen_grads(remat, batch)
    errs = {"rec_img": float((out["rec_img"] - out_r["rec_img"]).abs().max()
                             .detach()),
            "grad": float(np.abs(g - g_r).max() / np.abs(g).max())}
    _report(**errs)
    assert errs["rec_img"] <= 1e-5 and errs["grad"] <= 1e-6
    assert np.isfinite(g_r).all()


def test_remat_train_step_matches_the_plain_step():
    """A whole GAN step (netD under remat too): the same metrics and
    parameters after the update."""
    cfg = toy_config()
    batch = _batch(cfg)
    states = [create_train_state(dataclasses.replace(cfg, remat=r),
                                 device="cpu", seed=0) for r in (False, True)]
    out = [make_train_step(s)(s, batch, 2e-4) for s in states]
    m, m_r = out[0][1], out[1][1]
    err = max(abs(m[k].item() - m_r[k].item()) / max(1.0, abs(m[k].item()))
              for k in m)
    p = dict(states[0].mods.named_parameters())
    perr = max(float((p[n] - q).abs().max())
               for n, q in states[1].mods.named_parameters())
    _report(metric_rel=err, param_max_abs=perr)
    assert err <= 1e-6 and perr <= 1e-7


# ---------------------------------------------------------------- TSNet

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


def test_tsnet_toy_train_step_and_inference():
    """tests/test_model_smoke.py:test_toy_train_step_and_inference on the
    port: losses, shapes, the lazy readback, warp previews, inference
    from carried generator parameters and `set_source_num`."""
    cfg = toy_config()
    bs, size = 2, cfg.image_size
    model = TSNet(cfg, is_train=True, device="cpu")
    srcs, lbls, boxes, tar_img, tar_lbl, tar_bbox = _random_inputs(
        bs, size, cfg.label_nc, cfg.n_source)

    model.setup(actual_step=0, batch_size=bs, initial_iter=100,
                max_iter=1000, power=1.0)
    model.set_train_input(srcs, lbls, boxes, tar_img, tar_lbl, tar_bbox)
    model.optimize_parameters()
    assert model._rec_cache is None          # not copied until read
    losses = model.get_current_losses()
    assert set(losses) == {"G", "G_GAN", "G_FML", "G_VGG", "D", "D_real",
                           "D_fake", "grad_G", "warp", "align"}
    for name, value in losses.items():
        assert np.isfinite(value), f"loss {name} not finite"
    assert model.rec_tar_img.shape == (bs, 3, size, size)
    assert np.isfinite(model.rec_tar_img).all()

    step1_loss = losses["G"]
    model.optimize_parameters()
    assert model.get_current_losses()["G"] != step1_loss

    model.forward()
    assert len(model.warp_src_img_list) == cfg.n_source
    assert model.warp_src_img_list[0].shape == (bs, 3, size, size)
    assert model.state.step == 2

    infer = TSNet(cfg, is_train=False, device="cpu")
    infer.load_generator_params(model.generator_params)
    infer.set_test_input(srcs, lbls, boxes, tar_lbl, tar_bbox)
    infer.forward()
    assert infer.rec_tar_img.shape == (bs, 3, size, size)
    assert np.abs(infer.rec_tar_img).max() <= 1.0  # tanh range

    infer.set_source_num(1)
    infer.set_test_input(srcs[:1], lbls[:1], boxes[:1], tar_lbl, tar_bbox)
    infer.forward()
    assert infer.rec_tar_img.shape == (bs, 3, size, size)
    with pytest.raises(KeyError):
        infer.load_generator_params({"img_enc.conv_in.weight": 0})


# ------------------------------------------------------ fast train tier

def _tier(fast_tail):
    return dataclasses.replace(toy_config(), precision="high",
                               bwd_precision="default", fast_tail=fast_tail)


def test_fast_tail_train_step_runs_and_tracks_base():
    metrics = {}
    for tag, ft in (("base", False), ("fast_tail", True)):
        state = create_train_state(_tier(ft), device="cpu", seed=0)
        _, m, rec = make_train_step(state)(state, _batch(_tier(ft)), 2e-4)
        metrics[tag] = {k: v.item() for k, v in m.items()}
        assert all(np.isfinite(v) for v in metrics[tag].values()), tag
        assert rec.dtype == torch.float32
    for k, v in metrics["base"].items():
        np.testing.assert_allclose(metrics["fast_tail"][k], v, rtol=0.15,
                                   atol=0.02, err_msg=k)


def test_fast_tail_gradient_keeps_direction():
    """The full-generator gradient cosine of the fast tail against the
    f32 tail, both at "high" + "default" backward, above the JAX
    package's floor 0.97."""
    grads = {}
    for tag, ft in (("base", False), ("fast_tail", True)):
        mods = TSNetModules(_tier(ft), device="cpu", train=True)
        grads[tag] = _gen_grads(mods, _batch(_tier(ft)))[1]
    hi, lo = grads["base"], grads["fast_tail"]
    cos = float(np.dot(hi, lo) / (np.linalg.norm(hi) * np.linalg.norm(lo)))
    _report(cosine=cos)
    assert cos > 0.97, f"fast-tail gradient cosine {cos:.4f}"


# -------------------------------------------------------- ClipInference

@pytest.fixture(scope="module")
def clip_case():
    jcfg = j_toy_config()
    params = JTSNetModules(jcfg).init_generator_params(jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, params)
    r = np.random.default_rng(4)
    s, hw, f = jcfg.n_source, jcfg.image_size, 7
    mean = jcfg.img_mean_array()
    inputs = ((r.random((s, 3, hw, hw)) * 255 - mean[:, None, None]).astype(
                  np.float32),
              r.integers(0, 2, (s, hw, hw)).astype(np.uint8),
              r.integers(0, 2, (s, hw, hw)).astype(np.float32),
              r.integers(0, 2, (f, hw, hw)).astype(np.uint8),
              r.integers(0, 2, (f, hw, hw)).astype(np.float32))
    return params, inputs


@pytest.mark.parametrize("method", ["run", "run_renormalized"])
def test_clip_inference_matches_jax(clip_case, method):
    """Chunks of 3 over 7 frames (the last padded by wrapping), in the
    bit-parity tier, at tests/test_torch_slice.py's 1e-3 max."""
    params, inputs = clip_case
    want = getattr(JClipInference(j_toy_config(), params, use_pallas=True,
                                  chunk=3), method)(*inputs)
    got = getattr(ClipInference(toy_config(), params, chunk=3,
                                device="cpu"), method)(*inputs)
    assert got.shape == want.shape == (7, 3, 64, 64)
    _report(max_abs_err=np.abs(got - want).max())
    assert np.abs(got - want).max() <= 1e-3


def test_display_helpers_match_jax():
    from PIL import Image

    from wacv23_tsnet_tpu.infer.pipeline import montage_row as j_montage
    from wacv23_tsnet_tpu.infer.pipeline import to_display_rgb as j_display
    from wacv23_tsnet_tpu_torch.infer import montage_row, to_display_rgb
    img = RNG.standard_normal((3, 16, 12)).astype(np.float32) * 0.5
    mean = toy_config().img_mean_array()
    np.testing.assert_array_equal(to_display_rgb(img, mean),
                                  j_display(img, mean))
    row = [to_display_rgb(img, mean), to_display_rgb(-img, mean)]
    want = j_montage(row)
    assert isinstance(want, Image.Image)
    np.testing.assert_array_equal(montage_row(row), np.asarray(want))


# -------------------------------------------------------------- metrics

def test_identity_metrics():
    x = torch.from_numpy(RNG.random((2, 32, 32, 3), np.float32))
    assert float(pm.l1(x, x)) == 0.0
    assert float(pm.psnr(x, x)) > 100.0
    assert abs(float(pm.ssim(x, x)) - 1.0) < 1e-5


def test_metric_ordering():
    x = torch.from_numpy(RNG.random((1, 64, 64, 3), np.float32))
    small = x + 0.01 * torch.from_numpy(
        RNG.standard_normal(x.shape).astype(np.float32))
    big = x + 0.2 * torch.from_numpy(
        RNG.standard_normal(x.shape).astype(np.float32))
    assert float(pm.psnr(x, small)) > float(pm.psnr(x, big))
    assert float(pm.ssim(x, small)) > float(pm.ssim(x, big))
    assert float(pm.l1(x, small)) < float(pm.l1(x, big))


def test_ssim_stays_in_range_on_natural_images():
    yy, xx = np.meshgrid(np.linspace(0, 4, 96), np.linspace(0, 4, 96),
                         indexing="ij")
    base = 0.4 + 0.3 * np.sin(yy * 2.1) * np.cos(xx * 1.7)
    a = np.repeat(base[None, :, :, None], 3, -1).astype(np.float32)
    b = np.clip(a + 0.05 * RNG.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    v = float(pm.ssim(torch.from_numpy(a), torch.from_numpy(b)))
    assert -1.0 <= v <= 1.0, v
    assert v > 0.3, v


def test_akd():
    kp = RNG.uniform(0, 100, (4, 25, 2))
    shifted = kp + 3.0
    akd = float(pm.average_keypoint_distance(torch.from_numpy(shifted),
                                             torch.from_numpy(kp)))
    assert abs(akd - 3.0 * np.sqrt(2)) < 1e-4
    kp2 = kp.copy()
    kp2[:, :5] = 0.0
    akd2 = float(pm.average_keypoint_distance(torch.from_numpy(shifted),
                                              torch.from_numpy(kp2)))
    assert abs(akd2 - 3.0 * np.sqrt(2)) < 1e-4


def test_metrics_match_jax(vgg_tree):
    a = RNG.random((2, 40, 36, 3), np.float32)
    b = np.clip(a + 0.1 * RNG.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    kp_a = RNG.uniform(0, 50, (3, 68, 2)).astype(np.float32)
    kp_b = (kp_a + RNG.normal(0, 2, kp_a.shape)).astype(np.float32)
    kp_b[:, :4] = 0
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    vgg = VGG19Features()
    load_flax_params(vgg, vgg_tree["params"])
    jvgg = JVGG()
    pairs = {
        "l1": (pm.l1(ta, tb), jm.l1(a, b)),
        "psnr": (pm.psnr(ta, tb), jm.psnr(a, b)),
        "ssim": (pm.ssim(ta, tb), jm.ssim(jnp.asarray(a), jnp.asarray(b))),
        "akd": (pm.average_keypoint_distance(torch.from_numpy(kp_b),
                                             torch.from_numpy(kp_a)),
                jm.average_keypoint_distance(kp_b, kp_a)),
        "vgg": (pm.vgg_feature_distance(vgg, ta, tb),
                jm.vgg_feature_distance(jvgg, vgg_tree, jnp.asarray(a),
                                        jnp.asarray(b))),
    }
    errs = {k: abs(float(g) - float(w)) / abs(float(w))
            for k, (g, w) in pairs.items()}
    _report(**errs)
    assert max(errs.values()) <= 1e-5
