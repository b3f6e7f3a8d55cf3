"""The port's training slice against the JAX package (CPU, toy config).

One JAX `create_train_state` (generator, discriminator and the VGG tree
of `load_vgg19_params`) is carried into a port `TrainState` with
`compat.load_train_state`; the same numpy batch goes through JAX
`tsnet_forward(train=True)` / `make_train_step` (Pallas kernels in
interpret mode) and through the port on the CPU (its kernels' plain
versions). `pytest -s` prints each measured error.
"""

import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wacv23_tsnet_tpu import losses as jl
from wacv23_tsnet_tpu.configs import toy_config as j_toy_config
from wacv23_tsnet_tpu.models import TSNetModules as JTSNetModules
from wacv23_tsnet_tpu.models import tsnet_forward as j_tsnet_forward
from wacv23_tsnet_tpu.nn import VGG19Features as JVGG
from wacv23_tsnet_tpu.nn import load_vgg19_params
from wacv23_tsnet_tpu.nn.decoder import decoder_apply_fast
from wacv23_tsnet_tpu.train.state import create_train_state as j_create_state
from wacv23_tsnet_tpu.train.step import make_train_step as j_make_step
from wacv23_tsnet_tpu_torch.compat import (export_train_state,
                                           load_train_state,
                                           state_dict_to_flax)
from wacv23_tsnet_tpu_torch.configs import toy_config
from wacv23_tsnet_tpu_torch.models import tsnet_forward
from wacv23_tsnet_tpu_torch.nn.vgg import load_vgg19_npz
from wacv23_tsnet_tpu_torch.train import (GEN_SUBNETS, create_train_state,
                                          lr_poly, make_train_step)

torch.set_num_threads(2)
LR = 2e-4
KEYS = ("src_img", "src_lbl", "src_bbox", "tar_lbl", "tar_bbox")


def _report(**errors):
    name = os.environ.get("PYTEST_CURRENT_TEST", "").split()[0]
    print(f"[parity] {name}: " + " ".join(
        f"{k}={v:.3e}" for k, v in errors.items()))


def _batch(cfg, bs=2, seed=0):
    """A random batch, as tests/test_train_loop.py makes it."""
    rng = np.random.default_rng(seed)
    s, hw, nl = cfg.n_source, cfg.image_size, cfg.label_nc
    return {"src_img": rng.random((bs, s, hw, hw, 3), np.float32),
            "src_lbl": rng.integers(0, 2, (bs, s, hw, hw, nl)).astype(
                np.float32),
            "src_bbox": rng.integers(0, 2, (bs, s, hw, hw)).astype(
                np.float32),
            "tar_img": rng.random((bs, hw, hw, 3), np.float32),
            "tar_lbl": rng.integers(0, 2, (bs, hw, hw, nl)).astype(
                np.float32),
            "tar_bbox": rng.integers(0, 2, (bs, hw, hw)).astype(np.float32)}


@pytest.fixture(scope="module", params=[10.0, 100.0],
                ids=["temp10", "temp100"])
def jax_state(request):
    """The JAX modules, one toy train state and one batch (numpy), at the
    toy config's softmax temperature 100 and at 10. At 100, random toy
    features saturate the softmax to one-hot, where a gradient compares
    the rounding of two near-equal terms (see the JAX package's
    tests/test_pallas_backward.py); the gradients are held at 10 and
    printed at 100."""
    jmods = JTSNetModules(dataclasses.replace(j_toy_config(),
                                              softmax_temp=request.param))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        vgg = load_vgg19_params()
    state = j_create_state(jmods, jax.random.PRNGKey(0), vgg_params=vgg)
    return jmods, state, _batch(toy_config())


def _port_state(state, temp):
    cfg = dataclasses.replace(toy_config(), softmax_temp=temp)
    ours = create_train_state(cfg, device="cpu", seed=3)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    load_train_state(ours, np_tree(state.gen_params),
                     np_tree(state.disc_params), np_tree(state.vgg_params))
    return ours


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _subnet_err(got_tree, want_tree):
    """max |got - want| over a subnet, over its largest |want|: the biases
    in front of an instance norm have zero gradients, which both sides
    give as rounding noise on the scale of the kernels' gradients."""
    got = jax.tree_util.tree_leaves(got_tree)
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    scale = max(float(np.abs(w).max()) for w in want)
    return max(float(np.abs(g - np.asarray(w)).max())
               for g, w in zip(got, want)) / scale


def _port_grads(module):
    """The module's gradients as a flax-layout tree; a parameter that the
    loss does not use (FuseNet's conv2 bias, which `fuse_train` drops)
    has a zero gradient in JAX and none in torch."""
    return state_dict_to_flax({
        n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in module.named_parameters()})


def test_tsnet_forward_train_matches_jax(jax_state):
    """rec_img, loss_warp and loss_align, and the gradient of
    mean(rec_img) + loss_warp + loss_align for each generator subnet."""
    jmods, state, batch = jax_state
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def outputs(params):
        out = j_tsnet_forward(jmods, params, *(jb[k] for k in KEYS),
                              tar_img=jb["tar_img"], train=True,
                              use_pallas=True)
        return out["rec_img"], out["loss_warp"], out["loss_align"]

    def scalar(params):
        rec, warp, align = outputs(params)
        return jnp.mean(rec) + warp + align

    want = jax.jit(outputs)(state.gen_params)
    want_g = jax.jit(jax.grad(scalar))(state.gen_params)
    ours = _port_state(state, jmods.cfg.softmax_temp)
    b = _tensors(batch)
    out = tsnet_forward(ours.mods, *(b[k] for k in KEYS),
                        tar_img=b["tar_img"], train=True)
    got = out["rec_img"], out["loss_warp"], out["loss_align"]
    (got[0].mean() + got[1] + got[2]).backward()
    errs = {"rec_img": float(np.abs(got[0].detach().numpy()
                                    - np.asarray(want[0])).max())}
    for name, g, w in zip(("loss_warp", "loss_align"), got[1:], want[1:]):
        errs[name] = abs(g.item() - float(w)) / max(1.0, abs(float(w)))
    for name in GEN_SUBNETS:
        errs[f"grad_{name}"] = _subnet_err(
            _port_grads(getattr(ours.mods, name)), want_g[name])
    _report(**errs)
    assert errs["rec_img"] <= 1e-3, errs
    assert max(errs[k] for k in ("loss_warp", "loss_align")) <= 1e-4, errs
    if jmods.cfg.softmax_temp == 10.0:
        assert max(errs[f"grad_{n}"] for n in GEN_SUBNETS) <= 1e-3, errs


def _jax_grads(jmods, state, new_disc, batches, rec):
    """The gradients of one step at the port's reconstruction `rec` and
    updated D `new_disc`, composed from the JAX package's functions as
    `make_train_step` composes them: the D loss on `rec`; the G loss's
    head (GAN, feature matching, VGG and gradient terms, against
    `new_disc`) differentiated at `rec`, and that cotangent, with the
    warp and align losses, taken back through the JAX generator's VJP.
    Its L1 terms have sign gradients, which a rounding-level change of
    rec flips pixel by pixel; so the head is evaluated at one rec, with
    each batch's targets. Returns [(D gradients, G gradients)] for each
    batch, and the first batch's head cotangent."""
    cfg = jmods.cfg
    vgg = JVGG(dtype=jmods.dtype, precision=cfg.precision)

    def d_loss(dp, b):
        real_st = jnp.concatenate([b["tar_lbl"], b["tar_img"]], axis=-1)
        fake = jmods.netD.apply({"params": dp["netD"]},
                                jnp.concatenate([b["tar_lbl"], rec], axis=-1))
        real = jmods.netD.apply({"params": dp["netD"]}, real_st)
        return 0.5 * (jl.lsgan_loss(fake[-1], False)
                      + jl.lsgan_loss(real[-1], True))

    def head(r, b):
        tar, lbl = b["tar_img"], b["tar_lbl"]
        fake = jmods.netD.apply({"params": new_disc["netD"]},
                                jnp.concatenate([lbl, r], axis=-1))
        real = jax.lax.stop_gradient(jmods.netD.apply(
            {"params": new_disc["netD"]}, jnp.concatenate([lbl, tar], -1)))
        return (jl.lsgan_loss(fake[-1], True)
                + jl.feature_matching_loss(fake, real, cfg.lambda_fml)
                + cfg.lambda_vgg * jl.vgg_perceptual_loss(
                    vgg, state.vgg_params, r, tar)
                + cfg.lambda_grad * jl.gradient_loss(r, tar))

    def gen(gp, b):
        out = j_tsnet_forward(jmods, gp, *(b[k] for k in KEYS),
                              tar_img=b["tar_img"], train=True,
                              use_pallas=True)
        return out["rec_img"], out["loss_warp"], out["loss_align"]

    @jax.jit
    def g_grads(gp, b, ct):
        _, vjp = jax.vjp(lambda p: gen(p, b), gp)
        one = jnp.ones((), jnp.float32)
        return vjp((ct, one, one))[0]

    head_ct = jax.jit(jax.grad(head))
    d_grads = jax.jit(jax.grad(d_loss))
    cts = [head_ct(rec, b) for b in batches]
    return [(d_grads(state.disc_params, b), g_grads(state.gen_params, b, ct))
            for b, ct in zip(batches, cts)], cts[0]


def test_one_train_step_matches_jax(jax_state):
    """Every metric within 1e-4 relative; at temp 10 the D gradient, and
    the decoder's gradient from the same inputs, within 1e-3 of each
    subnet's largest gradient, and every generator subnet's gradient end
    to end within 1e-3 or twice the JAX gradient's own spread under
    1e-6 and 1e-5 input nudges (see below); every parameter after the
    step within 2.5 lr of the JAX package's (the most that one Adam step
    can move an element is lr, so a near-zero gradient whose sign flips
    between the two moves it by 2 lr)."""
    jmods, state, batch = jax_state
    temp = jmods.cfg.softmax_temp
    ours = _port_state(state, temp)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    step = j_make_step(jmods, donate=False, use_pallas=True)
    new, want_m, _ = step(state, jbatch, jnp.float32(LR))

    ours, got_m, rec = make_train_step(ours)(ours, batch, LR)
    assert ours.step == 1 and set(got_m) == set(want_m)
    gen, disc, _ = export_train_state(ours)
    errs = {f"metric_{k}": abs(got_m[k].item() - float(want_m[k]))
            / max(1.0, abs(float(want_m[k]))) for k in want_m}
    diffs = [np.abs(g - np.asarray(w)) for g, w in zip(
        jax.tree_util.tree_leaves((gen, disc)),
        jax.tree_util.tree_leaves((new.gen_params, new.disc_params)))]
    errs["param_max_over_lr"] = max(float(d.max()) for d in diffs) / LR
    errs["param_mean_over_lr"] = float(
        np.concatenate([d.ravel() for d in diffs]).mean()) / LR
    assert max(v for k, v in errs.items() if k.startswith("metric")) <= 1e-4
    assert errs["param_max_over_lr"] <= 2.5, errs
    if temp != 10.0:
        _report(**errs)
        return
    # the gradients at the port's own reconstruction and updated D: a
    # near-zero D gradient whose sign differs between the two packages
    # moves a D weight by 2 lr, which alone changes the G gradients. The
    # JAX gradients are also taken with the input images moved by 1e-6
    # and by 1e-5 relative: how far a small input change moves them
    rng = np.random.default_rng(1)
    batches = [jbatch]
    for eps in (1e-6, 1e-5):
        batches.append(dict(jbatch))
        for k in ("src_img", "tar_img"):
            batches[-1][k] = jbatch[k] * (1 + eps * jnp.asarray(
                rng.standard_normal(batch[k].shape), jnp.float32))
    grads, ct = _jax_grads(jmods, state, disc, batches,
                           jnp.asarray(rec.numpy()))
    d_grads, g_grads = grads[0]
    for name in GEN_SUBNETS:
        errs[f"grad_{name}"] = _subnet_err(
            _port_grads(getattr(ours.mods, name)), g_grads[name])
        errs[f"nudged_{name}"] = max(_subnet_err(
            jax.tree.map(np.asarray, g[name]), g_grads[name])
            for _, g in grads[1:])
    errs["grad_netD"] = _subnet_err(_port_grads(ours.mods.netD),
                                    d_grads["netD"])
    # the decoder's gradient from the same inputs: the port's own decoder
    # inputs (prop_fea, syn_fea) and the head's cotangent, through the JAX
    # decoder and the port's
    fresh = _port_state(state, temp)
    b = _tensors(batch)
    with torch.no_grad():
        out = tsnet_forward(fresh.mods, *(b[k] for k in KEYS),
                            tar_img=b["tar_img"], train=True)
    prop, syn = out["prop_fea"].numpy(), out["syn_fea"].numpy()
    want_dec = jax.jit(jax.grad(lambda p: jnp.sum(decoder_apply_fast(
        jmods.dec, p, jnp.asarray(prop), jnp.asarray(syn))[0] * ct)))(
            state.gen_params["dec"])
    (fresh.mods.dec(torch.from_numpy(prop), torch.from_numpy(syn))
     * torch.from_numpy(np.asarray(ct))).sum().backward()
    errs["grad_dec_same_inputs"] = _subnet_err(_port_grads(fresh.mods.dec),
                                               want_dec)
    _report(**errs)
    assert errs["grad_netD"] <= 1e-3 and errs["grad_dec_same_inputs"] <= 1e-3
    # End to end, the G gradients jump where a small change moves an
    # activation past a kink (ReLU, the L1 losses' signs): the JAX
    # package's own gradients move by up to ~7e-3 - 2.4e-2 of their
    # largest under the input nudges, the port's differ from them by
    # 3e-3 - 8e-3 (and the decoders agree to ~1e-6 given the same inputs
    # and cotangent, as checked above). Each subnet is held within 1e-3
    # or twice that spread.
    for name in GEN_SUBNETS:
        assert errs[f"grad_{name}"] <= max(
            1e-3, 2 * errs[f"nudged_{name}"]), (name, errs)


def test_losses_decrease_on_fixed_batch():
    """Learning dynamics, as tests/test_train_loop.py holds the JAX
    package to them: 40 port steps on one fixed toy batch shrink the
    perceptual loss (last five < 0.7 x first five) and let D separate
    real from fake (D falls)."""
    state = create_train_state(toy_config(), device="cpu", seed=0)
    step = make_train_step(state)
    batch = _batch(toy_config())
    vgg_hist, d_hist = [], []
    for _ in range(40):
        state, metrics, _ = step(state, batch, LR)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
        vgg_hist.append(metrics["G_VGG"].item())
        d_hist.append(metrics["D"].item())
    first, last = np.mean(vgg_hist[:5]), np.mean(vgg_hist[-5:])
    _report(g_vgg_first5=first, g_vgg_last5=last,
            d_first5=np.mean(d_hist[:5]), d_last5=np.mean(d_hist[-5:]))
    assert last < 0.7 * first, (first, last)
    assert np.mean(d_hist[-5:]) < np.mean(d_hist[:5]), d_hist


def test_train_state_round_trip_is_exact(jax_state, tmp_path):
    """The JAX trees go into a port state and come back bit-exact; the
    port's npz loader reads the JAX package's VGG19 file format."""
    jmods, state, _ = jax_state
    gen, disc, vgg = export_train_state(_port_state(
        state, jmods.cfg.softmax_temp))
    for ours, theirs in ((gen, state.gen_params), (disc, state.disc_params),
                         (vgg, state.vgg_params)):
        a = jax.tree_util.tree_leaves_with_path(ours)
        b = dict(jax.tree_util.tree_leaves_with_path(theirs))
        assert len(a) == len(b)
        for path, leaf in a:
            assert np.array_equal(leaf, np.asarray(b[path])), path
    path = tmp_path / "vgg19_features.npz"
    flat = {f"{k}_{leaf}": np.asarray(v[leaf])
            for k, v in state.vgg_params["params"].items()
            for leaf in ("kernel", "bias")}
    np.savez(path, **flat)
    tree = load_vgg19_npz(path)
    for k, v in state.vgg_params["params"].items():
        for leaf in ("kernel", "bias"):
            assert np.array_equal(tree[k][leaf], np.asarray(v[leaf]))
    assert load_vgg19_npz(tmp_path / "missing.npz") is None
    with_file = create_train_state(toy_config(), device="cpu",
                                   vgg_params=tree)
    assert np.array_equal(with_file.vgg.conv3.weight.detach().numpy(),
                          np.asarray(state.vgg_params["params"]["conv3"][
                              "kernel"]).transpose(3, 2, 0, 1))


def test_lr_poly_matches_the_jax_schedule():
    from wacv23_tsnet_tpu.train.schedule import lr_poly as j_lr_poly
    for it in (0, 100, 250, 400, 10_000):
        assert lr_poly(2e-4, it, 200, 400, 0.9) == pytest.approx(
            float(j_lr_poly(2e-4, it, 200, 400, 0.9)), rel=1e-6)
