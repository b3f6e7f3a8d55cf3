"""The port's pose variant against the JAX package (CPU, toy pose config).

The pose variant adds the face discriminator netDF on `crop_faces` of the
reconstruction and the target, paints the background columns with the
mean colour (`composite_foreground`) and drops the align loss. Seeded
numpy inputs (one-hot pose label maps with body regions, and in each
batch a sample with a face blob, one with head classes only, one with
neither and one with a face at the image border) go through the JAX
functions (Pallas in interpret mode, as the face tests run them) and the
port's (its kernels' plain versions on CPU tensors); weights go across
with `compat.flax_params`. `pytest -s` prints each measured error.
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
from wacv23_tsnet_tpu.compat import (
    load_reference_checkpoint as j_load_reference_checkpoint,
    save_reference_checkpoint as j_save_reference_checkpoint)
from wacv23_tsnet_tpu.configs import toy_pose_config as j_toy_pose_config
from wacv23_tsnet_tpu.infer.streaming import RetargetSession as JSession
from wacv23_tsnet_tpu.models import TSNet as JTSNet
from wacv23_tsnet_tpu.models import TSNetModules as JTSNetModules
from wacv23_tsnet_tpu.models.tsnet import (
    composite_foreground as j_composite_foreground, crop_faces as j_crop_faces,
    get_face_bbox as j_get_face_bbox, tsnet_forward as j_tsnet_forward,
    tsnet_forward_clip as j_forward_clip)
from wacv23_tsnet_tpu.nn import VGG19Features as JVGG
from wacv23_tsnet_tpu.nn import load_vgg19_params
from wacv23_tsnet_tpu.ops.resize import _sample_separable as j_sample_separable
from wacv23_tsnet_tpu.train.checkpoint import (
    restore_checkpoint as j_restore_checkpoint,
    save_checkpoint as j_save_checkpoint)
from wacv23_tsnet_tpu.train.state import create_train_state as j_create_state
from wacv23_tsnet_tpu.train.step import make_train_step as j_make_step
from wacv23_tsnet_tpu_torch.compat import (export_flax_params,
                                           export_opt_states,
                                           export_train_state,
                                           load_flax_params,
                                           load_reference_checkpoint,
                                           load_train_state,
                                           save_reference_checkpoint,
                                           state_dict_to_flax)
from wacv23_tsnet_tpu_torch.configs import toy_pose_config
from wacv23_tsnet_tpu_torch.infer import RetargetSession
from wacv23_tsnet_tpu_torch.models import (TSNet, TSNetModules,
                                           tsnet_forward_clip)
from wacv23_tsnet_tpu_torch.models.tsnet import (composite_foreground,
                                                 crop_faces, get_face_bbox)
from wacv23_tsnet_tpu_torch.ops.resize import sample_separable
from wacv23_tsnet_tpu_torch.train import (GEN_SUBNETS, create_train_state,
                                          make_train_step,
                                          restore_checkpoint,
                                          save_checkpoint)

torch.set_num_threads(2)
LR = 2e-4
KEYS = ("src_img", "src_lbl", "src_bbox", "tar_lbl", "tar_bbox")
CASES = ("face", "head", "neither", "border")
# the pose inference tier of the JAX package (bench.py's measure_pose)
POSE_FAST = dict(precision="high", fast_tail=True, fast_trunk=True)


def _report(**errors):
    name = os.environ.get("PYTEST_CURRENT_TEST", "").split()[0]
    print(f"[parity] {name}: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in errors.items()))


def pose_labels(rng, n: int, hw: int, nl: int) -> np.ndarray:
    """n one-hot pose label maps (n, hw, hw, nl) f32: body regions of the
    classes 5..nl-2 on background 0, and by sample i % 4 a face blob
    (class nl-1) in a head (classes 1-4), head classes only, neither, or
    a face in the top-left corner."""
    cls = np.zeros((n, hw, hw), np.int64)
    u = hw // 16
    for i in range(n):
        for _ in range(3):
            y, x = rng.integers(4 * u, 12 * u, 2)
            cls[i, y:y + 3 * u, x:x + 2 * u] = rng.integers(5, nl - 1)
        case = CASES[i % 4]
        y, x = rng.integers(u, 6 * u), rng.integers(5 * u, 10 * u)
        if case in ("face", "head"):
            cls[i, y:y + 3 * u, x:x + 3 * u] = rng.integers(1, 5)
            cls[i, y + u:y + 3 * u, x:x + u] = rng.integers(1, 5)
        if case == "face":
            cls[i, y + u // 2:y + 5 * u // 2, x + u // 2:x + 5 * u // 2] = nl - 1
        if case == "border":
            cls[i, :2 * u, :3 * u] = nl - 1
    return np.eye(nl, dtype=np.float32)[cls]


def _pose_batch(cfg, bs=4, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    s, hw, nl = cfg.n_source, cfg.image_size, cfg.label_nc
    return {"src_img": rng.random((bs, s, hw, hw, 3), np.float32),
            "src_lbl": pose_labels(rng, bs * s, hw, nl).reshape(
                bs, s, hw, hw, nl),
            "src_bbox": rng.integers(0, 2, (bs, s, hw, hw)).astype(
                np.float32),
            "tar_img": rng.random((bs, hw, hw, 3), np.float32),
            "tar_lbl": pose_labels(rng, bs, hw, nl),
            "tar_bbox": rng.integers(0, 2, (bs, hw, hw)).astype(np.float32)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_equal(got, want):
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert set(got) == set(want), set(got) ^ set(want)
    for path, w in want.items():
        assert np.asarray(got[path]).dtype == np.asarray(w).dtype, path
        np.testing.assert_array_equal(got[path], w, err_msg=str(path))


# ------------------------------------------------ crops and compositing

@pytest.mark.parametrize("hw, nl", [(256, 25), (64, 8)])
def test_face_bbox_matches_jax_on_the_four_cases(hw, nl):
    lbl = pose_labels(np.random.default_rng(1), 8, hw, nl)
    want = jax.vmap(lambda m: j_get_face_bbox(m, hw, hw))(jnp.asarray(lbl))
    got = get_face_bbox(torch.from_numpy(lbl))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    yc, xc, ln = (g.numpy() for g in got)
    # the head-only and neither samples take their own branches, and the
    # border face's box is pushed inside the image
    assert ln[2] == hw // 32 * 8 and (yc[2], xc[2]) == (hw // 4, hw // 2)
    assert yc[3] == ln[3] // 2 and xc[3] == ln[3] // 2


@pytest.mark.parametrize("hw, nl", [(256, 25), (64, 8)])
def test_crop_faces_and_its_gradient_match_jax(hw, nl):
    rng = np.random.default_rng(2)
    lbl = pose_labels(rng, 8, hw, nl)
    img = rng.standard_normal((8, hw, hw, 3)).astype(np.float32)
    fs = hw // 32 * 8
    ct = rng.standard_normal((8, fs, fs, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: j_crop_faces(x, jnp.asarray(lbl)),
                        jnp.asarray(img))
    (want_g,) = vjp(jnp.asarray(ct))
    x = torch.from_numpy(img).requires_grad_(True)
    got = crop_faces(x, torch.from_numpy(lbl))
    (got * torch.from_numpy(ct)).sum().backward()
    err = float(np.abs(got.detach().numpy() - np.asarray(want)).max())
    err_g = float(np.abs(x.grad.numpy() - np.asarray(want_g)).max())
    _report(crop_max_abs=err, grad_max_abs=err_g)
    assert got.shape == (8, fs, fs, 3)
    assert err <= 1e-6 and err_g <= 1e-5


def test_sample_separable_matches_jax_per_sample():
    """Each sample's positions, some outside the image (the clamps)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 20, 24, 5)).astype(np.float32)
    ys = (rng.random((3, 7)) * 22 - 1).astype(np.float32)
    xs = (rng.random((3, 9)) * 26 - 1).astype(np.float32)
    got = sample_separable(torch.from_numpy(x), torch.from_numpy(ys),
                           torch.from_numpy(xs)).numpy()
    want = np.stack([np.asarray(j_sample_separable(
        jnp.asarray(x[i:i + 1]), jnp.asarray(ys[i]), jnp.asarray(xs[i])))[0]
        for i in range(3)])
    assert got.shape == (3, 7, 9, 5)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_composite_foreground_is_bit_exact():
    rng = np.random.default_rng(4)
    cfg = toy_pose_config()
    img = rng.standard_normal((2, 3, 64, 64, 3)).astype(np.float32)
    want = np.asarray(j_composite_foreground(jnp.asarray(img),
                                             j_toy_pose_config()))
    got = composite_foreground(torch.from_numpy(img), cfg).numpy()
    np.testing.assert_array_equal(got, want)
    bg = -cfg.img_mean_array() / 255.0
    assert (got[..., :16, :] == bg).all() and (got[..., 48:, :] == bg).all()
    np.testing.assert_array_equal(got[..., 16:48, :], img[..., 16:48, :])


# ------------------------------------------------------- modules, clip

@pytest.mark.parametrize("name", ["toy_pose_config", "pose_config"])
def test_train_modules_hold_netdf(name):
    from wacv23_tsnet_tpu_torch import configs
    cfg = getattr(configs, name)()
    mods = TSNetModules(cfg, device="meta" if name == "pose_config" else
                        "cpu", seed=0, train=True)
    assert mods.netDF.stage0.weight.shape[1] == 3
    # the stems take the labels and three coordinate channels
    assert mods.img_enc.conv_in.weight.shape[1] == 3 + cfg.label_nc + 3
    assert mods.lbl_enc.conv_in.weight.shape[1] == cfg.label_nc + 3
    n_d = sum(p.numel() for p in mods.netD.parameters())
    n_df = sum(p.numel() for p in mods.netDF.parameters())
    assert n_df == n_d - 16 * cfg.ndf * cfg.label_nc
    assert not hasattr(TSNetModules(cfg, device="meta"), "netDF")


@pytest.fixture(scope="module")
def pose_clip():
    """Toy pose weights, one 7-frame clip of pose label maps, and the JAX
    bit-parity output."""
    jcfg = j_toy_pose_config()
    jmods = JTSNetModules(jcfg)
    params = jmods.init_generator_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    s, hw, nl, f = jcfg.n_source, jcfg.image_size, jcfg.label_nc, 7
    inputs = (rng.random((s, hw, hw, 3)).astype(np.float32),
              pose_labels(rng, s, hw, nl),
              rng.integers(0, 2, (s, hw, hw)).astype(np.float32),
              pose_labels(rng, f, hw, nl),
              rng.integers(0, 2, (f, hw, hw)).astype(np.float32))
    want = np.asarray(jax.jit(
        lambda p, *a: j_forward_clip(jmods, p, *a, use_pallas=True))(
            params, *map(jnp.asarray, inputs)))
    return _np(params), inputs, want


def _port(params, **tier):
    mods = TSNetModules(dataclasses.replace(toy_pose_config(), **tier),
                        device="cpu")
    load_flax_params(mods, params)
    return mods


TIERS = {"bit-parity": {}, "fast-tail": dict(precision="high",
                                             fast_tail=True),
         "pose-fast": POSE_FAST}


@pytest.mark.parametrize("tier", list(TIERS))
def test_pose_clip_matches_jax(pose_clip, tier):
    """Against JAX's bit-parity clip: the bit-parity tier within 1e-3 max
    abs; "high" + fast_tail (bf16 tail, K1 with bf16 out) within the 0.01
    mean-L1 budget of the fast tiers, as the face clip is held. The JAX
    package's pose inference tier adds fast_trunk, one bf16 pass through
    the encoders, which with untrained weights the temp-100 attention
    turns into a larger drift (tests/test_torch_slice.py holds its
    encoders): its drift is printed. Every tier composites the
    background exactly."""
    params, inputs, want = pose_clip
    got = tsnet_forward_clip(_port(params, **TIERS[tier]), *inputs,
                             device="cpu").numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    _report(max_abs_err=float(err.max()), mean_abs_err=float(err.mean()))
    if tier == "bit-parity":
        assert err.max() <= 1e-3
    elif tier == "fast-tail":
        assert err.mean() <= 0.01
    bg = -toy_pose_config().img_mean_array() / 255.0
    assert (got[:, :, :16] == bg).all() and (got[:, :, 48:] == bg).all()


def test_pose_session_push_labels_matches_jax(pose_clip):
    """7 frames in chunks of 4 through a pose `RetargetSession` against
    the JAX session, model space within 1e-3 and display within 1 LSB."""
    params, inputs, _ = pose_clip
    mods = _port(params)
    errs = {}
    for output in ("model", "display"):
        jsess = JSession(j_toy_pose_config(), params, *inputs[:3], chunk=4,
                         output=output)
        want = np.asarray(jsess.push_labels(*inputs[3:]))
        got = RetargetSession(mods, *inputs[:3], chunk=4, output=output,
                              device="cpu").push_labels(*inputs[3:])
        assert got.shape == want.shape and got.dtype == want.dtype
        errs[output] = float(np.abs(got.astype(np.float64) - want).max())
    _report(**errs)
    assert errs["model"] <= 1e-3 and errs["display"] <= 1.0


# ------------------------------------------------------------ train step

@pytest.fixture(scope="module", params=[10.0, 100.0],
                ids=["temp10", "temp100"])
def jax_pose_state(request):
    """The JAX pose modules, one toy pose train state and one batch of the
    four label cases, at softmax temperature 10 and at the config's 100
    (where the gradients are printed; see tests/test_torch_train_step.py)."""
    jmods = JTSNetModules(dataclasses.replace(j_toy_pose_config(),
                                              softmax_temp=request.param))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        vgg = load_vgg19_params()
    state = j_create_state(jmods, jax.random.PRNGKey(0), vgg_params=vgg)
    return jmods, state, _pose_batch(toy_pose_config())


def _port_state(state, temp):
    cfg = dataclasses.replace(toy_pose_config(), softmax_temp=temp)
    ours = create_train_state(cfg, device="cpu", seed=3)
    load_train_state(ours, _np(state.gen_params), _np(state.disc_params),
                     _np(state.vgg_params))
    return ours


def _subnet_err(got_tree, want_tree):
    """max |got - want| over a subnet, over its largest |want|."""
    got = jax.tree_util.tree_leaves(got_tree)
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    scale = max(float(np.abs(w).max()) for w in want)
    return max(float(np.abs(g - np.asarray(w)).max())
               for g, w in zip(got, want)) / scale


def _port_grads(module):
    return state_dict_to_flax({
        n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in module.named_parameters()})


def _jax_grads(jmods, state, new_disc, batches, rec):
    """As tests/test_torch_train_step.py composes them, with the face
    discriminator's terms: the D loss (D + DF) on `rec`; the G loss's head
    (GAN, feature matching, VGG, gradient and the GF terms on the face
    crops, against `new_disc`) differentiated at `rec`, and that
    cotangent with the warp loss taken back through the JAX generator's
    VJP. Returns [(D gradients, G gradients)] for each batch."""
    cfg = jmods.cfg
    vgg = JVGG(dtype=jmods.dtype, precision=cfg.precision)

    def d_loss(dp, b):
        lbl = b["tar_lbl"]
        fake = jmods.netD.apply({"params": dp["netD"]},
                                jnp.concatenate([lbl, rec], axis=-1))
        real = jmods.netD.apply({"params": dp["netD"]},
                                jnp.concatenate([lbl, b["tar_img"]], -1))
        pf = jmods.netDF.apply({"params": dp["netDF"]}, j_crop_faces(rec, lbl))
        pr = jmods.netDF.apply({"params": dp["netDF"]},
                               j_crop_faces(b["tar_img"], lbl))
        return 0.5 * (jl.lsgan_loss(fake[-1], False)
                      + jl.lsgan_loss(real[-1], True)
                      + jl.lsgan_loss(pf[-1], False)
                      + jl.lsgan_loss(pr[-1], True))

    def head(r, b):
        tar, lbl = b["tar_img"], b["tar_lbl"]
        fake = jmods.netD.apply({"params": new_disc["netD"]},
                                jnp.concatenate([lbl, r], axis=-1))
        real = jax.lax.stop_gradient(jmods.netD.apply(
            {"params": new_disc["netD"]}, jnp.concatenate([lbl, tar], -1)))
        ff, rf = j_crop_faces(r, lbl), j_crop_faces(tar, lbl)
        pf = jmods.netDF.apply({"params": new_disc["netDF"]}, ff)
        pr = jax.lax.stop_gradient(
            jmods.netDF.apply({"params": new_disc["netDF"]}, rf))
        return (jl.lsgan_loss(fake[-1], True)
                + jl.feature_matching_loss(fake, real, cfg.lambda_fml)
                + cfg.lambda_vgg * jl.vgg_perceptual_loss(
                    vgg, state.vgg_params, r, tar)
                + cfg.lambda_grad * jl.gradient_loss(r, tar)
                + jl.lsgan_loss(pf[-1], True)
                + jl.feature_matching_loss(pf, pr, cfg.lambda_fml)
                + cfg.lambda_vgg * jl.vgg_perceptual_loss(
                    vgg, state.vgg_params, ff, rf))

    def gen(gp, b):
        out = j_tsnet_forward(jmods, gp, *(b[k] for k in KEYS),
                              tar_img=b["tar_img"], train=True,
                              use_pallas=True)
        return out["rec_img"], out["loss_warp"]

    @jax.jit
    def g_grads(gp, b, ct):
        _, vjp = jax.vjp(lambda p: gen(p, b), gp)
        return vjp((ct, jnp.ones((), jnp.float32)))[0]

    head_ct = jax.jit(jax.grad(head))
    d_grads = jax.jit(jax.grad(d_loss))
    return [(d_grads(state.disc_params, b),
             g_grads(state.gen_params, b, head_ct(rec, b))) for b in batches]


def test_one_pose_train_step_matches_jax(jax_pose_state):
    """tests/test_torch_train_step.py's comparison on the pose variant:
    the 16 metrics within 1e-4 relative; every parameter after the step
    (netDF's too) within 2.5 lr of JAX's; at temp 10 the netD and netDF
    gradients within 1e-3 of each one's largest, and every generator
    subnet's within 1e-3 or twice the JAX gradient's own spread under
    1e-6 and 1e-5 input nudges."""
    jmods, state, batch = jax_pose_state
    temp = jmods.cfg.softmax_temp
    ours = _port_state(state, temp)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    step = j_make_step(jmods, donate=False, use_pallas=True)
    new, want_m, _ = step(state, jbatch, jnp.float32(LR))

    ours, got_m, rec = make_train_step(ours)(ours, batch, LR)
    assert set(got_m) == set(want_m) and len(got_m) == 16
    gen, disc, _ = export_train_state(ours)
    assert set(disc) == {"netD", "netDF"}
    errs = {f"metric_{k}": abs(got_m[k].item() - float(want_m[k]))
            / max(1.0, abs(float(want_m[k]))) for k in want_m}
    diffs = [np.abs(g - np.asarray(w)) for g, w in zip(
        jax.tree_util.tree_leaves((gen, disc)),
        jax.tree_util.tree_leaves((new.gen_params, new.disc_params)))]
    errs["param_max_over_lr"] = max(float(d.max()) for d in diffs) / LR
    assert max(v for k, v in errs.items() if k.startswith("metric")) <= 1e-4
    assert errs["param_max_over_lr"] <= 2.5, errs
    if temp != 10.0:
        _report(**errs)
        return
    rng = np.random.default_rng(1)
    batches = [jbatch]
    for eps in (1e-6, 1e-5):
        batches.append(dict(jbatch))
        for k in ("src_img", "tar_img"):
            batches[-1][k] = jbatch[k] * (1 + eps * jnp.asarray(
                rng.standard_normal(batch[k].shape), jnp.float32))
    grads = _jax_grads(jmods, state, disc, batches, jnp.asarray(rec.numpy()))
    d_grads, g_grads = grads[0]
    for name in ("netD", "netDF"):
        errs[f"grad_{name}"] = _subnet_err(
            _port_grads(getattr(ours.mods, name)), d_grads[name])
    for name in GEN_SUBNETS:
        errs[f"grad_{name}"] = _subnet_err(
            _port_grads(getattr(ours.mods, name)), g_grads[name])
        errs[f"nudged_{name}"] = max(_subnet_err(
            _np(g[name]), g_grads[name]) for _, g in grads[1:])
    _report(**errs)
    assert errs["grad_netD"] <= 1e-3 and errs["grad_netDF"] <= 1e-3, errs
    for name in GEN_SUBNETS:
        assert errs[f"grad_{name}"] <= max(
            1e-3, 2 * errs[f"nudged_{name}"]), (name, errs)


# ------------------------------------------------------------ checkpoints

@pytest.fixture(scope="module")
def jax_pose_snapshot():
    """A JAX pose train state with seeded random Adam moments, count and
    step 3."""
    state = j_create_state(JTSNetModules(j_toy_pose_config()),
                           jax.random.PRNGKey(7))
    rng = np.random.default_rng(3)

    def seeded(opt):
        rand = lambda t: jax.tree.map(  # noqa: E731
            lambda x: (1e-3 * rng.standard_normal(x.shape)).astype(
                np.float32), t)
        return opt._replace(count=jnp.int32(3), mu=rand(opt.mu),
                            nu=jax.tree.map(np.abs, rand(opt.nu)))

    return state.replace(step=jnp.int32(3),
                         gen_opt_state=seeded(state.gen_opt_state),
                         disc_opt_state=seeded(state.disc_opt_state))


def test_pose_trainer_snapshot_jax_to_port_and_back(tmp_path,
                                                    jax_pose_snapshot):
    """A JAX pose snapshot ({netD, netDF} and their Adam moments) restores
    into the port exactly, and the port's file restores in JAX exactly."""
    js = jax_pose_snapshot
    path = str(tmp_path / "TSNet_S000003.msgpack")
    j_save_checkpoint(path, js)
    ours = create_train_state(toy_pose_config(), device="cpu", seed=11)
    assert restore_checkpoint(path, ours) is ours and ours.step == 3
    gen, disc, _ = export_train_state(ours)
    _assert_trees_equal(gen, _np(js.gen_params))
    _assert_trees_equal(disc, _np(js.disc_params))
    gen_opt, disc_opt = export_opt_states(ours)
    for got, want in ((gen_opt, js.gen_opt_state),
                      (disc_opt, js.disc_opt_state)):
        _assert_trees_equal(got, {"count": np.asarray(want.count),
                                  "mu": _np(want.mu), "nu": _np(want.nu)})
    assert [g["name"] for g in ours.disc_opt.param_groups] == ["netD",
                                                               "netDF"]
    back = str(tmp_path / "TSNet_S000004.msgpack")
    save_checkpoint(back, ours)
    restored = j_restore_checkpoint(back, js)
    for field in ("step", "gen_params", "disc_params", "gen_opt_state",
                  "disc_opt_state"):
        _assert_trees_equal(_np(getattr(restored, field)),
                            _np(getattr(js, field)))


def test_pth_with_netdf_both_ways():
    """A reference `.pth` with netD and netDF: written by the port, read
    by the JAX package; written by the JAX package, read by the port.
    d_n_layers=3, the reference's, which the JAX reader assumes."""
    import tempfile
    cfg = dataclasses.replace(toy_pose_config(), d_n_layers=3)
    state = create_train_state(cfg, device="cpu", seed=6)
    tree = export_flax_params(state.mods)
    disc = {name: tree.pop(name) for name in ("netD", "netDF")}
    with tempfile.TemporaryDirectory() as tmp:
        ours = os.path.join(tmp, "port.pth")
        save_reference_checkpoint(ours, tree, cfg, example=5,
                                  disc_params=disc)
        params, example = j_load_reference_checkpoint(
            ours, cfg, include_discriminators=True)
        assert example == 5
        _assert_trees_equal(_np(params), {**tree, **disc})
        theirs = os.path.join(tmp, "jax.pth")
        j_save_reference_checkpoint(theirs, tree, cfg, example=9,
                                    disc_params=disc)
        params, example = load_reference_checkpoint(
            theirs, cfg, include_discriminators=True)
        assert example == 9
        _assert_trees_equal(params, {**tree, **disc})


# -------------------------------------------------------------- TSNet API

def test_tsnet_pose_losses_and_one_update():
    """`TSNet(toy_pose_config)` names the JAX package's 16 pose losses,
    and one `optimize_parameters` on a reference-layout batch gives finite
    losses and a reconstruction with the mean colour in its background
    columns (tests/test_pose_variant.py's contract)."""
    cfg = toy_pose_config()
    model = TSNet(cfg, is_train=True, device="cpu")
    want = JTSNet(j_toy_pose_config(), is_train=True,
                  use_pallas=False).loss_names
    assert model.loss_names == list(want)
    b = _pose_batch(cfg, bs=2, seed=5)
    nchw = lambda x: np.ascontiguousarray(np.moveaxis(x, -1, 1))  # noqa
    srcs = [nchw(b["src_img"][:, i]) * 255 for i in range(cfg.n_source)]
    lbls = [nchw(b["src_lbl"][:, i]) for i in range(cfg.n_source)]
    boxes = [b["src_bbox"][:, i] for i in range(cfg.n_source)]
    model.setup(0, 2, 100, 1000, 1.0)
    model.set_train_input(srcs, lbls, boxes, nchw(b["tar_img"]) * 255,
                          nchw(b["tar_lbl"]), b["tar_bbox"])
    model.optimize_parameters()
    losses = model.get_current_losses()
    assert list(losses) == list(want)
    assert all(np.isfinite(v) for v in losses.values()), losses
    rec = model.rec_tar_img
    bg = (-cfg.img_mean_array() / 255.0).reshape(1, 3, 1, 1)
    assert (rec[..., :16] == bg).all() and (rec[..., 48:] == bg).all()
    model.forward()
    assert (model.warp_src_img_list[0][..., :16] == bg).all()
