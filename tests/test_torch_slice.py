"""The port's clip-inference slice against the JAX package (CPU, toy config).

The same flax weights (carried with `compat.flax_params`) and the same
numpy inputs go through JAX `tsnet_forward_clip(use_pallas=True)`, whose
Pallas kernels run in interpret mode, and through the port, whose kernel
wrappers run their plain versions on CPU tensors.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wacv23_tsnet_tpu.configs import toy_config as j_toy_config
from wacv23_tsnet_tpu.models import TSNetModules as JTSNetModules
from wacv23_tsnet_tpu.models import tsnet_forward_clip as j_forward_clip
from wacv23_tsnet_tpu_torch.compat import load_flax_params
from wacv23_tsnet_tpu_torch.configs import toy_config
from wacv23_tsnet_tpu_torch.infer import RetargetSession
from wacv23_tsnet_tpu_torch.models import TSNetModules, tsnet_forward_clip
from wacv23_tsnet_tpu_torch.nn.blocks import ResnetBlock
from wacv23_tsnet_tpu_torch.train import create_train_state

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST_TAIL = dict(precision="high", fast_tail=True)


def _report(**errors):
    """The measured errors, shown by `pytest -s`."""
    name = os.environ.get("PYTEST_CURRENT_TEST", "").split()[0]
    print(f"[parity] {name}: " + " ".join(
        f"{k}={v:.3e}" for k, v in errors.items()))


@pytest.fixture(scope="module")
def clip():
    """Toy weights, one 7-frame clip, and the JAX bit-parity output."""
    jcfg = j_toy_config()
    jmods = JTSNetModules(jcfg)
    params = jmods.init_generator_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    s, hw, nl, f = jcfg.n_source, jcfg.image_size, jcfg.label_nc, 7
    inputs = (rng.random((s, hw, hw, 3)).astype(np.float32),
              rng.integers(0, 2, (s, hw, hw, nl)).astype(np.float32),
              rng.integers(0, 2, (s, hw, hw)).astype(np.float32),
              rng.integers(0, 2, (f, hw, hw, nl)).astype(np.float32),
              rng.integers(0, 2, (f, hw, hw)).astype(np.float32))
    want = np.asarray(jax.jit(
        lambda p, *a: j_forward_clip(jmods, p, *a, use_pallas=True))(
            params, *map(jnp.asarray, inputs)))
    return jax.tree.map(np.asarray, params), inputs, want


def _port(params, **tier):
    mods = TSNetModules(dataclasses.replace(toy_config(), **tier),
                        device="cpu")
    load_flax_params(mods, params)
    return mods


def test_forward_clip_bit_parity_tier(clip):
    params, inputs, want = clip
    got = tsnet_forward_clip(_port(params), *inputs, device="cpu").numpy()
    assert got.shape == want.shape
    _report(max_abs_err=np.abs(got - want).max())
    assert np.abs(got - want).max() <= 1e-3


def test_fast_tail_tier_within_budget_of_jax_bit_parity(clip):
    """precision="high" + fast_tail (bf16 FuseNet and decoder, K1 with
    bf16 out) against the JAX bit-parity output: the JAX package's 0.01
    mean-L1 budget for its fast tiers."""
    params, inputs, want = clip
    got = tsnet_forward_clip(_port(params, **FAST_TAIL), *inputs,
                             device="cpu").numpy()
    _report(mean_abs_err=np.abs(got - want).mean())
    assert np.abs(got - want).mean() <= 0.01


def test_fast_trunk_encoders_are_one_bf16_pass(clip):
    """fast_trunk runs the encoders' convs as one bf16 pass with f32
    activations: their features stay within bf16 resolution of the JAX
    f32 encoders. (With untrained weights the temp-100 attention turns
    that into a larger output drift; see ROADMAP.md queue 3.)"""
    params, inputs, want_clip = clip
    jmods = JTSNetModules(j_toy_config())
    src_img, src_lbl = inputs[0], inputs[1]
    enc_in = np.concatenate([src_img, src_lbl], axis=-1)
    want = np.asarray(jmods.img_enc.apply({"params": params["img_enc"]},
                                          jnp.asarray(enc_in)))
    mods = _port(params, fast_trunk=True, **FAST_TAIL)
    with torch.inference_mode():
        got = mods.img_enc(torch.from_numpy(enc_in)).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    full = tsnet_forward_clip(mods, *inputs, device="cpu").numpy()
    _report(encoder_rel_err=rel,
            full_tier_mean_abs_err=np.abs(full - want_clip).mean())
    assert 0.0 < rel <= 2e-2
    assert full.shape == want_clip.shape and np.isfinite(full).all()


@pytest.mark.parametrize("output", ["model", "display"])
def test_session_push_labels_matches_forward_clip(clip, output):
    params, inputs, _ = clip
    mods = _port(params)
    want = tsnet_forward_clip(mods, *inputs, device="cpu").numpy()
    session = RetargetSession(mods, *inputs[:3], chunk=3, output=output,
                              device="cpu")
    tar_lbl, tar_bbox = inputs[3], inputs[4]
    got = session.push_labels(tar_lbl, tar_bbox)   # chunks of 3, 3, 1
    assert got.shape == want.shape
    if output == "model":
        _report(max_abs_err=np.abs(got - want).max())
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        mean = toy_config().img_mean_array()
        want_u8 = np.clip(np.round(want * 255.0 + mean), 0, 255)
        assert got.dtype == np.uint8
        assert np.abs(got.astype(np.int32) - want_u8).max() <= 1


def test_session_takes_class_map_labels(clip):
    params, inputs, _ = clip
    mods = _port(params)
    cls_map = np.random.default_rng(1).integers(
        0, 2, inputs[4].shape).astype(np.uint8)
    onehot = np.eye(2, dtype=np.float32)[cls_map]
    session = RetargetSession(mods, *inputs[:3], chunk=4, device="cpu")
    np.testing.assert_allclose(
        session.push_labels(cls_map, inputs[4].astype(np.uint8)),
        session.push_labels(onehot, inputs[4]), atol=1e-6)


@pytest.mark.parametrize("name", ["face_config", "toy_config",
                                  "pose_config", "toy_pose_config",
                                  "TrainConfig"])
def test_config_copy_matches_the_jax_package(name):
    from wacv23_tsnet_tpu import configs as jax_configs
    from wacv23_tsnet_tpu_torch import configs
    ours, theirs = getattr(configs, name)(), getattr(jax_configs, name)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    props = (("num_examples_per_epoch", "initial_iter", "max_iter")
             if name == "TrainConfig" else ("feat_ch", "feat_size"))
    for prop in props:
        assert getattr(ours, prop) == getattr(theirs, prop), prop
    if name == "TrainConfig":
        odd = dict(batch_size=7, n_frame_total=9, num_videos=13,
                   max_epoch=5, initial_epoch=2)
        ours, theirs = configs.TrainConfig(**odd), jax_configs.TrainConfig(
            **odd)
        for prop in props:
            assert getattr(ours, prop) == getattr(theirs, prop), prop
    else:
        assert np.array_equal(ours.img_mean_array(), theirs.img_mean_array())


@pytest.mark.parametrize("knob", ["ring_pad"])
def test_unported_knobs_are_refused(knob):
    """No knob is refused now: `ring_pad`, the last the port lacked, builds
    modules whose encoders, FuseNet and every ResNet block run their
    reflect-pad convs without the padded tensor
    (tests/test_torch_ring_pad.py holds it to JAX)."""
    cfg = dataclasses.replace(toy_config(), **{knob: True})
    mods = TSNetModules(cfg, device="cpu")
    blocks = [m for m in mods.modules() if isinstance(m, ResnetBlock)]
    assert mods.img_enc.ring_pad and mods.lbl_enc.ring_pad
    assert mods.fuse_net.ring_pad
    assert all(b.ring_pad for b in blocks)
    assert len(blocks) == cfg.enc_n_blocks + cfg.dec_n_blocks + 1


@pytest.mark.parametrize("knob", ["use_fg_mask", "use_face_d"])
def test_pose_knobs_build_and_run_a_toy_forward(knob):
    """Each pose knob alone on the face toy config builds the train
    modules and runs a train-mode forward: `use_face_d` adds netDF,
    `use_fg_mask` paints the background columns of the reconstruction
    and of the warped sources with the mean colour."""
    from wacv23_tsnet_tpu_torch.models import tsnet_forward
    cfg = dataclasses.replace(toy_config(), **{knob: True})
    mods = TSNetModules(cfg, device="cpu", train=True)
    assert hasattr(mods, "netDF") == (knob == "use_face_d")
    rng = np.random.default_rng(0)
    s, hw, nl = cfg.n_source, cfg.image_size, cfg.label_nc
    b = [torch.from_numpy(x.astype(np.float32)) for x in (
        rng.random((1, s, hw, hw, 3)), rng.integers(0, 2, (1, s, hw, hw, nl)),
        rng.integers(0, 2, (1, s, hw, hw)), rng.integers(0, 2, (1, hw, hw, nl)),
        rng.integers(0, 2, (1, hw, hw)), rng.random((1, hw, hw, 3)))]
    with torch.no_grad():
        out = tsnet_forward(mods, *b[:5], tar_img=b[5], train=True)
    rec, warp = out["rec_img"], out["warp_imgs"]
    assert rec.shape == (1, hw, hw, 3) and bool(torch.isfinite(rec).all())
    bg = torch.from_numpy(-cfg.img_mean_array() / 255.0)
    painted = bool((rec[:, :, :hw // 4] == bg).all()
                   and (warp[..., 3 * hw // 4:, :] == bg).all())
    assert painted == (knob == "use_fg_mask")


def _train_grads(cfg):
    """The generator's flat gradient of one toy train-mode forward, and
    the bytes autograd saved for it."""
    from wacv23_tsnet_tpu_torch.models import tsnet_forward
    mods = TSNetModules(cfg, device="cpu", train=True)
    rng = np.random.default_rng(0)
    s, hw, nl = cfg.n_source, cfg.image_size, cfg.label_nc
    b = {"src_img": rng.random((1, s, hw, hw, 3)),
         "src_lbl": rng.integers(0, 2, (1, s, hw, hw, nl)),
         "src_bbox": rng.integers(0, 2, (1, s, hw, hw)),
         "tar_img": rng.random((1, hw, hw, 3)),
         "tar_lbl": rng.integers(0, 2, (1, hw, hw, nl)),
         "tar_bbox": rng.integers(0, 2, (1, hw, hw))}
    b = {k: torch.from_numpy(v.astype(np.float32)) for k, v in b.items()}
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tsnet_forward(mods, *(b[k] for k in ("src_img", "src_lbl",
                                                   "src_bbox", "tar_lbl",
                                                   "tar_bbox")),
                            tar_img=b["tar_img"], train=True)
    (out["rec_img"].square().mean() + out["loss_warp"]).backward()
    grad = torch.cat([p.grad.reshape(-1) for n, p in mods.named_parameters()
                      if p.grad is not None and not n.startswith("netD")])
    return out["rec_img"].detach(), grad, sum(saved)


@pytest.mark.parametrize("knob", ["bwd_precision", "remat"])
def test_training_knobs_change_the_computation(knob):
    """Neither knob is ignored: `bwd_precision="default"` keeps the
    forward and moves the gradients by bf16 rounding; `remat=True` keeps
    forward and gradients and saves fewer bytes for the backward."""
    base = toy_config()
    rec, grad, saved = _train_grads(base)
    value = "default" if knob == "bwd_precision" else True
    rec_k, grad_k, saved_k = _train_grads(
        dataclasses.replace(base, **{knob: value}))
    assert torch.equal(rec, rec_k)
    rel = float((grad - grad_k).norm() / grad.norm())
    if knob == "bwd_precision":
        assert 0.0 < rel <= 5e-2, rel
        assert saved_k == saved
    else:
        assert rel <= 1e-6 and saved_k < saved, (rel, saved_k, saved)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSNetModules(toy_config())
    mods = TSNetModules(toy_config(), device="cpu")
    z = np.zeros((1, 64, 64, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsnet_forward_clip(mods, z, z[..., :2], z[..., 0], z[..., :2],
                           z[..., 0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RetargetSession(mods, z, z[..., :2], z[..., 0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_train_state(toy_config())


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port imports with `jax`, `flax`, `msgpack`,
    `wacv23_tsnet_tpu` and the image libraries `PIL`, `cv2`, `imageio`
    and `matplotlib` (matched by exact name, not as a prefix) blocked."""
    script = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys

        BLOCKED = ("jax", "flax", "msgpack", "wacv23_tsnet_tpu", "PIL",
                   "cv2", "imageio", "matplotlib")

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                    raise ImportError(f"blocked import: {name}")
                return None

        sys.meta_path.insert(0, Block())
        import wacv23_tsnet_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        leaked = [m for m in sys.modules if any(
            m == b or m.startswith(b + ".") for b in BLOCKED)]
        assert not leaked, leaked
        print(len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    # the clip slice's modules, the train slice's (losses, nn.vgg,
    # nn.discriminator, ops.warp, train), the serving slice's (cli,
    # data, compat.flax_msgpack / torch_import / torch_export,
    # train.checkpoint) and the train-from-disk slice's (utils, data
    # image_io / rasterize / augment / datasets / loader, ops.dpconv,
    # models.api, infer.pipeline / metrics, train.loop, cli.train_face)
    # and the test-time slice's (data.smoothing / gif, utils.profiling,
    # cli.eval_snapshots / quick_start / profile_stages) and the pose
    # data slice's (data.jpeg / codecs / posenorm, cli.train_pose /
    # demo_pose / smooth_keypoints) and the multi-device, zoo and tools
    # slice's (parallel / parallel.launch / mesh / spmd, nn.generators,
    # utils.font / viz, cli.bench_sweep / plot_history) and the last
    # modules' (ops.upconv / reflectconv / stemconv, native /
    # native.build, compat.export_vgg19)
    assert int(proc.stdout.strip()) >= 88
