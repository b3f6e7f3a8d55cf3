"""The port's checkpoint I/O against the JAX package's (CPU, toy config).

Files go both ways, exactly (atol=0): flax msgpack bytes against
`flax.serialization`, generator files and trainer snapshots (with their
Adam moments and counts) through the JAX package's `save_checkpoint` /
`restore_checkpoint`, and the reference `.pth` format through its
`compat` converters and demo loader. One Adam update from a restored
state is held against `optax.scale_by_adam`, and resume in the port
against straight training.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from wacv23_tsnet_tpu.cli.demo_face import load_params as j_load_params
from wacv23_tsnet_tpu.compat import (
    save_reference_checkpoint as j_save_reference_checkpoint)
from wacv23_tsnet_tpu.configs import toy_config as j_toy_config
from wacv23_tsnet_tpu.models import TSNetModules as JTSNetModules
from wacv23_tsnet_tpu.train.checkpoint import (
    find_latest_checkpoint as j_find_latest,
    restore_checkpoint as j_restore_checkpoint,
    save_checkpoint as j_save_checkpoint)
from wacv23_tsnet_tpu.train.state import (
    create_train_state as j_create_train_state)
from wacv23_tsnet_tpu_torch.cli.demo_face import load_params
from wacv23_tsnet_tpu_torch.compat import (
    export_flax_params, export_opt_states, flax_msgpack,
    generator_params_from_checkpoint, load_flax_params,
    load_reference_checkpoint, load_train_state, reference_checkpoint,
    save_reference_checkpoint)
from wacv23_tsnet_tpu_torch.configs import toy_config
from wacv23_tsnet_tpu_torch.models import TSNetModules
from wacv23_tsnet_tpu_torch.train import (GEN_SUBNETS, create_train_state,
                                          find_latest_checkpoint,
                                          make_train_step,
                                          restore_checkpoint,
                                          restore_generator_params,
                                          save_checkpoint,
                                          save_generator_params)

torch.set_num_threads(2)
BETAS = (0.5, 0.999)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: x is None)


def _assert_trees_equal(got, want):
    """Same paths, and every leaf the same value, dtype and shape."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want), set(got) ^ set(want)
    for path, w in want.items():
        g = got[path]
        if w is None:
            assert g is None, path
            continue
        assert isinstance(g, np.generic) == isinstance(w, np.generic), path
        assert np.shape(g) == np.shape(w), path
        assert np.asarray(g).dtype == np.asarray(w).dtype, path
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------- codec

def _codec_trees():
    rng = np.random.default_rng(0)
    return {
        "f32": {"conv": {"kernel": rng.standard_normal((3, 3, 4, 5)).astype(
            np.float32), "bias": rng.standard_normal(5).astype(np.float32)}},
        "int32": {"ids": rng.integers(-2**31, 2**31 - 1, 300).astype(
            np.int32), "small": np.arange(3, dtype=np.int32)},
        "zero_d": {"step": np.asarray(7, np.int32),
                   "scalar": np.float32(2.5), "count": np.int32(-3)},
        "nil": {"gen": {"w": np.ones((2, 2), np.float32)},
                "vgg_params": None},
        # map16, str8, bin16/bin32 payloads, ext16/ext32, every int form
        "long_forms": {
            **{f"k{i:02d}": np.full((i,), i, np.float32) for i in range(20)},
            "a_key_longer_than_thirty_one_bytes": np.zeros(
                (70000,), np.uint8),
            "mid": np.zeros((1000,), np.float32),
            "ints": {"a": 5, "b": -7, "c": 200, "d": -100, "e": 70000,
                     "f": -40000, "g": 2**40, "h": -2**40}},
    }


@pytest.mark.parametrize("name", list(_codec_trees()))
def test_msgpack_codec_matches_flax(name):
    tree = _codec_trees()[name]
    want = serialization.to_bytes(tree)
    assert flax_msgpack.dumps(tree) == want
    _assert_trees_equal(flax_msgpack.loads(want),
                        serialization.msgpack_restore(want))


def test_msgpack_codec_reads_a_jax_train_state():
    state = j_create_train_state(JTSNetModules(j_toy_config()),
                                 jax.random.PRNGKey(0))
    data = serialization.to_bytes(state)
    got = flax_msgpack.loads(data)
    _assert_trees_equal(got, serialization.msgpack_restore(data))
    # and writes it back byte for byte
    assert flax_msgpack.dumps(got) == data


def _chunked_bytes():
    old = serialization.MAX_CHUNK_SIZE
    serialization.MAX_CHUNK_SIZE = 16
    try:
        return serialization.to_bytes({"w": np.zeros(64, np.float32)})
    finally:
        serialization.MAX_CHUNK_SIZE = old


@pytest.mark.parametrize("case, match", [
    ("ext_type", "ext type 5"),
    ("bfloat16", "bfloat16"),
    ("chunked", "__msgpack_chunked_array__"),
    ("float", "0xcb"),
])
def test_msgpack_codec_refusals(case, match):
    data = {
        "ext_type": lambda: msgpack.packb({"a": msgpack.ExtType(5, b"xy")}),
        "bfloat16": lambda: serialization.to_bytes(
            {"w": jnp.ones((2,), jnp.bfloat16)}),
        "chunked": _chunked_bytes,
        "float": lambda: msgpack.packb({"lr": 0.5}),
    }[case]()
    with pytest.raises(ValueError, match=match):
        flax_msgpack.loads(data)


def test_msgpack_codec_refuses_to_write_bfloat16():
    with pytest.raises(ValueError, match="bfloat16"):
        flax_msgpack.dumps({"w": np.asarray(jnp.ones((2,), jnp.bfloat16))})


# ----------------------------------------------------- generator files

@pytest.fixture(scope="module")
def gen_params():
    """Toy generator params of the JAX package, numpy leaves."""
    params = JTSNetModules(j_toy_config()).init_generator_params(
        jax.random.PRNGKey(5))
    return jax.tree.map(np.asarray, params)


def _port_generator(mods):
    tree = export_flax_params(mods)
    return {k: tree[k] for k in GEN_SUBNETS}


def test_generator_file_jax_to_port(tmp_path, gen_params):
    path = str(tmp_path / "gen.msgpack")
    j_save_checkpoint(path, gen_params)
    mods = TSNetModules(toy_config(), device="cpu", seed=1)
    assert restore_generator_params(path, mods) is mods
    _assert_trees_equal(_port_generator(mods), gen_params)
    _assert_trees_equal(restore_generator_params(path), gen_params)


def test_generator_file_port_to_jax(tmp_path, gen_params):
    mods = TSNetModules(toy_config(), device="cpu", seed=2)
    path = str(tmp_path / "gen.msgpack")
    save_generator_params(path, mods)
    assert not os.path.exists(path + ".tmp")
    restored = j_restore_checkpoint(path, gen_params)
    _assert_trees_equal(jax.tree.map(np.asarray, restored),
                        _port_generator(mods))


def test_generator_file_round_trip_in_the_bench_tier(tmp_path, gen_params):
    """The bf16 tail casts f32 parameters where it computes: its modules
    load and export the f32 tree exactly."""
    cfg = dataclasses.replace(toy_config(), precision="high",
                              fast_tail=True, fast_trunk=True)
    mods = TSNetModules(cfg, device="cpu")
    load_flax_params(mods, gen_params)
    path = str(tmp_path / "gen.msgpack")
    save_generator_params(path, mods)
    _assert_trees_equal(restore_generator_params(path), gen_params)


def test_generator_export_refuses_bf16_parameters(tmp_path):
    mods = TSNetModules(toy_config(), device="cpu").to(torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        save_generator_params(str(tmp_path / "gen.msgpack"), mods)


# ------------------------------------------------------ trainer snapshots

@pytest.fixture(scope="module")
def jax_state():
    """A JAX train state whose Adam moments are seeded random, count 3,
    step 3."""
    state = j_create_train_state(JTSNetModules(j_toy_config()),
                                 jax.random.PRNGKey(7))
    rng = np.random.default_rng(3)

    def seeded(opt, scale):
        rand = lambda t: jax.tree.map(  # noqa: E731
            lambda x: (scale * rng.standard_normal(x.shape)).astype(
                np.float32), t)
        return opt._replace(count=jnp.int32(3), mu=rand(opt.mu),
                            nu=jax.tree.map(np.abs, rand(opt.nu)))

    return state.replace(step=jnp.int32(3),
                         gen_opt_state=seeded(state.gen_opt_state, 1e-3),
                         disc_opt_state=seeded(state.disc_opt_state, 1e-3))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_opt_tree(opt_state):
    return {"count": np.asarray(opt_state.count), "mu": _np(opt_state.mu),
            "nu": _np(opt_state.nu)}


def test_trainer_snapshot_jax_to_port_and_back(tmp_path, jax_state):
    path = str(tmp_path / "TSNet_S000003.msgpack")
    j_save_checkpoint(path, jax_state)
    ours = create_train_state(toy_config(), device="cpu", seed=11)
    assert restore_checkpoint(path, ours) is ours
    assert ours.step == 3
    tree = export_flax_params(ours.mods)
    disc = {"netD": tree.pop("netD")}
    _assert_trees_equal(tree, _np(jax_state.gen_params))
    _assert_trees_equal(disc, _np(jax_state.disc_params))
    gen_opt, disc_opt = export_opt_states(ours)
    _assert_trees_equal(gen_opt, _port_opt_tree(jax_state.gen_opt_state))
    _assert_trees_equal(disc_opt, _port_opt_tree(jax_state.disc_opt_state))
    for opt in (ours.gen_opt, ours.disc_opt):
        for group in opt.param_groups:
            for p in group["params"]:
                assert opt.state[p]["step"].item() == 3.0

    back = str(tmp_path / "TSNet_S000004.msgpack")
    save_checkpoint(back, ours)
    restored = j_restore_checkpoint(back, jax_state)
    for field in ("step", "gen_params", "disc_params", "gen_opt_state",
                  "disc_opt_state"):
        _assert_trees_equal(_np(getattr(restored, field)),
                            _np(getattr(jax_state, field)))
    # the port always carries its VGG19, so the file does too
    _assert_trees_equal(_np(restored.vgg_params),
                        {"params": export_flax_params(ours.vgg)})


def test_fresh_port_state_exports_optax_init(jax_state):
    """No step taken: zeros and count 0, as `scale_by_adam().init`."""
    ours = create_train_state(toy_config(), device="cpu", seed=0)
    gen_opt, _ = export_opt_states(ours)
    want = optax.scale_by_adam(*BETAS).init(_np(jax_state.gen_params))
    assert int(gen_opt["count"]) == 0
    _assert_trees_equal(gen_opt["mu"], _np(want.mu))
    _assert_trees_equal(gen_opt["nu"], _np(want.nu))


def test_one_adam_update_matches_optax(tmp_path, jax_state):
    """From the restored moments (count 3), one torch Adam step on a
    fixed gradient against `optax.scale_by_adam`. The parameters are
    zeroed and the lr is 1, so each parameter becomes minus its update.

    The moments agree within 1e-6 (relative to each leaf's largest), and
    so do the updates against optax's formula on optax's moments with
    its bias corrections in float64. optax takes 1 - 0.999^4 in float32
    (0.0039939284 for 0.0039940040, 1.9e-5 relative) where torch takes
    it in double, so against optax's own updates the bound is 2e-5."""
    path = str(tmp_path / "state.msgpack")
    j_save_checkpoint(path, jax_state)
    ours = create_train_state(toy_config(), device="cpu", seed=4)
    restore_checkpoint(path, ours)
    rng = np.random.default_rng(9)
    grads = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), _np(jax_state.gen_params))
    eps = 1e-8
    # JAX on the CPU may read numpy inputs in place and asynchronously:
    # give it its own copies and wait for its result before torch runs
    updates, new = jax.block_until_ready(
        optax.scale_by_adam(*BETAS, eps=eps).update(
            jax.tree.map(jnp.array, grads),
            jax.tree.map(jnp.array, jax_state.gen_opt_state)))
    count = int(new.count)
    exact = jax.tree.map(
        lambda m, v: (np.asarray(m, np.float64) / (1 - BETAS[0] ** count))
        / (np.sqrt(np.asarray(v, np.float64) / (1 - BETAS[1] ** count))
           + eps), new.mu, new.nu)

    g_mods = TSNetModules(toy_config(), device="cpu")
    load_flax_params(g_mods, grads)
    g_by_name = dict(g_mods.named_parameters())
    with torch.no_grad():
        for name, p in ours.mods.named_parameters():
            if not name.startswith("netD."):
                p.zero_()
                p.grad = g_by_name[name].detach().clone()
    for group in ours.gen_opt.param_groups:
        group["lr"] = 1.0
    ours.gen_opt.step()

    got = export_flax_params(ours.mods)
    got.pop("netD")
    gen_opt, _ = export_opt_states(ours)
    assert int(gen_opt["count"]) == count == 4

    def rel(got_tree, want_tree, sign=1.0):
        return max(float(np.abs(sign * g - np.asarray(w)).max())
                   / float(np.abs(np.asarray(w)).max())
                   for g, w in zip(jax.tree_util.tree_leaves(got_tree),
                                   jax.tree_util.tree_leaves(want_tree)))

    errs = {"mu": rel(gen_opt["mu"], new.mu), "nu": rel(gen_opt["nu"], new.nu),
            "update": rel(got, exact, -1.0),
            "update_vs_optax_f32": rel(got, updates, -1.0)}
    print("[adam] port vs optax, max |diff| / max |optax| per leaf: "
          + " ".join(f"{k}={v:.3e}" for k, v in errs.items()))
    assert max(errs["mu"], errs["nu"], errs["update"]) <= 1e-6
    assert errs["update_vs_optax_f32"] <= 2e-5


def test_restored_moments_do_not_alias_the_callers_arrays(jax_state):
    """`load_train_state` copies the moments it is given: torch's Adam
    updates them in place, and the caller's arrays (numpy views of JAX
    buffers, say) must stay as they were."""
    opt = {"count": np.asarray(3), "mu": _np(jax_state.gen_opt_state.mu),
           "nu": _np(jax_state.gen_opt_state.nu)}
    before = jax.tree.map(np.copy, opt)
    ours = create_train_state(toy_config(), device="cpu", seed=4)
    load_train_state(ours, _np(jax_state.gen_params),
                     _np(jax_state.disc_params), gen_opt_state=opt)
    for p in ours.mods.parameters():
        p.grad = torch.ones_like(p)
    ours.gen_opt.step()
    _assert_trees_equal(opt, before)


def _batch(cfg, seed=0, bs=2):
    rng = np.random.default_rng(seed)
    s, hw, nl = cfg.n_source, cfg.image_size, cfg.label_nc
    arr = {"src_img": rng.random((bs, s, hw, hw, 3)),
           "src_lbl": rng.integers(0, 2, (bs, s, hw, hw, nl)),
           "src_bbox": rng.integers(0, 2, (bs, s, hw, hw)),
           "tar_img": rng.random((bs, hw, hw, 3)),
           "tar_lbl": rng.integers(0, 2, (bs, hw, hw, nl)),
           "tar_bbox": rng.integers(0, 2, (bs, hw, hw))}
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in arr.items()}


def _snapshot(state):
    """Parameters, the optimizers' state as optax holds it, and the step:
    a parameter without a gradient (FuseNet's conv2 bias) takes no torch
    Adam step, and a restored one holds optax's count and zero moments."""
    tree = export_flax_params(state.mods)
    return {"params": tree, "opt": export_opt_states(state),
            "step": np.asarray(state.step)}


def test_resume_is_exact(tmp_path):
    """2 steps, save, restore into a fresh state, 1 step: bit-equal to 3
    steps straight (parameters, moments, counts, step)."""
    cfg = toy_config()
    batch = _batch(cfg)
    straight = create_train_state(cfg, device="cpu", seed=0)
    step = make_train_step(straight)
    for _ in range(3):
        step(straight, batch, 2e-4)

    first = create_train_state(cfg, device="cpu", seed=0)
    step = make_train_step(first)
    for _ in range(2):
        step(first, batch, 2e-4)
    path = str(tmp_path / "TSNet_S000002.msgpack")
    save_checkpoint(path, first)
    resumed = restore_checkpoint(path, create_train_state(cfg, device="cpu",
                                                          seed=5))
    assert resumed.step == 2
    make_train_step(resumed)(resumed, batch, 2e-4)

    assert resumed.step == straight.step == 3
    _assert_trees_equal(_snapshot(resumed), _snapshot(straight))
    for opt_a, opt_b in ((resumed.gen_opt, straight.gen_opt),
                         (resumed.disc_opt, straight.disc_opt)):
        for ga, gb in zip(opt_a.param_groups, opt_b.param_groups):
            for pa, pb in zip(ga["params"], gb["params"]):
                if pb in opt_b.state:
                    for key, val in opt_b.state[pb].items():
                        assert torch.equal(opt_a.state[pa][key], val)


def test_find_latest_checkpoint(tmp_path):
    assert find_latest_checkpoint(str(tmp_path / "none")) is None
    assert find_latest_checkpoint(str(tmp_path)) is None
    for name in ("TSNet_S000010.msgpack", "TSNet_S000002.msgpack",
                 "other.msgpack", "TSNet_S000020.pth"):
        (tmp_path / name).write_bytes(b"")
    got = find_latest_checkpoint(str(tmp_path))
    assert got == j_find_latest(str(tmp_path))
    assert os.path.basename(got) == "TSNet_S000010.msgpack"
    assert find_latest_checkpoint(str(tmp_path), prefix="other") == \
        j_find_latest(str(tmp_path), prefix="other")


# ------------------------------------------------------- reference .pth

def test_pth_jax_writes_port_reads(tmp_path, gen_params):
    path = str(tmp_path / "TSNet_B0002_S000123.pth")
    j_save_reference_checkpoint(path, gen_params, j_toy_config(),
                                example=123)
    params, example = load_reference_checkpoint(path, toy_config())
    assert example == 123
    _assert_trees_equal(params, gen_params)


def test_pth_port_writes_jax_reads(tmp_path, gen_params):
    mods = TSNetModules(toy_config(), device="cpu", seed=3)
    tree = _port_generator(mods)
    path = str(tmp_path / "port.pth")
    save_reference_checkpoint(path, tree, toy_config(), example=7)
    _assert_trees_equal(_np(j_load_params(path, j_toy_config())), tree)


def test_reference_checkpoint_roundtrip_is_identity(gen_params):
    cfg = toy_config()
    _assert_trees_equal(generator_params_from_checkpoint(
        reference_checkpoint(gen_params, cfg), cfg), gen_params)


def test_pth_carries_the_discriminator(tmp_path):
    state = create_train_state(toy_config(), device="cpu", seed=6)
    tree = export_flax_params(state.mods)
    disc = {"netD": tree.pop("netD")}
    path = str(tmp_path / "with_d.pth")
    save_reference_checkpoint(path, tree, toy_config(), disc_params=disc)
    params, _ = load_reference_checkpoint(path, toy_config(),
                                          include_discriminators=True)
    _assert_trees_equal(params, {**tree, **disc})


# --------------------------------------- load_params (the demo loader)

@pytest.mark.parametrize("kind", ["pth", "generator", "snapshot"])
def test_load_params_reads_the_three_kinds_of_file(tmp_path, kind):
    """The counterparts of tests/test_checkpoint_interop.py: files the
    JAX package writes, read by the port's loader onto CPU modules."""
    jcfg = j_toy_config()
    jmods = JTSNetModules(jcfg)
    if kind == "snapshot":
        state = j_create_train_state(jmods, jax.random.PRNGKey(7))
        want = _np(state.gen_params)
        path = str(tmp_path / "TSNet_S000042.msgpack")
        j_save_checkpoint(path, state)
    else:
        want = _np(jmods.init_generator_params(jax.random.PRNGKey(6)))
        if kind == "pth":
            path = str(tmp_path / "TSNet_B0002_S000123.pth")
            j_save_reference_checkpoint(path, want, jcfg, example=123)
        else:
            path = str(tmp_path / "gen.msgpack")
            j_save_checkpoint(path, want)
    mods = load_params(path, toy_config(), device="cpu")
    assert mods.device == torch.device("cpu")
    _assert_trees_equal(_port_generator(mods), want)


def test_load_params_without_a_file_is_a_seeded_init(capsys):
    a = load_params("", toy_config(), device="cpu", seed=3)
    assert "no checkpoint found" in capsys.readouterr().out
    b = TSNetModules(toy_config(), device="cpu", seed=3)
    _assert_trees_equal(_port_generator(a), _port_generator(b))


def test_load_params_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_params("", toy_config())
