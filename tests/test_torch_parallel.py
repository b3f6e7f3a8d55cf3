"""The port's multi-device wrappers against the JAX package (CPU, toy
config).

The JAX side runs as tests/test_parallel.py runs it (one process; its
single-device forward and train step are the references those tests hold
the JAX mesh to). The port runs in spawned processes, one per rank, over
a gloo group (`parallel.spawn_ranks`, rank programs in
tests/torch_parallel_ranks.py): 4 ranks for a (4, 1) mesh (data
parallel) and a (2, 2) mesh (data x model: tensor and spatial parallel),
2 for a (2, 1) mesh. Weights are carried from JAX with
`compat.flax_params`. `pytest -s` prints each measured error.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from wacv23_tsnet_tpu.configs import toy_config as j_toy_config
from wacv23_tsnet_tpu.models import TSNetModules as JTSNetModules
from wacv23_tsnet_tpu.models.tsnet import tsnet_forward_clip as j_clip
from wacv23_tsnet_tpu.nn import load_vgg19_params
from wacv23_tsnet_tpu.parallel import make_mesh as j_make_mesh
from wacv23_tsnet_tpu.parallel.spmd import (
    generator_param_shardings as j_shardings)
from wacv23_tsnet_tpu.train.state import create_train_state as j_create_state
from wacv23_tsnet_tpu.train.step import make_train_step as j_make_step
from wacv23_tsnet_tpu_torch.configs import toy_config, toy_pose_config
from wacv23_tsnet_tpu_torch.models import TSNetModules, tsnet_forward_clip
from wacv23_tsnet_tpu_torch.compat import load_flax_params
from wacv23_tsnet_tpu_torch.parallel import (init_distributed, make_mesh,
                                             spawn_ranks)
from wacv23_tsnet_tpu_torch.train import (GEN_SUBNETS, create_train_state,
                                          make_train_step)

torch.set_num_threads(2)
RANK_TIMEOUT = 240.0
LR = 2e-4
GRAD_RTOL = 1e-3
NUDGE = 1e-6


def _report(name, **errors):
    print(f"[parallel] {name}: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in errors.items()))


def _clip_args(cfg, frames=8, seed=5):
    rng = np.random.default_rng(seed)
    s, hw, nl = cfg.n_source, cfg.image_size, cfg.label_nc
    return (rng.random((s, hw, hw, 3), np.float32),
            rng.integers(0, 2, (s, hw, hw, nl)).astype(np.float32),
            rng.integers(0, 2, (s, hw, hw)).astype(np.float32),
            rng.integers(0, 2, (frames, hw, hw, nl)).astype(np.float32),
            rng.integers(0, 2, (frames, hw, hw)).astype(np.float32))


def _batch(cfg, bs=8, seed=0):
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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_refs():
    """One JAX toy generator and train state, the clip inputs and a
    face batch of 8; JAX's single-device clip and train step."""
    jmods = JTSNetModules(j_toy_config())
    params = jmods.init_generator_params(jax.random.PRNGKey(0))
    clip = _clip_args(toy_config())
    want_clip = np.asarray(jax.jit(lambda p, *a: j_clip(
        jmods, p, *a, use_pallas=False))(params, *map(jnp.asarray, clip)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        vgg = load_vgg19_params()
    state = j_create_state(jmods, jax.random.PRNGKey(0), vgg_params=vgg)
    batch = _batch(toy_config())
    _, metrics, rec = j_make_step(jmods, use_pallas=False, donate=False)(
        state, batch, jnp.float32(LR))
    trees = (_np(state.gen_params), _np(state.disc_params),
             _np(state.vgg_params))
    return {"params": params, "gen_tree": _np(params), "clip": clip,
            "want_clip": want_clip, "trees": trees, "batch": batch,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "rec": np.asarray(rec)}


def _spawn(fn, world, tmp_path, *args):
    store = str(tmp_path / f"store_{fn.__name__}")
    return spawn_ranks(fn, world, (store,) + args, timeout=RANK_TIMEOUT)


@pytest.fixture(scope="module")
def dp_run(jax_refs, tmp_path_factory):
    """The (4, 1) mesh's results, one dict per rank."""
    return _spawn(ranks.dp_ranks, 4, tmp_path_factory.mktemp("dp"),
                  jax_refs["gen_tree"], jax_refs["trees"], jax_refs["clip"],
                  jax_refs["batch"])


@pytest.fixture(scope="module")
def tp_run(jax_refs, tmp_path_factory):
    """The (2, 2) mesh's results, one dict per rank."""
    batches = {"face": _batch(toy_config(), seed=1),
               "pose": _batch(toy_pose_config(), seed=13)}
    return batches, _spawn(ranks.tp_ranks, 4, tmp_path_factory.mktemp("tp"),
                           jax_refs["gen_tree"], jax_refs["clip"], batches)


def _same_on_every_rank(results, key):
    first = results[0][key]
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], first)
    return first


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_dp_clip_inference_matches_single_device(jax_refs, dp_run,
                                                 use_kernels):
    """Frames split over 4 data ranks, gathered in order. Against the
    port's single-process clip: tests/test_parallel.py's bar, 5e-5.
    Against JAX's single-device clip: the bar the port's single-process
    clip is held to (tests/test_torch_slice.py, 1e-3; on these inputs the
    single-process port is itself 2.2e-4 from JAX, the temp-100
    attention amplifying rounding)."""
    got = _same_on_every_rank(dp_run, f"clip_kernels_{use_kernels}")
    mods = TSNetModules(toy_config(), device="cpu")
    load_flax_params(mods, jax_refs["gen_tree"])
    single = tsnet_forward_clip(mods, *jax_refs["clip"], device="cpu",
                                use_kernels=use_kernels).numpy()
    err = float(np.abs(got - single).max())
    err_jax = float(np.abs(got - jax_refs["want_clip"]).max())
    single_jax = float(np.abs(single - jax_refs["want_clip"]).max())
    _report(f"dp clip kernels={use_kernels}", max_abs_vs_single=err,
            max_abs_vs_jax=err_jax, single_vs_jax=single_jax)
    assert got.shape == jax_refs["want_clip"].shape
    assert err <= 5e-5
    assert err_jax <= 1e-3


def test_dp_train_step_matches_single_device(jax_refs, dp_run):
    """One DP step over (4, 1) against JAX's single-device step: metrics
    and rec within 5e-3 (tests/test_parallel.py:101-105); every rank
    returns the same global metrics, rec and state."""
    rec = _same_on_every_rank(dp_run, "rec")
    errs = {k: abs(dp_run[0]["metrics"][k] - v)
            for k, v in jax_refs["metrics"].items()}
    rec_err = float(np.abs(rec - jax_refs["rec"]).max())
    _report("dp step", metrics=max(errs.values()), rec=rec_err)
    assert set(dp_run[0]["metrics"]) == set(jax_refs["metrics"])
    assert max(errs.values()) < 5e-3, errs
    assert rec_err < 5e-3
    for r in dp_run[1:]:
        assert r["metrics"] == dp_run[0]["metrics"]
        for n, g in r["grads"].items():
            np.testing.assert_array_equal(g, dp_run[0]["grads"][n])
    # one all-reduce per Adam update, one for the metrics, one gather
    calls = dp_run[0]["calls"]
    assert calls["all_reduce/data/gloo/cpu"] == 3, calls
    assert calls["all_gather/data/gloo/cpu"] == 3, calls


def test_tp_sp_clip_inference_matches_single_device(jax_refs, tp_run):
    """TP blocks and SP similarity on (2, 2) against JAX's single-device
    clip: <=5e-3 max, <=2e-4 mean (tests/test_parallel.py:66-68)."""
    _, res = tp_run
    got = _same_on_every_rank(res, "clip_tp_sp")
    diff = np.abs(got - jax_refs["want_clip"])
    _report("tp+sp clip", max_abs=float(diff.max()),
            mean_abs=float(diff.mean()))
    assert diff.max() < 5e-3 and diff.mean() < 2e-4


def test_param_sharding_rule_matches_jax(jax_refs, tp_run):
    """For every leaf of JAX `generator_param_shardings` on an (4, 2)
    mesh, the port splits the matching tensor on the matching dim, and
    each rank holds its share."""
    _, res = tp_run
    mesh = j_make_mesh(8, model_parallel=2)
    specs = j_shardings(jax_refs["params"], mesh)
    flat = jax.tree_util.tree_flatten_with_path(specs)[0]
    # HWIO kernel axis -> OIHW dim; a bias keeps its one axis
    to_dim = {3: 0, 2: 1}
    want = {}
    for path, sh in flat:
        names = [str(e.key) for e in path]
        leaf = names[-1]
        axes = [i for i, a in enumerate(sh.spec) if a == "model"]
        key = ".".join(names[:-1] + ["weight" if leaf == "kernel"
                                     else "bias"])
        want[key] = (None if not axes else
                     (to_dim[axes[0]] if leaf == "kernel" else 0))
    assert want == res[0]["rule"]
    assert sum(d is not None for d in want.values()) > 0
    for r in res:
        assert all(r["shares"].values()), r["shares"]


def test_fused_tail_under_tp_matches_single_process(jax_refs, tp_run,
                                                    monkeypatch):
    """`bench+fused` (K6 through TSNET_FUSE_PAIR_KERNEL=1, K7 through
    `fused_blocks`, their plain versions on the CPU) on (2, 2), whose
    blocks gather their weights first, against the single-process fused
    clip: within the fast tiers' 0.01 mean L1; the gathered weights are
    the full ones again."""
    _, res = tp_run
    got = _same_on_every_rank(res, "clip_fused_tp")
    cfg = dataclasses.replace(toy_config(), precision="high",
                              fast_tail=True, fast_trunk=True)
    mods = TSNetModules(cfg, device="cpu")
    load_flax_params(mods, jax_refs["gen_tree"])
    monkeypatch.setenv("TSNET_FUSE_PAIR_KERNEL", "1")
    want = tsnet_forward_clip(mods, *jax_refs["clip"], device="cpu",
                              fused_blocks=True).numpy()
    diff = np.abs(got - want)
    _report("bench+fused tp clip", max_abs=float(diff.max()),
            mean_abs=float(diff.mean()))
    assert diff.mean() <= 0.01
    assert all(r["fused_gathered_equal"] for r in res)


def _single_step(cfg, batch, nudge=0.0, use_kernels=False):
    """The port's single-process step from the seeded state; metrics,
    rec and the gradients by parameter name."""
    state = create_train_state(cfg, device="cpu", seed=0)
    if nudge:
        batch = dict(batch, src_img=batch["src_img"] + np.float32(nudge))
    _, metrics, rec = make_train_step(state, use_kernels=use_kernels)(
        state, batch, LR)
    return ({k: float(v) for k, v in metrics.items()}, rec.numpy(),
            ranks.grads(state.mods))


def _subnet_rel(got: dict, want: dict, prefix: str) -> float:
    names = [n for n in want if n.split(".")[0] == prefix]
    g = np.concatenate([got[n].ravel() for n in names])
    w = np.concatenate([want[n].ravel() for n in names])
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


@pytest.mark.parametrize("task", ["face", "pose"])
def test_dp_tp_sp_train_step_matches_single_process(tp_run, task):
    """One DP+TP+SP step on (2, 2) (the JAX `dryrun_multichip` mesh
    shape): step 1 and finite metrics on every rank; the gathered
    generator, netD and (pose) netDF gradients within 1e-3 relative L2
    of the single-process step, or within twice that step's own spread
    under a 1e-6 input nudge (the repo's gradient bar)."""
    batches, res = tp_run
    cfg = toy_config() if task == "face" else toy_pose_config()
    metrics, rec, want = _single_step(cfg, batches[task])
    _, _, nudged = _single_step(cfg, batches[task], NUDGE)
    got = res[0][task]
    assert all(r[task]["step"] == 1 for r in res)
    assert all(np.isfinite(v) for r in res
               for v in r[task]["metrics"].values())
    assert set(got["metrics"]) == set(metrics)
    subnets = GEN_SUBNETS + (("netD", "netDF") if cfg.use_face_d
                             else ("netD",))
    errs = {}
    for sub in subnets:
        err = _subnet_rel(got["grads"], want, sub)
        spread = _subnet_rel(nudged, want, sub)
        errs[sub] = (err, spread)
        assert err <= max(GRAD_RTOL, 2.0 * spread), (sub, err, spread)
    m_err = max(abs(got["metrics"][k] - v) for k, v in metrics.items())
    rec_err = float(np.abs(got["rec"] - rec).max())
    _report(f"dp+tp+sp step {task}", metrics=m_err, rec=rec_err,
            **{f"{k}_rel": v[0] for k, v in errs.items()},
            **{f"{k}_spread": v[1] for k, v in errs.items()})
    assert m_err < 5e-3 and rec_err < 5e-2
    for r in res[1:]:
        np.testing.assert_array_equal(r[task]["rec"], got["rec"])


def test_dp_kernel_path_step_and_refusals(tmp_path):
    """(2, 1): the kernel-path step (K3-flow/K4/K2 plain versions on the
    CPU) through the data-parallel wrapper against the single-process
    kernel-path step; `shard_batch` and `make_mesh` refuse what the JAX
    package's assertions refuse; `make_mesh` needs a process group and
    `init_distributed` a GPU unless asked for the CPU."""
    batch = _batch(toy_config(), bs=4, seed=2)
    res = _spawn(ranks.dp_kernel_ranks, 2, tmp_path, batch)
    metrics, rec, want = _single_step(toy_config(), batch, use_kernels=True)
    _, _, nudged = _single_step(toy_config(), batch, NUDGE, use_kernels=True)
    got = res[0]
    m_err = max(abs(got["metrics"][k] - v) for k, v in metrics.items())
    rec_err = float(np.abs(got["rec"] - rec).max())
    _report("dp kernel-path step", metrics=m_err, rec=rec_err)
    assert m_err < 5e-3 and rec_err < 5e-3
    for sub in GEN_SUBNETS + ("netD",):
        err = _subnet_rel(got["grads"], want, sub)
        spread = _subnet_rel(nudged, want, sub)
        _report(f"dp kernel-path step {sub}", rel=err, spread=spread)
        assert err <= max(GRAD_RTOL, 2.0 * spread), (sub, err, spread)
    assert got["uneven"] == "3 does not split evenly over the data axis " \
                            "of size 2"
    assert got["refused_4_1"] == "need 4 devices, have 2"
    assert "model_parallel=3" in got["refused_2_3"]
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh()
    if not torch.cuda.is_available():
        # the GPU by default: refused without CUDA, before any rendezvous
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_distributed(0, 1, f"file://{tmp_path / 'never'}")
