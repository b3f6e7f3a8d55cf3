"""The port's spans and set-up counters (`utils.profiling`) on the CPU:
off without a profiler, and under one the clip's and the train step's
stages, each once a job, chunk or step, nested under the unit's span and
placed among the profiler's host events; the clip's source pack, encoded
once a job and counted by `CLIP_PACKS`."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wacv23_tsnet_tpu_torch.configs import toy_config, toy_pose_config
from wacv23_tsnet_tpu_torch.infer import pipeline
from wacv23_tsnet_tpu_torch.infer.pipeline import ClipInference
from wacv23_tsnet_tpu_torch.models.tsnet import (TSNetModules, encode_sources,
                                                 tsnet_forward_clip)
from wacv23_tsnet_tpu_torch.train import create_train_state, make_train_step
from wacv23_tsnet_tpu_torch.utils import profiling
from wacv23_tsnet_tpu_torch.utils.profiling import (CLIP_COPIES, CLIP_PACKS,
                                                    SETUP_S, reset_spans,
                                                    setup_time, span,
                                                    span_records, spans)

torch.set_num_threads(2)

CLIP_STAGES = ("tsnet.encode_sources", "tsnet.lbl_enc", "tsnet.warp",
               "tsnet.fuse", "tsnet.decode")
TRAIN_STAGES = ("tsnet.train.g_forward", "tsnet.train.d_phase",
                "tsnet.train.d_opt", "tsnet.train.g_loss_forward",
                "tsnet.train.g_backward", "tsnet.train.g_opt")


def clip_job(cfg, frames, seed=0):
    """`ClipInference.run`'s host arrays for one toy job."""
    rng = np.random.default_rng(seed)
    s, hw, nl = cfg.n_source, cfg.image_size, cfg.label_nc
    return (rng.random((s, 3, hw, hw), np.float32) * 255.0,
            rng.integers(0, nl, (s, hw, hw)).astype(np.uint8),
            np.ones((s, hw, hw), np.float32),
            rng.integers(0, nl, (frames, hw, hw)).astype(np.uint8),
            np.ones((frames, hw, hw), np.float32))


def train_batch(cfg, bs=2, seed=0):
    rng = np.random.default_rng(seed)
    s, hw, nl = cfg.n_source, cfg.image_size, cfg.label_nc
    onehot = np.eye(nl, dtype=np.float32)
    return {"src_img": rng.random((bs, s, hw, hw, 3), np.float32),
            "src_lbl": onehot[rng.integers(0, nl, (bs, s, hw, hw))],
            "src_bbox": np.ones((bs, s, hw, hw), np.float32),
            "tar_img": rng.random((bs, hw, hw, 3), np.float32),
            "tar_lbl": onehot[rng.integers(0, nl, (bs, hw, hw))],
            "tar_bbox": np.ones((bs, hw, hw), np.float32)}


@pytest.fixture(scope="module")
def engine():
    cfg = toy_config()
    return ClipInference(cfg, TSNetModules(cfg, device="cpu"), chunk=3,
                         device="cpu")


@pytest.fixture(scope="module")
def trainer():
    state = create_train_state(toy_config(), device="cpu", seed=0)
    return state, make_train_step(state)


def profiled(fn):
    """Run `fn` under `torch.profiler` on a clean span registry; the host
    events as (name, start_us, end_us)."""
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name(), e.start_ns() / 1e3,
             (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()]


def test_span_off_opens_no_region_and_no_event(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("touched with no profiler running")
    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    reset_spans()
    assert span("a", "cuda") is span("b")       # one shared no-op
    with span("tsnet.off", "cuda"), span("tsnet.off.inner"):
        pass
    assert spans() == {} and span_records() == []


def test_no_profiler_no_spans(engine, trainer):
    reset_spans()
    engine.run(*clip_job(engine.cfg, 4))
    state, step = trainer
    step(state, train_batch(state.mods.cfg), 2e-4)
    assert spans() == {} and span_records() == []


def test_clip_spans_under_a_profiler(engine):
    host = profiled(lambda: engine.run(*clip_job(engine.cfg, 5)))  # 2 chunks
    got = spans()
    assert got["tsnet.clip.run"]["count"] == 1
    assert got["tsnet.clip.upload"]["count"] == 1
    assert got["tsnet.clip.copy_back"]["count"] == 1
    assert got["tsnet.encode_sources"]["count"] == 1    # once a job
    for name in CLIP_STAGES[1:]:                       # once a chunk
        assert got[name]["count"] == 2, name
    recs = span_records()
    assert {r["unit"] for r in recs} == {recs[0]["unit"]}
    for r in recs:
        assert r["parent"] == (None if r["name"] == "tsnet.clip.run"
                               else "tsnet.clip.run"), r
        assert r["ms"] >= 0.0
    run = [(s, e) for n, s, e in host if n == "tsnet.clip.run"]
    assert len(run) == 1
    lo, hi = run[0]
    for name in got:
        inside = [(s, e) for n, s, e in host
                  if n == name and lo <= s and e <= hi]
        assert len(inside) == got[name]["count"], name
    covered = sum(got[n]["ms"] for n in got if n != "tsnet.clip.run")
    assert covered <= got["tsnet.clip.run"]["ms"] * (1 + 1e-9)
    assert got["tsnet.clip.run"]["self_ms"] == pytest.approx(
        got["tsnet.clip.run"]["ms"] - covered, abs=1e-6)


@pytest.mark.parametrize("method", ["run", "run_renormalized"])
def test_one_copy_back_span_a_job(engine, method):
    run = getattr(engine, method)
    profiled(lambda: [run(*clip_job(engine.cfg, f)) for f in (7, 2)])
    got = spans()
    assert got["tsnet.clip.run"]["count"] == 2
    assert got["tsnet.clip.copy_back"]["count"] == 2


@pytest.mark.parametrize("frames", [6, 5, 2],
                         ids=["multiple", "ragged", "below"])
@pytest.mark.parametrize("method", ["run", "run_renormalized"])
def test_clip_copies_back_plain_chunks_on_the_cpu(engine, method, frames):
    """On the CPU every chunk takes the plain path, counted once a chunk,
    and a job returns an (F, 3, H, W) f32 array of its own: a second job
    leaves the first one's frames as they were."""
    before = dict(CLIP_COPIES)
    run = getattr(engine, method)
    first = run(*clip_job(engine.cfg, frames, seed=1))
    kept = first.copy()
    second = run(*clip_job(engine.cfg, frames, seed=2))
    chunks = -(-frames // engine.chunk)
    assert CLIP_COPIES == {"staged": before["staged"],
                           "plain": before["plain"] + 2 * chunks}
    hw = engine.cfg.image_size
    assert first.shape == second.shape == (frames, 3, hw, hw)
    assert first.dtype == second.dtype == np.float32
    assert not np.shares_memory(first, second)
    np.testing.assert_array_equal(first, kept)
    assert not np.array_equal(first, second)


def per_chunk_frames(engine, job, renormalize=False):
    """A job's frames with the sources encoded again for every chunk:
    `tsnet_forward_clip` over the engine's chunks, the last wrapped round
    the clip, then each frame renormalized to the first reference as
    `run_renormalized` does where `renormalize`."""
    src = engine.prepare_sources(*job[:3])
    tar_lbl = engine._onehot(job[3])
    tar_bbox = torch.as_tensor(job[4])
    f, outs = tar_lbl.shape[0], []
    with torch.inference_mode():
        for lo in range(0, f, engine.chunk):
            idx = torch.arange(lo, lo + engine.chunk) % f
            rec = tsnet_forward_clip(engine.mods, *src, tar_lbl[idx],
                                     tar_bbox[idx],
                                     use_kernels=engine.use_kernels,
                                     device=engine.device)
            if renormalize:
                ref = src[0][0]
                rec = ((rec - rec.mean(dim=(1, 2), keepdim=True))
                       / rec.std(dim=(1, 2), keepdim=True)
                       * ref.std(dim=(0, 1)) + ref.mean(dim=(0, 1)))
            outs.append(rec[:min(engine.chunk, f - lo)])
    return torch.cat(outs).permute(0, 3, 1, 2).numpy()


@pytest.mark.parametrize("method", ["run", "run_renormalized"])
def test_clip_encodes_the_sources_once_a_job(engine, monkeypatch, method):
    """7 frames at chunk 3 (3 chunks, the last wrapped): the sources are
    encoded once a job, the pack counted as encoded for the first chunk
    and reused by the other two, and the frames are the bits of
    `tsnet_forward_clip` run chunk by chunk."""
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return encode_sources(*a, **k)
    monkeypatch.setattr(pipeline, "encode_sources", counted)
    run = getattr(engine, method)
    for seed in (1, 2):
        job = clip_job(engine.cfg, 7, seed=seed)
        before, n = dict(CLIP_PACKS), len(calls)
        got = run(*job)
        assert len(calls) == n + 1
        assert CLIP_PACKS == {"encoded": before["encoded"] + 1,
                              "reused": before["reused"] + 2}
        np.testing.assert_array_equal(
            got, per_chunk_frames(engine, job, method == "run_renormalized"))


@pytest.mark.parametrize("cfg", [toy_config, toy_pose_config])
def test_train_spans_under_a_profiler(cfg, trainer):
    if cfg is toy_config:
        state, step = trainer
    else:
        state = create_train_state(cfg(), device="cpu", seed=0)
        step = make_train_step(state)
    batch = train_batch(state.mods.cfg)
    step(state, batch, 2e-4)            # warm, unprofiled
    host = profiled(lambda: [step(state, batch, 2e-4) for _ in range(2)])
    got = spans()
    assert got["tsnet.train.step"]["count"] == 2
    assert set(got) == {"tsnet.train.step", *TRAIN_STAGES}
    for name in TRAIN_STAGES:
        assert got[name]["count"] == 2, name
    recs = span_records()
    units = [r["unit"] for r in recs if r["name"] == "tsnet.train.step"]
    assert len(set(units)) == 2
    for r in recs:
        if r["name"] != "tsnet.train.step":
            assert r["parent"] == "tsnet.train.step", r
            assert r["unit"] in units
    assert sum(r["unit"] == units[0] for r in recs) == 7
    step_s = got["tsnet.train.step"]
    assert 0.0 <= step_s["self_ms"] < 0.05 * step_s["ms"], step_s
    steps = [(s, e) for n, s, e in host if n == "tsnet.train.step"]
    assert len(steps) == 2
    for name in TRAIN_STAGES:
        inside = [n for n, s, e in host if n == name
                  and any(lo <= s and e <= hi for lo, hi in steps)]
        assert len(inside) == 2, name


def test_span_units_and_self_time():
    """A span's self ms is its ms less its children's; every span of one
    outermost span shares its unit, and the next outermost opens another."""
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with span("outer", "cpu"):
                with span("inner", "cpu"):
                    time.sleep(0.02)
                with span("inner", "cpu"):
                    with span("leaf", "cpu"):
                        time.sleep(0.01)
                time.sleep(0.01)
    got = spans()
    assert {k: v["count"] for k, v in got.items()} == {
        "outer": 2, "inner": 4, "leaf": 2}
    for v in got.values():
        assert 0.0 <= v["self_ms"] <= v["ms"]
    assert got["inner"]["self_ms"] == pytest.approx(
        got["inner"]["ms"] - got["leaf"]["ms"], abs=1e-6)
    assert got["outer"]["self_ms"] == pytest.approx(
        got["outer"]["ms"] - got["inner"]["ms"], abs=1e-6)
    assert got["outer"]["self_ms"] >= 15.0        # the two 10-ms sleeps
    recs = span_records()
    assert [r["parent"] for r in recs[:4]] == [None, "outer", "outer",
                                               "inner"]
    assert len({r["unit"] for r in recs[:4]}) == 1
    assert recs[4]["unit"] != recs[0]["unit"]
    reset_spans()
    assert spans() == {}


def test_setup_counters():
    before = SETUP_S.get("modules", 0.0)
    TSNetModules(toy_config(), device="cpu")
    assert SETUP_S["modules"] > before
    before = SETUP_S["modules"]
    t0 = time.perf_counter()
    create_train_state(toy_config(), device="cpu", seed=0)
    assert 0.0 < SETUP_S["modules"] - before <= time.perf_counter() - t0
    t0 = time.perf_counter()
    with setup_time("tsnet.test"):
        time.sleep(0.02)
    assert 0.02 <= SETUP_S.pop("tsnet.test") <= time.perf_counter() - t0
