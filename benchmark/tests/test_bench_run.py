"""A run end to end on the CPU at the toy sizes (the look for a chip
skipped): the reference against the port's plain path, `correct` with
the timed path broken underneath, the import guard and the refusals."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import common, harness, weights
from benchmark.reference import model as ref
from benchmark.tests.conftest import ROOT, toy_context


def run_toy(cell, **kw):
    ctx = toy_context(cell, **kw)
    rec = harness.run_cell(ctx)
    rec["device"] = {"platform": "cpu"}
    return harness.assemble(ctx, rec, harness.benchmark_spec()), rec


@pytest.mark.parametrize("task", ["face", "pose"])
def test_reference_clip_equals_the_ports_plain_path(task):
    from wacv23_tsnet_tpu_torch.models.tsnet import (TSNetModules,
                                                      tsnet_forward_clip)
    cell = "face.clip" if task == "face" else "pose.train"
    ctx = toy_context(cell)
    cfg = common.port_config(ctx.config, {"precision": "highest"})
    w = weights.make(ctx.config, 3, "cpu", train=False)
    mods = TSNetModules(cfg, device="cpu")
    mods.load_state_dict(w)
    from benchmark.tests.test_bench_arith import clip_inputs
    args = clip_inputs(ctx.config, cfg.n_source, 4, seed=5)
    with torch.no_grad():
        got = tsnet_forward_clip(mods, *args, use_kernels=False,
                                 device="cpu").permute(0, 3, 1, 2)
    want = ref.generator_clip(w, ctx.config, *args, ref.Precision(), block=3)
    assert float((got - want).abs().max()) < 1e-4


@pytest.mark.parametrize("cell", ["face.clip", "face.clip-high"])
def test_reference_tier_is_near_the_ports_tier(cell):
    out, rec = run_toy(cell)
    assert rec["readings"]["frame_mad_mean"] < 0.02
    assert out["correct"]


@pytest.mark.parametrize("cell", ["face.train", "pose.train"])
def test_reference_step_equals_the_ports_plain_step(cell):
    """One step of the port's train step (plain versions on the CPU)
    against the reference's: the step's losses, every leaf's gradient
    norm. At temp 100 the encoders' gradients pass through a near-argmax
    softmax, so their norms sit a few percent apart; the median leaf
    agrees to rounding."""
    drv = harness.load_module("drivers", "train")
    ctx = toy_context(cell)
    w = weights.make(ctx.config, ctx.seed, "cpu", train=True)
    st, step, _ = drv.build_program(ctx, w)
    batches = drv.make_batches(ctx)
    _, m, _ = step(st, batches[0], 2e-4)
    p = {k: v.clone() for k, v in w.items()}
    mr, g = ref.train_step(p, {}, ctx.config, batches[0], 2e-4)
    for k in ("D", "G_FML", "G_VGG", "grad_G", "warp"):
        assert float(m[k]) == pytest.approx(mr[k], rel=1e-4), k
    grads = {k: q.grad for k, q in st.mods.named_parameters()}
    gaps = common.norm_gaps(grads, g)
    assert float(np.median(list(gaps.values()))) < 1e-4
    assert max(gaps.values()) < 0.1


def test_a_sound_toy_run_reports_its_metrics():
    """The limits are set at the cells' sizes on the chip; at the toy
    size the steady numbers still read far under them."""
    out, rec = run_toy("face.train")
    assert out["failed"] == 0
    assert rec["readings"]["loss_gap.step1"] < 1e-5
    assert rec["readings"]["grad_norm_gap"] < 0.025
    assert rec["readings"]["loss_gap.window"] < 1e-5
    assert rec["readings"]["change_norm_gap.window"] < 0.01
    assert set(out["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert list(out)[-1] == "checks"
    traced, _ = run_toy("face.train", trace=True)
    assert "mfu.train" in traced["metrics"] and "breakdown" in traced


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    from wacv23_tsnet_tpu_torch.train import step as step_mod
    real = step_mod.make_train_step

    def frozen(state, **kw):
        inner = real(state, **kw)

        def step(st, batch, lr):
            saved = {k: v.detach().clone()
                     for k, v in st.mods.state_dict().items()}
            out = inner(st, batch, lr)
            st.mods.load_state_dict(saved)
            for opt in (st.gen_opt, st.disc_opt):
                for s in opt.state.values():
                    for k in ("exp_avg", "exp_avg_sq"):
                        s[k].zero_()
            return out
        return step
    monkeypatch.setattr(step_mod, "make_train_step", frozen)
    out, rec = run_toy("face.train")
    assert not out["correct"]
    assert rec["readings"]["change_norm_gap"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    from wacv23_tsnet_tpu_torch.train import step as step_mod
    real = step_mod.make_train_step

    def halved(state, **kw):
        inner = real(state, **kw)

        def step(st, batch, lr):
            half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            return inner(st, half, lr)
        return step
    monkeypatch.setattr(step_mod, "make_train_step", halved)
    out, _ = run_toy("pose.train")
    assert not out["correct"]


def test_an_altered_frame_is_not_correct(monkeypatch):
    from wacv23_tsnet_tpu_torch.infer import pipeline
    real = pipeline.ClipInference.run

    def altered(self, *args):
        out = real(self, *args)
        out[1] += 0.25
        return out
    monkeypatch.setattr(pipeline.ClipInference, "run", altered)
    out, rec = run_toy("face.clip")
    assert not out["correct"]
    assert rec["readings"]["frame_mad_worst"] > 0.2


def test_a_step_that_changes_once_warm_is_not_correct(monkeypatch):
    """Sound for the three set-up steps, half of each batch left out from
    the window's first step on: only the check of the window's own step
    can see it."""
    from wacv23_tsnet_tpu_torch.train import step as step_mod
    real = step_mod.make_train_step

    def later(state, **kw):
        inner = real(state, **kw)
        calls = []

        def step(st, batch, lr):
            calls.append(1)
            if len(calls) > 3:
                batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            return inner(st, batch, lr)
        return step
    monkeypatch.setattr(step_mod, "make_train_step", later)
    out, rec = run_toy("face.train")
    assert not out["correct"]
    assert rec["readings"]["loss_gap.step1"] < 1e-5
    window = {k: c for k, c in out["checks"].items() if k.endswith(".window")}
    assert window and all(c["value"] > c["limit"] for c in window.values())


@pytest.mark.parametrize("cell", ["face.clip", "face.clip-high"])
def test_the_clip_controls_read_further_off_than_the_program(cell):
    """The clip controls at the toy size: the bench tier's reference with
    fp8 convolutions and bf16 logits; the "high" tier's with bf16 logits
    alone, which its fp32-accurate encoders leave visible."""
    ctx = toy_context(cell)
    prog = harness.run_cell(ctx)["readings"]
    ctl = harness.load_module("drivers", "clip").control_readings(ctx)
    assert ctl["frame_mad_mean"] > 3 * prog["frame_mad_mean"]
    assert ctx.cell["control"]["sim"] == "bfloat16"


def test_the_train_control_reads_further_off_than_the_program():
    """The train step on half of each batch (TF32 has no effect on the
    CPU; the chip reads it at the cells' sizes)."""
    ctx = toy_context("face.train")
    half = harness.load_module("drivers", "train").control_readings(
        ctx, half_batch=True)
    assert half["grad_norm_gap"] > ctx.cell["limits"]["grad_norm_gap"] or \
        half["loss_gap.step1"] > ctx.cell["limits"]["loss_gap.step1"]


def test_the_guard_finds_jax_by_whole_top_level_names(monkeypatch):
    assert "wacv23_tsnet_tpu" not in harness.forbidden_modules()
    import wacv23_tsnet_tpu_torch  # noqa: F401  the port's name is longer
    assert "wacv23_tsnet_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]


def _imports(code: str) -> list:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in "
                          "sys.modules})))"], capture_output=True, text=True,
                         env=env, cwd=ROOT, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_benchmark_module_brings_in_jax():
    mods = _imports("import benchmark.harness, benchmark.common, "
                    "benchmark.trace, benchmark.flops, benchmark.calibrate\n"
                    "from benchmark import harness\n"
                    "for d in ('clip', 'train'):\n"
                    "    harness.load_module('drivers', d)\n"
                    "import wacv23_tsnet_tpu_torch.train.step, "
                    "wacv23_tsnet_tpu_torch.infer.pipeline")
    assert not set(mods) & set(harness.FORBIDDEN), mods


def test_the_reference_brings_in_nothing_of_the_program():
    mods = _imports("import benchmark.reference.model")
    assert "wacv23_tsnet_tpu_torch" not in mods
    assert not set(mods) & set(harness.FORBIDDEN)


def test_a_reference_that_imports_the_program_fails_the_guard(tmp_path):
    bad = tmp_path / "bad_reference.py"
    bad.write_text("import wacv23_tsnet_tpu_torch.models.tsnet\n")
    mods = _imports(f"import importlib.util as u\n"
                    f"s = u.spec_from_file_location('bad', r'{bad}')\n"
                    f"s.loader.exec_module(u.module_from_spec(s))")
    assert "wacv23_tsnet_tpu_torch" in mods


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "face.clip", "--seed", str(2 ** 31 + 5),
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, env=env)
    assert out.returncode == 2
    assert "{" not in out.stdout
