"""The reader of the program's trunk-norm counter,
`trunk_norm_share.clip`: None where the program has no counter or the run
nothing to read, the share from a stubbed counter, and the share of a
traced toy clip run on the CPU, whose encoders' and FuseNet's norms all
keep the ATen composition (the fused kernel runs on CUDA only)."""

import pytest

from benchmark import harness
from benchmark.tests.conftest import toy_context

TRACED = {"clip_shape": {}, "trace": {"host_events": []}}


@pytest.fixture
def reader():
    return harness.load_module("metrics", "trunk_norm_share.clip")


@pytest.mark.parametrize("counts,want", [
    ({"fused": 26, "plain": 0}, 100.0),
    ({"fused": 3, "plain": 1}, 75.0),
    ({"fused": 0, "plain": 26}, 0.0),
])
def test_share_from_a_stubbed_counter(reader, monkeypatch, counts, want):
    monkeypatch.setattr(reader, "counter", lambda: counts)
    assert reader.read(TRACED) == pytest.approx(want)
    assert reader.read({}) is None
    assert reader.read({"clip_shape": {}, "trace": None}) is None  # untraced
    assert reader.read({"train_shape": {}, "trace": {"x": 1}}) is None


def test_none_without_a_counter_or_a_norm(reader, monkeypatch):
    from wacv23_tsnet_tpu_torch.utils import profiling
    assert reader.counter() == profiling.TRUNK_NORMS
    monkeypatch.delattr(profiling, "TRUNK_NORMS")      # as the parent has it
    assert reader.counter() == {}
    assert reader.read(TRACED) is None
    monkeypatch.setattr(reader, "counter", lambda: {"fused": 0, "plain": 0})
    assert reader.read(TRACED) is None


def test_a_traced_toy_clip_run_on_the_cpu_fuses_no_norm(monkeypatch):
    from wacv23_tsnet_tpu_torch.utils import profiling
    monkeypatch.setitem(profiling.TRUNK_NORMS, "fused", 0)
    monkeypatch.setitem(profiling.TRUNK_NORMS, "plain", 0)
    ctx = toy_context("face.clip", trace=True)
    rec = harness.run_cell(ctx)
    rec["device"] = {"platform": "cpu"}
    out = harness.assemble(ctx, rec, harness.benchmark_spec())
    assert profiling.TRUNK_NORMS["plain"] > 0
    assert out["metrics"]["trunk_norm_share.clip"]["value"] == 0.0
    assert out["metrics"]["trunk_norm_share.clip"]["unit"] == "%"
