"""The reader of the program's clip copy counter, `staged_share.clip`: None
where the program has no counter or the run nothing to read, the share
from a stubbed counter, and 0 in a traced toy clip run on the CPU, where
every chunk takes the plain path."""

import pytest

from benchmark import harness
from benchmark.tests.conftest import toy_context

TRACED = {"clip_shape": {}, "trace": {"host_events": []}}


@pytest.fixture
def reader():
    return harness.load_module("metrics", "staged_share.clip")


@pytest.mark.parametrize("counts,want", [
    ({"staged": 5, "plain": 0}, 100.0),
    ({"staged": 3, "plain": 1}, 75.0),
    ({"staged": 0, "plain": 4}, 0.0),
])
def test_share_from_a_stubbed_counter(reader, monkeypatch, counts, want):
    monkeypatch.setattr(reader, "counter", lambda: counts)
    assert reader.read(TRACED) == pytest.approx(want)
    assert reader.read({}) is None
    assert reader.read({"clip_shape": {}, "trace": None}) is None  # untraced
    assert reader.read({"train_shape": {}, "trace": {"x": 1}}) is None


def test_none_without_a_counter_or_a_chunk(reader, monkeypatch):
    from wacv23_tsnet_tpu_torch.utils import profiling
    assert reader.counter() == profiling.CLIP_COPIES
    monkeypatch.delattr(profiling, "CLIP_COPIES")      # as the parent has it
    assert reader.counter() == {}
    assert reader.read(TRACED) is None
    monkeypatch.setattr(reader, "counter",
                        lambda: {"staged": 0, "plain": 0})
    assert reader.read(TRACED) is None


def test_a_traced_toy_clip_run_reads_no_staged_chunk_on_the_cpu():
    ctx = toy_context("face.clip", trace=True)
    rec = harness.run_cell(ctx)
    rec["device"] = {"platform": "cpu"}
    out = harness.assemble(ctx, rec, harness.benchmark_spec())
    assert out["metrics"]["staged_share.clip"]["value"] == 0.0
    assert out["metrics"]["staged_share.clip"]["unit"] == "%"
