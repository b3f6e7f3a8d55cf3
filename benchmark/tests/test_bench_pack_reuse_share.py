"""The reader of the program's source pack counter,
`pack_reuse_share.clip`: None where the program has no counter or the run
nothing to read, the share from a stubbed counter, and the share of a
traced toy clip run on the CPU, whose 5-frame jobs run in 2 chunks of 4."""

import pytest

from benchmark import harness
from benchmark.tests.conftest import toy_context

TRACED = {"clip_shape": {}, "trace": {"host_events": []}}


@pytest.fixture
def reader():
    return harness.load_module("metrics", "pack_reuse_share.clip")


@pytest.mark.parametrize("counts,want", [
    ({"encoded": 1, "reused": 4}, 80.0),
    ({"encoded": 3, "reused": 1}, 25.0),
    ({"encoded": 2, "reused": 0}, 0.0),
])
def test_share_from_a_stubbed_counter(reader, monkeypatch, counts, want):
    monkeypatch.setattr(reader, "counter", lambda: counts)
    assert reader.read(TRACED) == pytest.approx(want)
    assert reader.read({}) is None
    assert reader.read({"clip_shape": {}, "trace": None}) is None  # untraced
    assert reader.read({"train_shape": {}, "trace": {"x": 1}}) is None


def test_none_without_a_counter_or_a_chunk(reader, monkeypatch):
    from wacv23_tsnet_tpu_torch.utils import profiling
    assert reader.counter() == profiling.CLIP_PACKS
    monkeypatch.delattr(profiling, "CLIP_PACKS")       # as the parent has it
    assert reader.counter() == {}
    assert reader.read(TRACED) is None
    monkeypatch.setattr(reader, "counter",
                        lambda: {"encoded": 0, "reused": 0})
    assert reader.read(TRACED) is None


def test_a_traced_toy_clip_run_reuses_one_pack_a_job(monkeypatch):
    from wacv23_tsnet_tpu_torch.utils import profiling
    monkeypatch.setitem(profiling.CLIP_PACKS, "encoded", 0)
    monkeypatch.setitem(profiling.CLIP_PACKS, "reused", 0)
    ctx = toy_context("face.clip", trace=True)
    rec = harness.run_cell(ctx)
    rec["device"] = {"platform": "cpu"}
    out = harness.assemble(ctx, rec, harness.benchmark_spec())
    assert out["metrics"]["pack_reuse_share.clip"]["value"] == 50.0
    assert out["metrics"]["pack_reuse_share.clip"]["unit"] == "%"
