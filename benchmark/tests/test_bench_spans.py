"""The readers of the program's spans and set-up counters, on synthetic
records with hand-placed host spans, device events and registry contents,
and on a traced toy run of a clip cell and a train cell on the CPU."""

import math

import pytest

from benchmark import harness, program_spans
from benchmark.tests.conftest import toy_context

CLIP_READERS = {
    "stage_ms.upload.clip": "tsnet.clip.upload",
    "stage_ms.encode_sources.clip": "tsnet.encode_sources",
    "stage_ms.lbl_enc.clip": "tsnet.lbl_enc",
    "stage_ms.warp.clip": "tsnet.warp",
    "stage_ms.fuse.clip": "tsnet.fuse",
    "stage_ms.decode.clip": "tsnet.decode",
    "stage_ms.copy_back.clip": "tsnet.clip.copy_back",
}
TRAIN_READERS = {
    "stage_ms.g_forward.train": ["tsnet.train.g_forward"],
    "stage_ms.d_phase.train": ["tsnet.train.d_phase"],
    "stage_ms.g_loss_forward.train": ["tsnet.train.g_loss_forward"],
    "stage_ms.g_backward.train": ["tsnet.train.g_backward"],
    "stage_ms.adam.train": ["tsnet.train.d_opt", "tsnet.train.g_opt"],
}


def entry(count, ms):
    return {"count": count, "ms": ms, "self_ms": ms}


def clip_record(host=(), device=()):
    return {"clip_shape": {}, "trace": {"host_events": list(host),
                                        "device_events": list(device)}}


def registry_of(names, jobs, unit):
    """Each name i at 10 * (i + 1) ms in all, the unit's span `jobs` times."""
    reg = {n: entry(jobs * 5, 10.0 * (i + 1)) for i, n in enumerate(names)}
    reg[unit] = entry(jobs, 1000.0)
    return reg


@pytest.mark.parametrize("metric", sorted(CLIP_READERS))
def test_clip_stage_readers(metric, monkeypatch):
    names = list(CLIP_READERS.values())
    reg = registry_of(names, 4, "tsnet.clip.run")
    monkeypatch.setattr(program_spans, "registry", lambda: reg)
    mod = harness.load_module("metrics", metric)
    i = names.index(CLIP_READERS[metric])
    assert mod.read(clip_record()) == pytest.approx(10.0 * (i + 1) / 4)
    assert mod.read({}) is None
    assert mod.read({"clip_shape": {}, "trace": None}) is None   # untraced
    assert mod.read({"train_shape": {}, "trace": {"x": 1}}) is None
    monkeypatch.setattr(program_spans, "registry", lambda: {})
    assert mod.read(clip_record()) is None
    reg.pop("tsnet.clip.run")
    monkeypatch.setattr(program_spans, "registry", lambda: reg)
    assert mod.read(clip_record()) is None


@pytest.mark.parametrize("metric", sorted(TRAIN_READERS))
def test_train_stage_readers(metric, monkeypatch):
    names = [n for ns in TRAIN_READERS.values() for n in ns]
    reg = registry_of(names, 3, "tsnet.train.step")
    monkeypatch.setattr(program_spans, "registry", lambda: reg)
    mod = harness.load_module("metrics", metric)
    want = sum(10.0 * (names.index(n) + 1)
               for n in TRAIN_READERS[metric]) / 3
    rec = {"train_shape": {}, "trace": {"host_events": []}}
    assert mod.read(rec) == pytest.approx(want)
    assert mod.read({}) is None
    assert mod.read(clip_record()) is None
    monkeypatch.setattr(program_spans, "registry", lambda: {})
    assert mod.read(rec) is None


def test_idle_in_transfers_counts_only_gaps_inside_transfer_spans():
    """Two jobs. Device ops at [0, 10], [30, 40], [45, 100], [120, 130]
    us. Job 1 uploads over [5, 50]: idle [10, 30] and [40, 45], 25 us;
    its copy back over [90, 125] holds the gap [100, 120], 20 us. Job 2's
    upload [200, 210] holds no device op, 10 us. The gaps outside every
    transfer span ([130, 200] and the compute spans') do not count."""
    host = [("tsnet.clip.run", 0.0, 150.0), ("tsnet.clip.upload", 5.0, 50.0),
            ("aten::copy_", 6.0, 9.0), ("tsnet.decode", 50.0, 89.0),
            ("tsnet.clip.copy_back", 90.0, 125.0),
            ("tsnet.clip.run", 195.0, 400.0),
            ("tsnet.clip.upload", 200.0, 210.0),
            ("tsnet.warp", 210.0, 390.0)]
    device = [("k", 0.0, 10.0), ("k", 30.0, 10.0), ("k", 45.0, 55.0),
              ("Memcpy DtoH", 120.0, 10.0)]
    mod = harness.load_module("metrics", "idle_ms.transfers.clip")
    assert mod.read(clip_record(host, device)) == pytest.approx(
        (25.0 + 20.0 + 10.0) / 2 * 1e-3)
    # a device op overlapping two transfer spans is not counted twice
    both = [("tsnet.clip.run", 0.0, 100.0), ("tsnet.clip.upload", 0.0, 20.0),
            ("tsnet.clip.copy_back", 10.0, 40.0)]
    assert mod.read(clip_record(both, [("k", 15.0, 10.0)])) == \
        pytest.approx(30.0 * 1e-3)
    assert mod.read({}) is None
    assert mod.read(clip_record([], device)) is None    # a program without spans
    assert mod.read(clip_record([("tsnet.clip.run", 0.0, 1.0)],
                                device)) is None
    assert mod.read({"train_shape": {}, "trace": {"host_events": host,
                                                  "device_events": device}
                     }) is None


@pytest.mark.parametrize("part", ["kernels", "modules"])
def test_setup_readers(part, monkeypatch):
    mod = harness.load_module("metrics", f"setup_s.{part}")
    monkeypatch.setattr(program_spans, "setup_counters",
                        lambda: {"kernels": 12.5, "modules": 3.25})
    traced = {"clip_shape": {}, "trace": {"host_events": []}}
    assert mod.read(traced) == {"kernels": 12.5, "modules": 3.25}[part]
    assert mod.read({}) is None
    monkeypatch.setattr(program_spans, "setup_counters", lambda: {})
    assert mod.read(traced) is None


def test_registry_reads_the_program():
    from wacv23_tsnet_tpu_torch.utils import profiling
    assert program_spans.registry() == profiling.spans()
    assert program_spans.setup_counters() == profiling.SETUP_S


@pytest.mark.parametrize("cell", ["face.clip", "pose.train"])
def test_a_traced_toy_run_reports_the_span_metrics(cell):
    """The spans of a traced toy run on the CPU (host clock): each new
    metric of the cell but `setup_s.kernels` (nothing is built on the
    CPU) is a finite number >= 0, and the stages sum to at most the
    unit's ms."""
    from wacv23_tsnet_tpu_torch.utils import profiling
    profiling.reset_spans()
    ctx = toy_context(cell, trace=True)
    rec = harness.run_cell(ctx)
    rec["device"] = {"platform": "cpu"}
    out = harness.assemble(ctx, rec, harness.benchmark_spec())
    readers = CLIP_READERS if "clip" in cell else TRAIN_READERS
    new = list(readers) + ["setup_s.modules"]
    if "clip" in cell:
        new.append("idle_ms.transfers.clip")
    for name in new:
        v = out["metrics"][name]["value"]
        assert math.isfinite(v) and v >= 0.0, (name, v)
    reg = profiling.spans()
    unit = "tsnet.clip.run" if "clip" in cell else "tsnet.train.step"
    per_unit = reg[unit]["ms"] / reg[unit]["count"]
    stages = sum(out["metrics"][n]["value"] for n in readers)
    assert stages <= per_unit * (1 + 1e-9)
    profiling.reset_spans()
