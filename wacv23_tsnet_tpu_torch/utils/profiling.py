"""Profiling (counterpart of the JAX package's `utils/profiling.py`):
spans at the port's layer boundaries, set-up counters, a `torch.profiler`
trace exported for Perfetto or chrome://tracing, and `card_line`, which
names the device a measurement ran on.

Spans are on only while a `torch.profiler` runs (`trace` below, or any
other `torch.profiler.profile`). Off, `span(name)` is one check of the
profiler's flag and returns a shared no-op context. On, it opens
`record_function(name)`, so the span lands among the profiler's host
events on the device trace's clock; it records a pair of CUDA events on
the current stream where the work is on CUDA (the host clock on the CPU);
and it keeps a record of its name, the enclosing span's name and a unit
id, the sequence number of its outermost span, which all spans of one
job or step share. Nothing waits on the device until `spans()` or
`span_records()` reads the records.

`SETUP_S` counts set-up seconds by part, always (each part runs once a
process): `kernels`, building or loading the `csrc/` libraries
(`ops.cuda_build`); `modules`, constructing modules (`TSNetModules`,
`create_train_state`).

`CLIP_COPIES` counts, always, the chunks of frames `ClipInference` copied
back to the host: `staged`, through its pinned slots on a copy stream
(CUDA), and `plain`, kept on the device until the clip is done and copied
with it (any other device).

`CLIP_PACKS` counts, always, the chunks `ClipInference` decoded, by the
source pack they ran on: `encoded`, a pack encoded for the chunk (a
job's first), and `reused`, the job's pack encoded for an earlier chunk.

`DECODER_NORMS` counts, always, the instance norms of the phase decoder
(`nn.decoder.decoder_apply_fast`, `ops.upconv.upconv_in_relu`) by the
route each took (`ops.norm_kernels.instance_norm_routed`): `fused`,
through K8, and `plain`, the ATen composition. K7's norms, inside its
conv, are not counted.

`TRUNK_NORMS` counts, always, the same way the instance norms of the
encoders (`nn.encoder.Encoder`: stem, stride-2 convs, ResNet blocks) and
FuseNet's per-pair norm in `nn.fusenet.fuse_clip`; `fuse_train` and
`FuseNet.forward` keep the composition and are not counted.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import subprocess
import threading
import time

import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

SETUP_S: dict[str, float] = {}
CLIP_COPIES: dict[str, int] = {"staged": 0, "plain": 0}
CLIP_PACKS: dict[str, int] = {"encoded": 0, "reused": 0}
DECODER_NORMS: dict[str, int] = {"fused": 0, "plain": 0}
TRUNK_NORMS: dict[str, int] = {"fused": 0, "plain": 0}

_RECORDS: list = []
_UNITS = itertools.count()
_LOCAL = threading.local()
_SETUP_LOCK = threading.Lock()


class _Record:
    __slots__ = ("name", "parent", "unit", "start", "end", "ms")

    def __init__(self, name, parent, unit, start):
        self.name, self.parent, self.unit = name, parent, unit
        self.start, self.end, self.ms = start, None, None


def _stamp(device):
    """A CUDA event recorded on `device`'s current stream, or the host
    clock where `device` is None."""
    if device is None:
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class _Span:
    __slots__ = ("name", "device", "_fn", "_rec")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        parent = stack[-1] if stack else None
        self._fn = record_function(self.name)
        self._fn.__enter__()
        self._rec = _Record(self.name, parent,
                            next(_UNITS) if parent is None else parent.unit,
                            _stamp(self.device))
        stack.append(self._rec)
        _RECORDS.append(self._rec)
        return self

    def __exit__(self, *exc):
        self._rec.end = _stamp(self.device)
        _LOCAL.stack.pop()
        self._fn.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, device=None):
    """A context that records the block as the span `name` while a
    profiler runs, and does nothing otherwise. `device` is where the
    block's work runs; where not given, CUDA once CUDA is initialised."""
    if not autograd_profiler._is_profiler_enabled:
        return _OFF
    if device is None:
        cuda = torch.cuda.is_initialized()
        device = torch.device("cuda") if cuda else None
    else:
        device = torch.device(device)
        cuda = device.type == "cuda"
    return _Span(name, device if cuda else None)


def _finished() -> list:
    """The finished records, each resolved to its ms once."""
    done = []
    for r in list(_RECORDS):
        if r.end is None:
            continue
        if r.ms is None:
            if isinstance(r.start, float):
                r.ms = (r.end - r.start) * 1e3
            else:
                r.end.synchronize()
                r.ms = r.start.elapsed_time(r.end)
        done.append(r)
    return done


def span_records() -> list[dict]:
    """Every finished span in the order it opened: its `name`, its
    `parent`'s name (None for a unit's outermost span), its `unit` and
    its `ms` (device ms on CUDA, host ms on the CPU)."""
    return [{"name": r.name, "parent": r.parent and r.parent.name,
             "unit": r.unit, "ms": r.ms} for r in _finished()]


def spans() -> dict[str, dict]:
    """Name -> `count`, total `ms` and `self_ms` (each span's ms less the
    ms of its child spans) of the finished spans."""
    done = _finished()
    child_ms: dict[int, float] = {}
    for r in done:
        if r.parent is not None:
            child_ms[id(r.parent)] = child_ms.get(id(r.parent), 0.0) + r.ms
    out: dict[str, dict] = {}
    for r in done:
        s = out.setdefault(r.name, {"count": 0, "ms": 0.0, "self_ms": 0.0})
        s["count"] += 1
        s["ms"] += r.ms
        s["self_ms"] += r.ms - child_ms.get(id(r), 0.0)
    return out


def reset_spans() -> None:
    _RECORDS.clear()


@contextlib.contextmanager
def setup_time(part: str):
    """Count the block's (or, as a decorator, the call's) seconds toward
    `SETUP_S[part]`."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _SETUP_LOCK:
            SETUP_S[part] = SETUP_S.get(part, 0.0) + dt


@contextlib.contextmanager
def trace(log_dir: str = "tsnet_trace"):
    """Profile the block (CPU, and the GPU where there is one) and write
    its Chrome trace, spans included, to `log_dir/trace.json`; yields the
    profiler. The span records are cleared on entry, so `spans()`
    afterwards gives the block's stages."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset_spans()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def card_line(device) -> str:
    """The device a number was measured on: for a GPU, its name and power
    limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives them (a card set below its maximum runs
    slower under load), else torch's name of it; "cpu" for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = (f"{torch.cuda.get_device_name(index)}, power limit not read "
               f"({type(e).__name__})")
    return out
