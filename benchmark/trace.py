"""A bounded stretch of a run under `torch.profiler`, kept in memory.

`Stretch` starts the profiler (CPU and CUDA activity) and stops it after
the caller's units; nothing is written to disk. `digest()` turns the
events into what the metric readers read: each device operation
(kernel, copy, set) as (name, start_us, duration_us), the host
operations as (name, start_us, end_us), the device's busy seconds (the
union of its operations' intervals) and the stretch's length on the
host clock, and the breakdown of the result line (the device operations
that took most time, the longest idle gaps by the host operation that
ran during each).
"""

from __future__ import annotations

import time

import torch
from torch.profiler import ProfilerActivity, profile

def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def union_s(intervals) -> float:
    """Seconds covered by (start_us, end_us) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-6


def idle_gaps(intervals):
    """(start_us, end_us) of the gaps between merged intervals."""
    gaps, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its trailing argument list."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i > 0 else name
                break
    return name.strip()[:limit]


class Stretch:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.window_s = 0.0

    def start(self):
        if not self.enabled:
            return
        sync()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self):
        if self.prof is None or self.window_s:
            return
        sync()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)

    def digest(self) -> dict | None:
        if self.prof is None:
            return None
        device, host = [], []
        for ev in self.prof.profiler.kineto_results.events():
            start = ev.start_ns() / 1e3
            dur = ev.duration_ns() / 1e3
            on_device = "cpu" not in str(ev.device_type()).lower()
            if on_device and ev.is_user_annotation():
                continue            # a benchmark span's copy on the device
            if on_device:
                device.append((ev.name(), start, dur))
            else:
                host.append((ev.name(), start, start + dur))
        spans = [(s, s + d) for _, s, d in device]
        busy = union_s(spans)
        by_name: dict = {}
        for name, _, dur in device:
            key = short_name(name)
            by_name[key] = by_name.get(key, 0.0) + dur * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(idle_gaps(spans), key=lambda g: g[0] - g[1])[:10]
        named = [[self.host_at(host, (a + b) / 2), (b - a) * 1e-6]
                 for a, b in gaps]
        return {"device_events": device, "host_events": host,
                "busy_s": busy, "window_s": self.window_s,
                "breakdown": {"device_ops": [[k, v] for k, v in top],
                              "idle_gaps": named}}

    @staticmethod
    def host_at(host, t_us) -> str:
        """The innermost host operation running at t_us, under the
        outermost benchmark span around it."""
        around = [(e - s, n) for n, s, e in host if s <= t_us <= e]
        if not around:
            return "host idle"
        around.sort()
        inner = around[0][1]
        bench = [n for _, n in around if n.startswith("bench.")]
        return f"{bench[-1]} > {inner}" if bench and bench[-1] != inner \
            else inner
