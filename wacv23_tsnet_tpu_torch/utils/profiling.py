"""Profiling helpers (counterpart of the JAX package's
`utils/profiling.py`): a `torch.profiler` trace exported for Perfetto or
chrome://tracing, named regions inside it, and rolling per-step
wall-clock percentiles; `card_line` names the device a measurement ran
on."""

from __future__ import annotations

import contextlib
import os
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str = "tsnet_trace"):
    """Profile the block (CPU, and the GPU where there is one) and write
    its Chrome trace to `log_dir/trace.json`; yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region inside a trace."""
    with record_function(name):
        yield


class StepProfiler:
    """Rolling per-step wall-clock stats with percentiles."""

    def __init__(self, window: int = 200):
        self.window = window
        self.samples: list[float] = []
        self._t = None

    def start(self):
        self._t = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t
        self.samples.append(dt)
        if len(self.samples) > self.window:
            self.samples.pop(0)
        return dt

    def summary(self) -> dict:
        if not self.samples:
            return {}
        s = sorted(self.samples)
        n = len(s)
        return {
            "mean_s": sum(s) / n,
            "p50_s": s[n // 2],
            "p90_s": s[int(n * 0.9)],
            "max_s": s[-1],
            "steps_per_sec": n / sum(s),
        }


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
