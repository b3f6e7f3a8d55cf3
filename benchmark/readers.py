"""Arithmetic the per-layer metric readers share. A reader returns None
where the run has nothing for it to read, never 0 for a share."""

from __future__ import annotations

import re

from . import flops


def share_of_peak(rec: dict, shape_key: str) -> float | None:
    """The window's model FLOPs over its seconds, as a % of the peak."""
    if shape_key not in rec or not rec.get("window_s"):
        return None
    return 100.0 * rec["model_flops"] / rec["window_s"] / flops.PEAK_FLOP_PER_S


def idle_share(rec: dict, shape_key: str) -> float | None:
    """% of the traced stretch in which no operation ran on the device."""
    tr = rec.get("trace")
    if (shape_key not in rec or not tr or tr["window_s"] <= 0
            or not tr["device_events"]):
        return None
    return 100.0 * max(0.0, 1.0 - tr["busy_s"] / tr["window_s"])


def kernel_roofline(rec: dict, pattern: str, launch: str, call) -> float | None:
    """% of a kernel's device time that its bound takes: the bound of one
    call (`call` = (flops, bytes)) times the wrapper's calls in the
    traced stretch, over the device time of the CUDA kernels whose names
    match `pattern` there."""
    tr = rec.get("trace")
    calls = (rec.get("launches") or {}).get(launch, 0)
    if not tr or calls <= 0:
        return None
    rx = re.compile(pattern)
    dev_s = sum(d for n, _, d in tr["device_events"] if rx.search(n)) * 1e-6
    if dev_s <= 0:
        return None
    return 100.0 * calls * flops.bound_s(*call) / dev_s
