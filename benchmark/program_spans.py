"""What the readers of the program's own spans and set-up counters share.

The port records spans at its layer boundaries while a profiler runs
(`wacv23_tsnet_tpu_torch.utils.profiling.span`), so a `--trace 1` run's
spans are those of its traced stretch, and counts set-up seconds by part
(`SETUP_S`). A program without them gives an empty registry, and its
readers return None.
"""

from __future__ import annotations

import importlib

from .trace import union_s

PROFILING = "wacv23_tsnet_tpu_torch.utils.profiling"
TRANSFERS = ("tsnet.clip.upload", "tsnet.clip.copy_back")


def _profiling():
    try:
        return importlib.import_module(PROFILING)
    except ImportError:
        return None


def registry() -> dict:
    """The program's finished spans: name -> count, ms, self_ms."""
    spans = getattr(_profiling(), "spans", None)
    return spans() if spans is not None else {}


def setup_counters() -> dict:
    """The program's set-up seconds by part."""
    return dict(getattr(_profiling(), "SETUP_S", None) or {})


def per_unit_ms(rec: dict, reg: dict, names, unit: str,
                shape_key: str) -> float | None:
    """The device ms of the spans `names` over the count of the unit's
    span, in a traced run of a cell with `shape_key`."""
    if shape_key not in rec or not rec.get("trace"):
        return None
    units = reg.get(unit, {}).get("count", 0)
    if units <= 0 or not all(n in reg for n in names):
        return None
    return sum(reg[n]["ms"] for n in names) / units


def idle_in_spans_ms(rec: dict, names=TRANSFERS,
                     unit: str = "tsnet.clip.run") -> float | None:
    """Ms a unit in which no device operation runs while one of the host
    spans `names` is open, from the traced stretch's events."""
    tr = rec.get("trace")
    if "clip_shape" not in rec or not tr:
        return None
    units = sum(1 for n, _, _ in tr["host_events"] if n == unit)
    held = [(s, e) for n, s, e in tr["host_events"] if n in names and e > s]
    if units <= 0 or not held:
        return None
    busy = [(s, s + d) for _, s, d in tr["device_events"]]
    held_s = union_s(held)
    busy_held_s = union_s([(max(s, a), min(e, b)) for a, b in held
                           for s, e in busy if min(e, b) > max(s, a)])
    return 1e3 * (held_s - busy_held_s) / units


def setup_part_s(rec: dict, counters: dict, part: str) -> float | None:
    """The set-up seconds of `part`, in a traced run."""
    if not rec.get("trace") or part not in counters:
        return None
    return float(counters[part])
