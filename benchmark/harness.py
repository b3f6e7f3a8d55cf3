"""The benchmark's command: one cell, one seed, one measured window.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Everything is found by name. The cell `benchmark/workloads/<cell>.json`
names its configuration (`benchmark/configs/<config>.json`), its driver
(`benchmark/drivers/<driver>.py`), its tier, its traffic parameters and
the limits of its correctness checks. `BENCHMARK.json` at the root says
which end-to-end metrics (with `--trace 0`) and which per-layer metrics
(with `--trace 1`) the cell reports; each per-layer metric is read by
`benchmark/metrics/<metric>.py`, whose `read(record)` returns a number,
or None where the run has nothing for it to read (the metric is then
left out of the line).

A driver's `run(ctx)` builds the cell's program state from the seed,
warms up the cell's shapes, measures for `ctx.seconds`, checks what the
timed path produced against `benchmark/reference/`, and returns a
`record` dict: `attempted`, `failed`, `e2e` (metric -> value),
`checks` ([(name, value, limit)]), `memory_peak_bytes` and whatever its
readers read (`window_s`, `model_flops`, `trace`, `launches`, shapes).

The last line of standard output is the result, as one JSON object:
`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
`breakdown`, and last `checks`, each compared number beside its limit
(they are also the last lines of standard error). A run exits 2 without
a result where there is no CUDA device or fewer than the cell's chips,
and 3 where a module of JAX or of the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# loaded top-level modules that a run may not hold, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "wacv23_tsnet_tpu")
PLATFORM = "gpu"


def load_json(kind: str, name: str) -> dict:
    path = BENCH_DIR / kind / f"{name}.json"
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    mod_name = "benchmark_" + kind + "_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(spec: dict, cell: str) -> tuple[list, list]:
    """The end-to-end and per-layer metric entries `cell` reports."""
    def listed(m):
        return "workloads" not in m or cell in m["workloads"]
    e2e = [m for m in spec["end_to_end"] if listed(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if listed(m) and ("workloads" in m or m["moves"] in names)]
    return e2e, layer


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    cell_name: str
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float                  # process start, on time.perf_counter()


def device_info(device, chips: int) -> dict:
    """The card's name and power limit, as `nvidia-smi` gives them."""
    import subprocess

    import torch
    name = torch.cuda.get_device_name(device)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"not read ({type(e).__name__})"
    return {"platform": PLATFORM, "kind": name, "count": chips,
            "power_limit": out}


def assemble(ctx: Context, record: dict, spec: dict) -> dict:
    """The result line's object from a driver's record."""
    e2e, layer = cell_metrics(spec, ctx.cell_name)
    metrics = {}
    if ctx.trace:
        for m in layer:
            value = load_module("metrics", m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            if m["name"] in record["e2e"]:
                metrics[m["name"]] = {"value": record["e2e"][m["name"]],
                                      "unit": m["unit"]}
    checks = record["checks"]
    finite = all(math.isfinite(v) for _, v, _ in checks)
    correct = (bool(checks) and finite and record["failed"] == 0
               and all(v <= lim for _, v, lim in checks))
    out = {"correct": correct, "attempted": record["attempted"],
           "failed": record["failed"], "metrics": metrics,
           "device": record["device"]}
    tr = record.get("trace")
    if ctx.trace and tr is not None:
        out["device"]["busy_s"] = tr["busy_s"]
        out["device"]["window_s"] = tr["window_s"]
        out["breakdown"] = tr["breakdown"]
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    return out


def run_cell(ctx: Context) -> dict:
    """The driver's record of one run."""
    driver = load_module("drivers", ctx.cell["driver"])
    return driver.run(ctx)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    cell = load_json("workloads", args.workload)
    config = load_json("configs", cell["config"])
    spec = benchmark_spec()
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    import torch
    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (the benchmark runs on the card only)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    ctx = Context(args.workload, cell, config, args.seed, args.seconds,
                  bool(args.trace), device, t0)
    record = run_cell(ctx)
    record["device"] = dict(device_info(device, chips),
                            memory_peak_bytes=record["memory_peak_bytes"])
    found = forbidden_modules()
    if found:
        print(f"no result: modules of JAX or the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 3
    result = assemble(ctx, record, spec)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

