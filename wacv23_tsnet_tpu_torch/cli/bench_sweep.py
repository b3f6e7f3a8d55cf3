"""Benchmark sweep: the clip's frames/s over the number of sources and
the chunk size, on one GPU (counterpart of the JAX package's
`cli/bench_sweep.py`, same grid, flags and output).

n_source 1, 3 and 5 at `--frames` (64) frames, then chunks of 8, 16, 32,
64 and 128 frames at n_source 3, each through `tsnet_forward_clip` on
the kernel path with seeded random weights and inputs, in the tier of
`--precision` ("high") and `--fast-tail` (on): K1 and K2 a call. Each
config is run once to warm up, then timed over 5 calls, each ending in a
device sync (`float` of the output's absolute sum, as the JAX CLI's
`float(fn(...))`). The first stderr line names the card and its power
limit; then a table goes to stderr and one JSON line per config to
stdout.

    python -m wacv23_tsnet_tpu_torch.cli.bench_sweep
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from ..configs import face_config
from ..device import resolve_device
from ..models.tsnet import TSNetModules, tsnet_forward_clip
from ..utils.profiling import card_line

N_SOURCES = (1, 3, 5)
CHUNKS = (8, 16, 32, 64, 128)


def clip_inputs(cfg, n_source: int, frames: int, device) -> tuple:
    """Seeded sources (n_source) and driving frames, as the JAX CLI makes
    them, on `device`."""
    rng = np.random.default_rng(0)
    sz, nl = cfg.image_size, cfg.label_nc
    arrays = (
        rng.random((n_source, sz, sz, 3), np.float32),
        rng.integers(0, 2, (n_source, sz, sz, nl)).astype(np.float32),
        rng.integers(0, 2, (n_source, sz, sz)).astype(np.float32),
        rng.integers(0, 2, (frames, sz, sz, nl)).astype(np.float32),
        rng.integers(0, 2, (frames, sz, sz)).astype(np.float32))
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def measure(cfg, n_source: int, frames: int, iters: int = 5,
            device="cuda") -> float:
    """Frames/s of the clip at this config: one warm-up call, then the
    mean over `iters` synchronized calls."""
    dev = resolve_device(device)
    mods = TSNetModules(cfg, device=dev, seed=0)
    args = clip_inputs(cfg, n_source, frames, dev)

    def fn() -> float:
        return float(tsnet_forward_clip(mods, *args, device=dev).abs().sum())

    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return frames / ((time.perf_counter() - t0) / iters)


def _line(cfg, what: str, fps: float) -> str:
    sz = cfg.image_size
    return json.dumps({"metric": f"streaming inference {what}, {sz}x{sz}",
                       "value": round(fps, 2), "unit": "frames/sec/chip"})


def main(argv=None, base_config=None, device="cuda") -> list[dict]:
    """Parse `argv` and sweep on `device` (the command line always takes
    the GPU); `base_config` replaces `face_config()` (tests run the toy
    config on the CPU). Returns the JSON lines as dicts."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--precision", default="high")
    p.add_argument("--fast-tail", action=argparse.BooleanOptionalAction,
                   default=True)
    args = p.parse_args(argv)
    dev = resolve_device(device)
    print(card_line(dev), file=sys.stderr, flush=True)
    cfg = dataclasses.replace(base_config or face_config(),
                              precision=args.precision,
                              fast_tail=args.fast_tail)
    grid = ([(n, args.frames, f"n_source={n}") for n in N_SOURCES]
            + [(3, f, f"chunk={f}, n_source=3") for f in CHUNKS])
    print(f"{'n_source':>8} {'frames':>6} {'fps/chip':>9}", file=sys.stderr)
    lines = []
    for n_source, frames, what in grid:
        fps = measure(cfg, n_source, frames, device=dev)
        print(f"{n_source:>8} {frames:>6} {fps:>9.1f}", file=sys.stderr)
        line = _line(cfg, what, fps)
        print(line, flush=True)
        lines.append(json.loads(line))
    return lines


if __name__ == "__main__":
    main()
