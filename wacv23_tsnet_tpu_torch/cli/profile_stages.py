"""Per-stage time of the clip-inference hot path and of the train step,
read from the port's spans (counterpart of the JAX package's
`cli/profile_stages.py`, same flags).

Clip: `tsnet_forward_clip` on seeded inputs through the entry point
itself, once to warm up, then `CALLS` times under
`utils.profiling.trace`; prints each stage span's ms per call
(`CLIP_SPANS`: `tsnet.encode_sources`, `tsnet.lbl_enc`, `tsnet.warp`,
`tsnet.fuse`, `tsnet.decode`) and their sum. `--train`: `CALLS` steps of
`make_train_step` at batch `--batch-size` with seeded random weights (the
VGG19 too, where `weights/` holds none), after one warm-up step, the same
way: the step's six phase spans (`TRAIN_SPANS`) and `tsnet.train.step`,
ms per step. A span's ms is device time on the GPU (CUDA events) and host
time on the CPU. The trace, spans included, goes to
`tsnet_trace/trace.json` in the working directory.

    python -m wacv23_tsnet_tpu_torch.cli.profile_stages [--frames 128]
    python -m wacv23_tsnet_tpu_torch.cli.profile_stages --train
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..configs import face_config
from ..device import resolve_device
from ..models.tsnet import TSNetModules, tsnet_forward_clip
from ..train.state import create_train_state
from ..train.step import make_train_step
from ..utils.profiling import card_line, spans, trace

CALLS = 3
CLIP_SPANS = ("tsnet.encode_sources", "tsnet.lbl_enc", "tsnet.warp",
              "tsnet.fuse", "tsnet.decode")
TRAIN_SPANS = ("tsnet.train.g_forward", "tsnet.train.d_phase",
               "tsnet.train.d_opt", "tsnet.train.g_loss_forward",
               "tsnet.train.g_backward", "tsnet.train.g_opt")
STEP_SPAN = "tsnet.train.step"
TRACE_DIR = "tsnet_trace"


def span_table(run, names, unit: str) -> dict:
    """`run()` once to warm up, then `CALLS` times under a trace; prints
    and returns each span of `names` as ms per `unit` (`stage_ms`), the
    spans it closed per `unit` (`count`) and the sum of their ms
    (`sum_ms`)."""
    run()
    with trace(TRACE_DIR):
        for _ in range(CALLS):
            run()
    got = spans()
    res = {"stage_ms": {}, "count": {}}
    for name in names:
        s = got.get(name, {"count": 0, "ms": 0.0})
        res["stage_ms"][name] = s["ms"] / CALLS
        res["count"][name] = s["count"] / CALLS
        print(f"  {name:<28s} {res['stage_ms'][name]:9.3f} ms/{unit} "
              f"({s['count']} spans in {CALLS} {unit}s)", flush=True)
    return res


def profile_clip(args, device: torch.device, base) -> dict:
    cfg = dataclasses.replace(base, precision=args.precision,
                              fast_tail=not args.no_fast_tail)
    mods = TSNetModules(cfg, device=device, seed=0)
    rng = np.random.default_rng(0)
    s, f, hw, nl = args.n_source, args.frames, args.size, cfg.label_nc

    def put(x):
        return torch.as_tensor(x.astype(np.float32), device=device)

    inputs = (put(rng.random((s, hw, hw, 3), np.float32)),
              put(rng.integers(0, 2, (s, hw, hw, nl))),
              put(rng.integers(0, 2, (s, hw, hw))),
              put(rng.integers(0, 2, (f, hw, hw, nl))),
              put(rng.integers(0, 2, (f, hw, hw))))
    print(f"device={card_line(device)} frames={f} n_source={s} "
          f"precision={cfg.precision} fast_tail={cfg.fast_tail}", flush=True)
    res = span_table(lambda: tsnet_forward_clip(mods, *inputs, device=device),
                     CLIP_SPANS, "call")
    res["sum_ms"] = sum(res["stage_ms"].values())
    print(f"  {'SUM of stages':<28s} {res['sum_ms']:9.3f} ms/call "
          f"({f / res['sum_ms'] * 1e3:.1f} frames/s equivalent)", flush=True)
    return res


def profile_train(args, device: torch.device, base) -> dict:
    cfg = dataclasses.replace(base, precision=args.precision,
                              bwd_precision=args.bwd_precision,
                              fast_tail=not args.no_fast_tail)
    state = create_train_state(cfg, device=device, seed=0)
    rng = np.random.default_rng(0)
    bs, hw, nl, s = args.batch_size, cfg.image_size, cfg.label_nc, \
        cfg.n_source
    batch = {k: torch.as_tensor(v.astype(np.float32), device=device)
             for k, v in {
                 "src_img": rng.random((bs, s, hw, hw, 3), np.float32),
                 "src_lbl": rng.integers(0, 2, (bs, s, hw, hw, nl)),
                 "src_bbox": rng.integers(0, 2, (bs, s, hw, hw)),
                 "tar_img": rng.random((bs, hw, hw, 3), np.float32),
                 "tar_lbl": rng.integers(0, 2, (bs, hw, hw, nl)),
                 "tar_bbox": rng.integers(0, 2, (bs, hw, hw))}.items()}
    print(f"device={card_line(device)} TRAIN bs={bs} {hw}^2 "
          f"precision={cfg.precision} bwd_precision={cfg.bwd_precision} "
          f"fast_tail={cfg.fast_tail}", flush=True)
    step = make_train_step(state)
    res = span_table(lambda: step(state, batch, 2e-4),
                     TRAIN_SPANS + (STEP_SPAN,), "step")
    res["sum_ms"] = sum(res["stage_ms"][name] for name in TRAIN_SPANS)
    print(f"  {'SUM of phases':<28s} {res['sum_ms']:9.3f} ms/step "
          f"({bs / res['sum_ms'] * 1e3:.2f} samples/s equivalent)",
          flush=True)
    return res


def main(argv=None, device="cuda", base_config=None) -> dict:
    """Parse `argv` and profile on `device` (the command line always
    takes the GPU) at `base_config` (default `face_config()`). Returns
    `{"stage_ms": {span: ms per call or step}, "count": {span: spans per
    call or step}, "sum_ms": the clip stages' or the step phases' sum}`."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=128)
    p.add_argument("--n-source", type=int, default=3)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--precision", default="high")
    p.add_argument("--no-fast-tail", action="store_true")
    p.add_argument("--train", action="store_true",
                   help="profile the TRAIN step stages instead")
    p.add_argument("--batch-size", type=int, default=15)
    p.add_argument("--bwd-precision", default=None,
                   help="precision of the backward convs (train profile); "
                        "'default' is the fast train tier's")
    args = p.parse_args(argv)
    dev = resolve_device(device)
    base = face_config() if base_config is None else base_config
    if args.train:
        return profile_train(args, dev, base)
    return profile_clip(args, dev, base)


if __name__ == "__main__":
    main()
