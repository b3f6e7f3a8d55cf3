"""Offline clip renders through `infer.pipeline.ClipInference.run`, in a
closed loop.

Each job is one subject (its source frames, class maps and boxes) and
one driving clip of face class maps and boxes, all host arrays as a
caller of `run` holds them; the frames come back to the host. A pool of
subjects and clips is drawn from the seed at set-up and cycled. The
rate is the real driving frames returned in the window over the window
(the wrapped frames that pad the last chunk do not count).

`correct`: a sample of the window's jobs, drawn from the seed
(reservoir sampling over all jobs the window finished), is rendered
again by the reference after the program's state is freed, from the
same inputs and weights, and compared frame by frame.
"""

from __future__ import annotations

import json
import sys
import time
import traceback

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import common, flops, traffic, weights
from benchmark.reference import model as ref
from benchmark.trace import Stretch


def make_pool(ctx) -> tuple[list, list]:
    """Subjects and driving clips, host arrays as `ClipInference.run`
    takes them: images (S, 3, H, W) in dataset space (model space times
    255), class maps (.., H, W) uint8, boxes (.., H, W) float32."""
    tr, size = ctx.cell["traffic"], ctx.config["image_size"]
    s = tr["sources"]
    subjects, clips = [], []
    for i in range(tr["subjects"]):
        r = common.rng(ctx.seed, 100 + i)
        lbl, box = traffic.face_clip(r, s, size, ctx.device, tr["radius"])
        img = traffic.smooth_images(r, s, size, ctx.device)
        subjects.append({"img": (img.permute(0, 3, 1, 2) * 255.0).cpu().numpy(),
                         "lbl": lbl.cpu().numpy(), "box": box.cpu().numpy()})
    for j in range(tr["clips"]):
        r = common.rng(ctx.seed, 200 + j)
        lbl, box = traffic.face_clip(r, tr["frames"], size, ctx.device,
                                     tr["radius"])
        clips.append({"lbl": lbl.cpu().numpy(), "box": box.cpu().numpy()})
    return subjects, clips


def job_inputs(pool, k: int) -> tuple:
    subjects, clips = pool
    s, c = subjects[k % len(subjects)], clips[k % len(clips)]
    return s["img"], s["lbl"], s["box"], c["lbl"], c["box"]


def build_program(ctx, w: dict):
    """The engine the window drives, with the seed's weights."""
    from wacv23_tsnet_tpu_torch.infer.pipeline import ClipInference
    from wacv23_tsnet_tpu_torch.models.tsnet import TSNetModules
    from wacv23_tsnet_tpu_torch.ops import cuda_build
    cfg = common.port_config(ctx.config, ctx.cell["tier"])
    if ctx.device.type == "cuda":
        cuda_build.build_all(tuple(ctx.cell["kernels"]))
    mods = TSNetModules(cfg, device=ctx.device)
    mods.load_state_dict(w)
    return ClipInference(cfg, mods, use_kernels=True,
                         chunk=ctx.cell["traffic"]["chunk"],
                         device=ctx.device)


def reference_frames(ctx, w: dict, inputs: tuple, prec) -> torch.Tensor:
    """The reference's (F, 3, H, W) frames of one job."""
    img, lbl, box, tlbl, tbox = inputs
    dev, nc = ctx.device, ctx.config["label_nc"]

    def t(x):
        return torch.as_tensor(np.asarray(x), device=dev)
    return ref.generator_clip(
        w, ctx.config, t(img).float().permute(0, 2, 3, 1) / 255.0,
        traffic.one_hot(t(lbl), nc), t(box).float(),
        traffic.one_hot(t(tlbl), nc), t(tbox).float(), prec,
        block=ctx.cell["traffic"]["chunk"])


def frame_gaps(prog, want: torch.Tensor) -> dict:
    """Mean absolute difference over all frames, and the worst frame's."""
    got = torch.as_tensor(prog, device=want.device)
    d = (got.float() - want).abs().flatten(1).mean(1).double()
    return {"frame_mad_mean": float(d.mean()),
            "frame_mad_worst": float(d.max())}


def control_readings(ctx, spec: dict | None = None) -> dict:
    """The numbers of the reference in the program's place, computed at
    `spec`'s precision (the cell's `control` by default), on the jobs a
    run checks."""
    w = weights.make(ctx.config, ctx.seed, ctx.device, train=False)
    pool = make_pool(ctx)
    out = {"frame_mad_mean": 0.0, "frame_mad_worst": 0.0}
    for k in range(ctx.cell["traffic"]["check_jobs"]):
        inputs = job_inputs(pool, k)
        want = reference_frames(ctx, w, inputs,
                                common.precision(ctx.cell["reference"]))
        got = reference_frames(ctx, w, inputs, common.precision(
            spec or ctx.cell["control"]))
        g = frame_gaps(got, want)
        out = {n: max(out[n], g[n]) for n in out}
    return out


def run(ctx) -> dict:
    from wacv23_tsnet_tpu_torch.ops import cuda_build
    tr, dev = ctx.cell["traffic"], ctx.device
    w = weights.make(ctx.config, ctx.seed, dev, train=False)
    engine = build_program(ctx, w)
    pool = make_pool(ctx)
    for k in range(tr["warmup_jobs"]):
        engine.run(*job_inputs(pool, k))
    common.sync(dev)

    stretch = Stretch(ctx.trace)
    pick = common.rng(ctx.seed, 300)
    kept: list = []
    jobs = frames = failed = 0
    job_s = []
    before = dict(cuda_build.LAUNCHES)
    launches = None
    stretch.start()          # the profiler's own start stays outside the window
    t_start = time.perf_counter()
    while True:
        k = tr["warmup_jobs"] + jobs
        jobs += 1
        t_job = time.perf_counter()
        try:
            with record_function("bench.job"):
                out = engine.run(*job_inputs(pool, k))
            job_s.append(time.perf_counter() - t_job)
        except Exception:
            failed += 1
            traceback.print_exc(file=sys.stderr)
            out = None
        if out is not None:
            frames += out.shape[0]
            n_done = jobs - failed
            if len(kept) < tr["check_jobs"]:
                kept.append((k, out))
            else:
                j = int(pick.integers(0, n_done))
                if j < tr["check_jobs"]:
                    kept[j] = (k, out)
        if launches is None and jobs >= tr["traced_jobs"]:
            stretch.stop()
            launches = {n: v - before[n] for n, v in cuda_build.LAUNCHES.items()}
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    common.sync(dev)
    window_s = time.perf_counter() - t_start
    stretch.stop()
    if launches is None:
        launches = {n: v - before[n] for n, v in cuda_build.LAUNCHES.items()}
    peak = common.memory_peak(dev)
    digest = stretch.digest()
    del engine
    common.free(dev)

    gaps = {"frame_mad_mean": 0.0, "frame_mad_worst": 0.0}
    prec = common.precision(ctx.cell["reference"])
    for k, out in kept:
        g = frame_gaps(out, reference_frames(ctx, w, job_inputs(pool, k),
                                             prec))
        gaps = {n: max(gaps[n], g[n]) for n in gaps}
    limits = ctx.cell["limits"]
    print("readings: " + json.dumps(gaps), file=sys.stderr)
    if job_s:
        q = np.quantile(job_s, [0.0, 0.5, 1.0])
        print(f"job seconds over {len(job_s)} jobs: min {q[0]:.4f}, "
              f"median {q[1]:.4f}, max {q[2]:.4f}", file=sys.stderr)
    checks = [(n, gaps[n], limits[n]) for n in limits] if kept else []
    fs = ctx.config["image_size"] // 2 ** ctx.config["n_downsampling"]
    feat = ctx.config["ngf"] * 2 ** ctx.config["n_downsampling"]
    return {
        "attempted": jobs, "failed": failed,
        "e2e": {"clip_fps": frames / window_s,
                "setup_s": t_start - ctx.t0},
        "checks": checks, "readings": gaps, "memory_peak_bytes": peak,
        "job_s": job_s,
        "window_s": window_s,
        "model_flops": (jobs - failed) * flops.clip_flops(
            ctx.config, tr["sources"], tr["frames"]),
        "trace": digest, "launches": launches,
        "clip_shape": {"sources": tr["sources"], "chunk": tr["chunk"],
                       "t": fs * fs, "c": feat,
                       "tail_bytes": 2 if ctx.cell["tier"].get("fast_tail")
                       else 4},
    }
