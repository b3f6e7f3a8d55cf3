#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`wacv23_tsnet_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU, nvcc and the repository around it; exits
non-zero, printing no result, where CUDA or the package is missing.

1. Prints the card's name and power limit and the torch/CUDA versions.
2. Builds every CUDA kernel from `wacv23_tsnet_tpu_torch/csrc/` (one nvcc
   per source, all started together) and prints ptxas's resource lines.
3. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (S=3 sources, T=32x32 pixels, C=512, F=32 frames;
   K2 at (3, 32, 32, 32, 1024); K6 at S=3, F=32, 32x32, K=1024; K7 with
   relu and with skip at (32, 32, 32, 512)), and times both with CUDA
   events; for K6 and K7 also cuDNN's bf16 conv alone, as a yardstick.
4. Drives the main path at the full width of `face_config()` with seeded
   random weights, in both tiers (bit-parity; bench = "high" + fast_tail
   + fast_trunk): `tsnet_forward_clip` over a 64-frame clip and four
   32-frame `RetargetSession.push_labels` requests (one with
   output="display"). Launch counts are zeroed just before each tier's
   run and read just after; each tier must launch its kernels. The
   kernel path is compared with the same model run through the plain
   versions, and frames/s, stage times and a profile are printed; last,
   how far the bench tier (and the bf16 tail alone) moves the output
   from the bit-parity tier. Then the `bench+fused` tier: the bench
   config with TSNET_FUSE_PAIR_KERNEL=1 (K6 in FuseNet) and
   `fused_blocks=True` (K7 in the decoder), a 64-frame clip and two
   32-frame `decode_with_sources` requests on one source pack, held
   against its plain path and against the unfused bench tier's clip.
5. Holds the training kernels against their plain versions at the train
   shape (G=15 samples, NS=3 sources, NF=1, T=32x32, C=512): K3-flow
   (warped features and flow, temp 100) and K4 (six cotangents at temps
   10 and 100, against the plain version in fp32 and in float64, and
   given the plain version's own flow).
6. Drives the GAN train step (`train.make_train_step`) at the full width
   of `face_config()`, bit-parity tier, batch 15: the first step from one
   seeded state through the kernels and through the plain versions
   (metrics and per-subnet gradients compared, at temp 10 and at the
   config's 100), then 20 steps on a fixed
   batch with the launch counts zeroed just before and read just after
   (one K3-flow, one K4 and one K2 a step; no inference kernel), with
   ms/step, samples/s, the CUDA-event stage split, peak memory and a
   profile; the metrics must stay finite and G_VGG must fall.
7. Prints one `kernels` JSON line, the card line again, and last
   `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from wacv23_tsnet_tpu_torch.configs import face_config
from wacv23_tsnet_tpu_torch.infer import RetargetSession
from wacv23_tsnet_tpu_torch.models import (TSNetModules, tsnet_forward,
                                           tsnet_forward_clip)
from wacv23_tsnet_tpu_torch.models.tsnet import (decode_with_sources,
                                                 encode_sources)
from wacv23_tsnet_tpu_torch.nn import fuse_clip
from wacv23_tsnet_tpu_torch.ops import conv_kernels as ck
from wacv23_tsnet_tpu_torch.ops import cuda_build
from wacv23_tsnet_tpu_torch.ops import fuse_kernels as fk
from wacv23_tsnet_tpu_torch.ops import norm_kernels as nk
from wacv23_tsnet_tpu_torch.ops import warp_kernels as wk
from wacv23_tsnet_tpu_torch.ops.coords import normalized_grid
from wacv23_tsnet_tpu_torch.ops.norms import l2_normalize
from wacv23_tsnet_tpu_torch.ops.resize import resize_nearest
from wacv23_tsnet_tpu_torch.ops.similarity import (
    transformation_warp_clip, transformation_warp_clip_mean)
from wacv23_tsnet_tpu_torch.train import (GEN_SUBNETS, create_train_state,
                                          make_train_step)

# Published peaks of one H100 SXM (NVIDIA data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12      # CUDA cores, outside the tensor cores
BF16_TC_FLOP_PER_S = 989e12  # tensor cores, dense

# kernel-vs-plain tolerances on the card, elementwise |err| <= atol +
# rtol * |plain|. f32 out: both sides are fp32, but 512-term dot products
# summed in another order, times the temp-100 softmax, move the flow by
# ~1e-5 pixels and the warped features by that times their gradient;
# 1e-3 is the bit-parity tier's end-to-end bound. bf16 out: one bf16
# step (2^-8 relative) on top.
TOL = {"f32": (1e-3, 0.0), "bf16": (1e-3, 2.0 ** -8)}
IN_TOL = {"f32": (1e-4, 0.0), "bf16": (1e-4, 2.0 ** -8)}
# K6/K7 (bf16 out) against their plain versions: both round an fp32 conv
# sum to bf16 once, so they may sit one bf16 step apart (2^-7 relative);
# K7 1e-3 absolute for fp32 sums taken in another order. K6 also rounds
# its hp to bf16: where the two sides' statistics differ in their last
# fp32 bit, an hp value a rounding away from a tie rounds the other way,
# which moves an output by ulp(hp) * |w| (up to 2^-6 * 0.1 = 1.6e-3 at
# these weights); a few such terms can meet in one of 9216: 8e-3.
TC_TOL = (1e-3, 2.0 ** -7)
K6_TOL = (8e-3, 2.0 ** -7)
FUSE_ENV = "TSNET_FUSE_PAIR_KERNEL"
FUSED_TIER = "bench+fused"

CLIP_FRAMES = 64
CHUNK = 32

# K4 against autograd through the plain forward: each cotangent within
# BWD_RTOL * max(1, max |reference|) (sums over target rows and sources in
# another order, and the scatter into da by fp32 atomics). At temp 10,
# K4 on K3-flow's flow against the plain version in fp32 and in float64.
# At temp 100 the flow of random features sits near pixel centres, where
# the bilinear warp's gradient jumps, and an fp32 flow (K3-flow's or the
# plain version's) crosses a cell edge that the exact flow does not on a
# row or two; each such row moves a cotangent by a few 1e-2 of its
# largest. So at temp 100 K4 is held given the plain version's own flow
# and lse, and the rest is printed with the count of such rows.
BWD_RTOL = 2e-4
TRAIN_BATCH = 15
TRAIN_STEPS = 20
TRAIN_LR = 2e-4
# kernel path vs plain path on the first train step: metrics relative;
# every subnet's gradient (relative L2) within 1e-3, or within
# NUDGE_MARGIN times how far the plain path's own gradient moves when the
# input images move by INPUT_NUDGE relative. The generator is a deep
# fp32 net with ReLU/instance-norm kinks and L1 losses (sign gradients),
# and at temp 100 warps whose gradients jump at pixel edges: with random
# weights a rounding-level change of its inputs moves its gradients by
# far more than 1e-3, and the kernels' rounding is such a change.
STEP_METRIC_RTOL = 1e-4
STEP_GRAD_RTOL = 1e-3
INPUT_NUDGE = 1e-6
NUDGE_MARGIN = 2.0
TRAIN_KERNELS = ("transform_warp_pairs", "transform_warp_pairs_bwd",
                 "instance_norm_mean")
FORWARD_KEYS = ("src_img", "src_lbl", "src_bbox", "tar_lbl", "tar_bbox")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, iters: int = 10) -> float:
    """Mean ms per call on the card: CUDA events around `iters` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(got, want, tol) -> dict:
    atol, rtol = tol
    err = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    return {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
            "worst_err_over_tol": (err / bound).max().item()}


def bound(nbytes: float, flops: float,
          peak: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    """The least ms the card could take, and what bounds it; `peak` is
    the rate of the operations' type."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = flops / peak
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                         else "operations")


def kernel_checks(line: str) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    dev = torch.device("cuda")
    s, f, h, w, c = 3, 32, 32, 32, 512
    t = h * w
    g = torch.Generator().manual_seed(0)
    src = torch.randn(s, t, c, generator=g)
    args = tuple(x.to(dev).contiguous() for x in (
        src, l2_normalize(torch.randn(f, t, c, generator=g)),
        l2_normalize(src), (torch.rand(f, t, generator=g) > 0.5).float(),
        (torch.rand(s, t, generator=g) > 0.5).float(),
        normalized_grid(h, w).reshape(t, 2)))
    in_bytes = 4 * (2 * s * t * c + f * t * c + s * t + f * t + 2 * t)
    warp_flops = s * f * t * (2 * t * c + 10 * t + 8 * c)
    x32 = (torch.randn(s, f, h, w, 2 * c, generator=g) * 2 + 1).to(dev)
    in_elems = x32.numel()
    in_flops = 7 * in_elems

    cases = {
        "transform_warp_pairs_mean": dict(
            kernel=lambda: wk.transform_warp_pairs_mean(
                *args, h, w, out_dtype=torch.bfloat16),
            plain=lambda: wk.transform_warp_mean_plain(
                *args, h, w, out_dtype=torch.float32),
            tol=TOL["bf16"], bytes=in_bytes + 2 * f * t * c,
            flops=warp_flops, tier="bench",
            replaces="wacv23_tsnet_tpu/ops/pallas_similarity.py:495",
            source="wacv23_tsnet_tpu_torch/csrc/transform_warp.cu"),
        "transform_warp_pairs_mean_f32out": dict(
            kernel=lambda: wk.transform_warp_pairs_mean(*args, h, w),
            plain=lambda: wk.transform_warp_mean_plain(*args, h, w),
            tol=TOL["f32"], bytes=in_bytes + 4 * f * t * c,
            flops=warp_flops, tier=None),
        "transform_warp_pairs_nf": dict(
            kernel=lambda: wk.transform_warp_pairs_nf(*args, h, w),
            plain=lambda: wk.transform_warp_pairs_nf_plain(*args, h, w),
            tol=TOL["f32"], bytes=in_bytes + 4 * s * f * t * c,
            flops=warp_flops, tier="bit-parity",
            replaces="wacv23_tsnet_tpu/ops/pallas_similarity.py:262",
            source="wacv23_tsnet_tpu_torch/csrc/transform_warp.cu"),
        "instance_norm_mean_f32": dict(
            kernel=lambda: nk.instance_norm_mean(x32),
            plain=lambda: nk.instance_norm_mean_plain(x32),
            tol=IN_TOL["f32"], bytes=4 * in_elems + 4 * in_elems // s,
            flops=in_flops, tier="bit-parity",
            replaces="wacv23_tsnet_tpu/ops/pallas_norms.py:135",
            source="wacv23_tsnet_tpu_torch/csrc/in_mean.cu"),
    }
    x16 = x32.to(torch.bfloat16)
    cases["instance_norm_mean_bf16"] = dict(
        kernel=lambda: nk.instance_norm_mean(x16),
        plain=lambda: nk.instance_norm_mean_plain(x16,
                                                  out_dtype=torch.float32),
        tol=IN_TOL["bf16"], bytes=2 * in_elems + 2 * in_elems // s,
        flops=in_flops, tier="bench",
        replaces="wacv23_tsnet_tpu/ops/pallas_norms.py:135",
        source="wacv23_tsnet_tpu_torch/csrc/in_mean.cu")
    cases.update(fused_tail_cases(g))

    results = {}
    for name, case in cases.items():
        got = case["kernel"]()
        torch.cuda.synchronize()
        res = compare(got, case["plain"](), case["tol"])
        check(res["worst_err_over_tol"] <= 1.0,
              f"{name} disagrees with its plain version: {res}")
        res["ms"] = time_ms(case["kernel"])
        res["plain_ms"] = time_ms(case["plain"], iters=3)
        res["bound_ms"], res["bound_by"] = bound(
            case["bytes"], case["flops"], case.get("peak", FP32_FLOP_PER_S))
        res.update({k: case[k] for k in ("tier", "replaces", "source",
                                         "launch") if k in case})
        yardstick = ""
        if "conv_alone" in case:
            res["conv_alone_ms"] = time_ms(case["conv_alone"])
            yardstick = (f" conv_alone_ms={res['conv_alone_ms']:.4f} (cuDNN "
                         "bf16 3x3 conv alone on a pre-padded input, "
                         "yardstick only)")
        results[name] = res
        print(f"[kernel] {name}: max_abs_err={res['max_abs_err']:.3e} "
              f"mean_abs_err={res['mean_abs_err']:.3e} "
              f"(atol, rtol)={case['tol']} kernel_ms={res['ms']:.4f} "
              f"plain_ms={res['plain_ms']:.4f} library_ms=none "
              f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']})"
              f"{yardstick} | {line}", flush=True)
    torch.cuda.synchronize()
    return results


def conv_alone(b: int, c: int, co: int, h: int, w: int, g):
    """cuDNN's bf16 3x3 conv of (b, c, h + 2, w + 2) channels_last to co
    channels: the convolution of K6/K7 without their norms and pads."""
    x = torch.randn(b, c, h + 2, w + 2, generator=g).to(
        "cuda", torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wt = (torch.randn(co, c, 3, 3, generator=g) * 0.02).to(
        "cuda", torch.bfloat16).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(x, wt)


def fused_tail_cases(g) -> dict:
    """K6 at S=3, F=32, 32x32, K=Co=1024 and K7 (relu; skip) at
    (32, 32, 32, 512), bf16: the fused tier's shapes per 32-frame call."""
    dev = torch.device("cuda")
    s, f, h, w, k = 3, 32, 32, 32, 1024
    n = h * w
    c1a = torch.randn(s, h, w, k, generator=g).to(dev, torch.bfloat16)
    c1t = torch.randn(f, h, w, k, generator=g).to(dev, torch.bfloat16)
    w2 = (torch.randn(k, k, 3, 3, generator=g) * 0.02).to(dev)
    b, c = 32, 512
    x = torch.randn(b, h, w, c, generator=g).to(dev, torch.bfloat16)
    skip = torch.randn(b, h, w, c, generator=g).to(dev, torch.bfloat16)
    wc = (torch.randn(c, c, 3, 3, generator=g) * 0.02).to(dev)
    k7_flops = 2 * b * n * 9 * c * c
    k7 = dict(tol=TC_TOL, flops=k7_flops, peak=BF16_TC_FLOP_PER_S,
              conv_alone=conv_alone(b, c, c, h, w, g), launch="conv3x3_in",
              replaces="wacv23_tsnet_tpu/ops/pallas_conv.py:122",
              source="wacv23_tsnet_tpu_torch/csrc/conv3x3_in.cu")
    return {
        "fuse_pair_conv2": dict(
            kernel=lambda: fk.fuse_pair_conv2(c1a, c1t, w2),
            plain=lambda: fk.fuse_pair_conv2_plain(c1a, c1t, w2),
            tol=K6_TOL, peak=BF16_TC_FLOP_PER_S,
            bytes=2 * (c1a.numel() + c1t.numel() + w2.numel()
                       + s * f * n * k),
            flops=2 * s * f * n * 9 * k * k,
            conv_alone=conv_alone(s * f, k, k, h, w, g), tier=FUSED_TIER,
            launch="fuse_pair_conv2",
            replaces="wacv23_tsnet_tpu/ops/pallas_fuse.py:124",
            source="wacv23_tsnet_tpu_torch/csrc/fuse_pair_conv2.cu"),
        "conv3x3_in": dict(
            k7, kernel=lambda: ck.conv3x3_in(x, wc, relu=True),
            plain=lambda: ck.conv3x3_in_plain(x, wc, relu=True),
            bytes=2 * (2 * x.numel() + wc.numel()), tier=FUSED_TIER),
        "conv3x3_in_skip": dict(
            k7, kernel=lambda: ck.conv3x3_in(x, wc, skip=skip, relu=False),
            plain=lambda: ck.conv3x3_in_plain(x, wc, skip=skip, relu=False),
            bytes=2 * (3 * x.numel() + wc.numel()), tier=None),
    }


def device_breakdown(forward, tier: str, top: int = 12) -> dict:
    """Device time of one call by kernel (torch.profiler/CUPTI): the time
    some kernel ran, its share of the same profiled call's host-clock
    time, and the kernels that take the most."""
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages() if e.device_type == cuda]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    # busy time: the union of the kernels' intervals, so that kernels
    # that overlap (another stream) are not counted twice
    busy_us, last_end = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in prof.events() if e.device_type == cuda):
        if end > last_end:
            busy_us += end - max(start, last_end)
            last_end = end
    for e in rows[:top]:
        print(f"[profile] {tier}: {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:110]}")
    return {"device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / wall_s}


def stage_ms(mods, src, tar_lbl, tar_bbox, fused: bool = False) -> dict:
    """CUDA-event ms of each stage of one clip forward, made stage by stage
    with the calls `tsnet_forward_clip` makes (models/tsnet.py); `fused`
    as its `fused_blocks` (K6 follows the environment, as in fuse_clip)."""
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    with torch.inference_mode():
        mark("start")
        pack = encode_sources(mods, *src)
        mark("encode_sources")
        tar_fea = mods.lbl_enc(tar_lbl.to(mods.dtype))
        tar_fea_n = l2_normalize(tar_fea.float())
        h, w = tar_fea.shape[1:3]
        tar_mask = resize_nearest(tar_bbox[..., None], (h, w))[..., 0]
        mark("lbl_enc")
        warp_in = (pack["fea"].float(), pack["fea_n"], pack["mask"],
                   tar_fea_n, tar_mask)
        if mods.dec.dtype == torch.bfloat16:
            prop = transformation_warp_clip_mean(*warp_in,
                                                 out_dtype=torch.bfloat16)
        else:
            prop = transformation_warp_clip(*warp_in).mean(dim=0)
        mark("transformation")
        syn = fuse_clip(mods.fuse_net, pack["fea"].float(), tar_fea.float())
        mark("fuse_clip")
        mods.dec(prop, syn, fused_blocks=fused).float()
        mark("decoder")
    torch.cuda.synchronize()
    return {name: marks[i - 1][1].elapsed_time(ev)
            for i, (name, ev) in enumerate(marks) if i}


@contextlib.contextmanager
def fuse_pair_kernel(on: bool):
    """TSNET_FUSE_PAIR_KERNEL set to "1" (on) or unset (off) in this
    process, as it was afterwards."""
    old = os.environ.pop(FUSE_ENV, None)
    if on:
        os.environ[FUSE_ENV] = "1"
    try:
        yield
    finally:
        os.environ.pop(FUSE_ENV, None)
        if old is not None:
            os.environ[FUSE_ENV] = old


def tier_perf(tier: str, mods, forward, request, request_key: str, src,
              tar_lbl, tar_bbox, line: str, fused: bool = False) -> dict:
    """Clip ms and frames/s (3 clips), one request's ms, peak memory, the
    stage split and a profile of one clip; prints `[perf]` and `[fps]`."""
    res = {}
    iters = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        forward()
    torch.cuda.synchronize()
    res["clip_ms"] = 1e3 * (time.perf_counter() - t0) / iters
    res["fps"] = CLIP_FRAMES / (res["clip_ms"] / 1e3)
    t0 = time.perf_counter()
    request()
    res[request_key] = 1e3 * (time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    forward()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["stage_ms"] = stage_ms(mods, src, tar_lbl, tar_bbox, fused)
    res.update(device_breakdown(forward, tier))
    print(f"[perf] {tier}: " + json.dumps({k: res[k] for k in (
        "clip_ms", "fps", request_key, "peak_mem_gb", "stage_ms",
        "device_busy_ms", "device_busy_share")}), flush=True)
    print(f"[fps] {tier}: {res['fps']:.2f} frames/s "
          f"({CLIP_FRAMES}-frame clip, {res['clip_ms']:.2f} ms) on {line}",
          flush=True)
    return res


def main_path(line: str) -> dict:
    """Full-width face clip inference and sessions, both tiers, then the
    bench tier with the fused tail."""
    base = face_config()
    bench = dataclasses.replace(base, precision="high", fast_tail=True,
                                fast_trunk=True)
    tiers = {
        "bit-parity": (base, "transform_warp_pairs_nf",
                       "transform_warp_pairs_mean"),
        "bench": (bench, "transform_warp_pairs_mean",
                  "transform_warp_pairs_nf"),
    }
    rng = np.random.default_rng(0)
    s, hw, nl = base.n_source, base.image_size, base.label_nc
    dev = torch.device("cuda")
    src = (torch.as_tensor(rng.random((s, hw, hw, 3), np.float32), device=dev),
           torch.as_tensor(rng.integers(0, 2, (s, hw, hw, nl)).astype(
               np.float32), device=dev),
           torch.as_tensor(rng.integers(0, 2, (s, hw, hw)).astype(np.float32),
                           device=dev))
    tar_lbl = torch.as_tensor(rng.integers(0, 2, (CLIP_FRAMES, hw, hw, nl))
                              .astype(np.float32), device=dev)
    tar_bbox = torch.as_tensor(rng.integers(0, 2, (CLIP_FRAMES, hw, hw))
                               .astype(np.float32), device=dev)
    report, outputs, features = {}, {}, {}
    for tier, (cfg, warp_kernel, other_kernel) in tiers.items():
        mods = TSNetModules(cfg, device="cuda", seed=0)
        forward = lambda: tsnet_forward_clip(mods, *src, tar_lbl, tar_bbox)
        with fuse_pair_kernel(False):
            forward()                                # warm-up (cuDNN plans)
            torch.cuda.synchronize()

            cuda_build.reset_launches()
            t0 = time.perf_counter()
            out = forward()
            sess = RetargetSession(mods, *src, chunk=CHUNK)
            pushed = [sess.push_labels(tar_lbl[lo:lo + CHUNK],
                                       tar_bbox[lo:lo + CHUNK])
                      for lo in (0, CHUNK, 0)]
            disp = RetargetSession(mods, *src, chunk=CHUNK, output="display")
            shown = disp.push_labels(tar_lbl[CHUNK:], tar_bbox[CHUNK:])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = dict(cuda_build.LAUNCHES)

            check(tuple(out.shape) == (CLIP_FRAMES, hw, hw, 3),
                  f"{tier}: shape")
            check(bool(torch.isfinite(out).all()), f"{tier}: non-finite output")
            check(launches[warp_kernel] > 0
                  and launches["instance_norm_mean"] > 0,
                  f"{tier}: kernels not launched on the main path: {launches}")
            check(launches[other_kernel] == 0
                  and launches["fuse_pair_conv2"] == 0
                  and launches["conv3x3_in"] == 0,
                  f"{tier}: launched another tier's kernel: {launches}")

            plain = tsnet_forward_clip(mods, *src, tar_lbl, tar_bbox,
                                       use_kernels=False)
            diff = (out - plain).abs()
            # the session chunks frames by 32: compare with the clip forward
            # over the same 32-frame chunks (cuDNN picks its algorithms, and
            # so its rounding, by batch size); the 64-frame batch is
            # compared too, as the batch-size drift of the tier
            chunked = torch.cat([tsnet_forward_clip(mods, *src,
                                                    tar_lbl[lo:lo + CHUNK],
                                                    tar_bbox[lo:lo + CHUNK])
                                 for lo in (0, CHUNK)]).cpu().numpy()
            sess_diff = np.abs(np.concatenate(pushed[:2]) - chunked)
            batch_diff = np.abs(chunked - out.cpu().numpy())
            # the display session answered the same frames, at the same
            # chunk size, as the second model-output request
            want_u8 = np.clip(np.round(pushed[1] * 255.0
                                       + base.img_mean_array()), 0, 255)
            res = {"launches": launches, "main_path_s": run_s,
                   "vs_plain_max_abs": diff.max().item(),
                   "vs_plain_mean_abs": diff.mean().item(),
                   "session_vs_clip_max_abs": float(sess_diff.max()),
                   "session_vs_clip_mean_abs": float(sess_diff.mean()),
                   "batch64_vs_batch32_max_abs": float(batch_diff.max()),
                   "batch64_vs_batch32_mean_abs": float(batch_diff.mean()),
                   "display_vs_model_max_levels": float(np.abs(
                       shown.astype(np.float64) - want_u8).max())}
            print(f"[main] {tier}: {json.dumps(res)}", flush=True)
            # tier tolerances: bit-parity 1e-3 max abs; bench 0.01 mean L1
            # (QUIRKS.md budget of the JAX package's fast tiers)
            key, tol = (("max_abs", 1e-3) if tier == "bit-parity"
                        else ("mean_abs", 0.01))
            check(res[f"vs_plain_{key}"] <= tol,
                  f"{tier}: kernel path vs plain path")
            check(res[f"session_vs_clip_{key}"] <= tol,
                  f"{tier}: session frames vs the clip forward")
            frame = (CHUNK, hw, hw, 3)
            check(all(p.shape == frame for p in pushed)
                  and shown.shape == frame and shown.dtype == np.uint8,
                  f"{tier}: session output shapes")
            check(np.isfinite(np.stack(pushed)).all(),
                  f"{tier}: session non-finite")
            check(res["display_vs_model_max_levels"] <= 1.0,
                  f"{tier}: display frames vs model-space frames")

            res.update(tier_perf(
                tier, mods, forward,
                lambda: sess.push_labels(tar_lbl[:CHUNK], tar_bbox[:CHUNK]),
                "session_request_ms", src, tar_lbl, tar_bbox, line))
        report[tier] = res
        outputs[tier] = out.cpu()
        features[tier] = encode_sources(mods, *src)["fea"].float().cpu()
        del mods, out, plain
        torch.cuda.empty_cache()
    report[FUSED_TIER] = fused_tier(line, bench, src, tar_lbl, tar_bbox,
                                    outputs["bench"], report["bench"])
    # how far the bench tier's shortcuts move the output (random weights),
    # and how much of that is the bf16 tail alone (no fast_trunk)
    tail = TSNetModules(dataclasses.replace(base, precision="high",
                                            fast_tail=True), seed=0)
    with fuse_pair_kernel(False):
        outputs["high+fast_tail"] = tsnet_forward_clip(tail, *src, tar_lbl,
                                                       tar_bbox).cpu()
    features["high+fast_tail"] = encode_sources(tail, *src)["fea"].float().cpu()
    ref_fea = features["bit-parity"]
    for name in ("bench", "high+fast_tail"):
        drift = (outputs[name] - outputs["bit-parity"]).abs()
        fea_rel = ((features[name] - ref_fea).norm() / ref_fea.norm()).item()
        print(f"[tiers] {name} vs bit-parity on the same clip: mean_abs="
              f"{drift.mean().item():.4e} max_abs={drift.max().item():.4e}; "
              f"source features rel_err={fea_rel:.4e}", flush=True)
    return report


def fused_tier(line: str, cfg, src, tar_lbl, tar_bbox, unfused_out,
               unfused: dict) -> dict:
    """The bench tier with the fused tail: K6 in FuseNet
    (TSNET_FUSE_PAIR_KERNEL=1, set for this tier only) and K7 in the
    decoder (`fused_blocks=True`). A 64-frame clip and two 32-frame
    requests on one source pack, launches counted over the three decode
    calls; held against its plain path and the unfused bench tier."""
    tier = FUSED_TIER
    hw = cfg.image_size
    mods = TSNetModules(cfg, device="cuda", seed=0)

    def forward(use_kernels=True):
        return tsnet_forward_clip(mods, *src, tar_lbl, tar_bbox,
                                  use_kernels=use_kernels, fused_blocks=True)

    def request(pack, lo):
        return decode_with_sources(mods, pack, tar_lbl[lo:lo + CHUNK],
                                   tar_bbox[lo:lo + CHUNK], fused_blocks=True)

    with fuse_pair_kernel(True):
        forward()                                    # warm-up (cuDNN plans)
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        out = forward()
        pack = encode_sources(mods, *src)
        answered = [request(pack, lo) for lo in (0, CHUNK)]
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)

        calls = 1 + len(answered)                    # decode calls
        want = {"transform_warp_pairs_mean": calls, "instance_norm_mean": calls,
                "fuse_pair_conv2": calls,
                "conv3x3_in": 2 * cfg.dec_n_blocks * calls}
        check(all(launches[k] == v for k, v in want.items())
              and sum(launches.values()) == sum(want.values()),
              f"{tier}: launches {launches}, expected {want} and no other")
        check(tuple(out.shape) == (CLIP_FRAMES, hw, hw, 3), f"{tier}: shape")
        check(all(tuple(a.shape) == (CHUNK, hw, hw, 3) for a in answered),
              f"{tier}: request shapes")
        check(bool(torch.isfinite(out).all())
              and all(bool(torch.isfinite(a).all()) for a in answered),
              f"{tier}: non-finite output")

        plain = forward(use_kernels=False)
        diff = (out - plain).abs()
        vs_unfused = (out.cpu() - unfused_out).abs()
        batch_diff = (torch.cat(answered) - out).abs()
        res = {"launches": launches, "main_path_s": run_s,
               "vs_plain_max_abs": diff.max().item(),
               "vs_plain_mean_abs": diff.mean().item(),
               "vs_unfused_bench_max_abs": vs_unfused.max().item(),
               "vs_unfused_bench_mean_abs": vs_unfused.mean().item(),
               "batch64_vs_batch32_max_abs": batch_diff.max().item(),
               "batch64_vs_batch32_mean_abs": batch_diff.mean().item()}
        print(f"[main] {tier}: {json.dumps(res)}", flush=True)
        # the fast tiers' 0.01 mean-L1 budget (QUIRKS.md); against the
        # unfused tier only rounding differs: the attention lies upstream
        check(res["vs_plain_mean_abs"] <= 0.01,
              f"{tier}: kernel path vs plain path")
        check(res["vs_unfused_bench_mean_abs"] <= 0.01,
              f"{tier}: fused tail vs the unfused bench tier")

        res.update(tier_perf(
            tier, mods, forward, lambda: request(pack, 0).cpu(),
            "request_ms", src, tar_lbl, tar_bbox, line, fused=True))
    side = {k: {"bench": unfused["stage_ms"][k], tier: res["stage_ms"][k]}
            for k in ("fuse_clip", "decoder")}
    print(f"[fused-vs-bench] stage_ms {json.dumps(side)}; frames/s bench "
          f"{unfused['fps']:.2f}, {tier} {res['fps']:.2f}; request ms bench "
          f"session {unfused['session_request_ms']:.2f}, {tier} "
          f"{res['request_ms']:.2f}; peak GB bench "
          f"{unfused['peak_mem_gb']:.2f}, {tier} {res['peak_mem_gb']:.2f} | "
          f"{line}", flush=True)
    del mods, out, plain, answered
    torch.cuda.empty_cache()
    return res


def flow_cells(flow, h: int, w: int) -> torch.Tensor:
    """The pixel cell (floor of grid_sample's unnormalised x, y) that each
    flow row (..., 2) samples in an h x w map."""
    return torch.stack([torch.floor(((flow[..., 0] + 1) * w - 1) / 2),
                        torch.floor(((flow[..., 1] + 1) * h - 1) / 2)], -1)


def train_kernel_checks(line: str) -> dict:
    """K3-flow and K4 against their plain versions at the train shape."""
    dev = torch.device("cuda")
    g, ns, nf, h, w, c = TRAIN_BATCH, 3, 1, 32, 32, 512
    t, pairs = h * w, TRAIN_BATCH * 3
    gen = torch.Generator().manual_seed(1)
    src = torch.randn(g, ns, t, c, generator=gen)
    args = tuple(x.to(dev).contiguous() for x in (
        src, l2_normalize(torch.randn(g, nf, t, c, generator=gen)),
        l2_normalize(src), (torch.rand(g, nf, t, generator=gen) > 0.5).float(),
        (torch.rand(g, ns, t, generator=gen) > 0.5).float(),
        normalized_grid(h, w).reshape(t, 2)))
    in_bytes = 4 * (2 * g * ns * t * c + g * nf * t * c + g * ns * t
                    + g * nf * t + 2 * t)
    results = {}

    # K3-flow, temp 100 (the config's)
    fwd = lambda: wk.transform_warp_pairs_fwd(*args, h, w)  # noqa: E731
    plain = lambda: wk.transform_warp_pairs_plain(*args, h, w)  # noqa: E731
    got, want = fwd(), plain()
    torch.cuda.synchronize()
    errs = [compare(a, b, TOL["f32"]) for a, b in zip(got[:2], want[:2])]
    res = {k: max(e[k] for e in errs) for k in errs[0]}
    check(res["worst_err_over_tol"] <= 1.0,
          f"transform_warp_pairs disagrees with its plain version: {errs}")
    res["ms"] = time_ms(fwd)
    res["plain_ms"] = time_ms(plain, iters=3)
    res["bound_ms"], res["bound_by"] = bound(
        in_bytes + 4 * pairs * t * (c + 3),
        pairs * t * (2 * t * c + 10 * t + 8 * c))
    res.update(replaces="wacv23_tsnet_tpu/ops/pallas_similarity.py:262",
               source="wacv23_tsnet_tpu_torch/csrc/transform_warp.cu")
    results["transform_warp_pairs"] = res
    print(f"[kernel] transform_warp_pairs (K3-flow, warped + flow, temp 100):"
          f" max_abs_err={res['max_abs_err']:.3e} "
          f"mean_abs_err={res['mean_abs_err']:.3e} (atol, rtol)="
          f"{TOL['f32']} kernel_ms={res['ms']:.4f} "
          f"plain_ms={res['plain_ms']:.4f} library_ms=none "
          f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}) | {line}",
          flush=True)

    # K4: six cotangents, against autograd through the plain forward in
    # fp32 and in float64 (the exact reference), at temp 10 and 100
    gw = torch.randn(g, ns, nf, t, c, generator=gen).to(dev)
    gf = torch.randn(g, ns, nf, t, 2, generator=gen).to(dev)
    names = ("src_fea", "tar_fea_n", "src_fea_n", "tar_mask", "src_mask",
             "grid")

    def rel_err(got, want):
        return {n: ((a.double() - b.double()).abs().max()
                    / max(1.0, b.abs().max().item())).item()
                for n, a, b in zip(names, got, want)}

    for temp in (10.0, 100.0):
        _, flow, lse = wk.transform_warp_pairs_fwd(*args, h, w, temp)
        bwd = lambda: wk.transform_warp_pairs_bwd(  # noqa: E731
            *args, flow, lse, gw, gf, h, w, temp)
        got = bwd()
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(x).all()) for x in got),
              f"transform_warp_pairs_bwd: non-finite cotangent at temp {temp}")
        want = wk.transform_warp_pairs_bwd_plain(*args, gw, gf, h, w, temp)
        exact = wk.transform_warp_pairs_bwd_plain(*args, gw, gf, h, w, temp,
                                                  dtype=torch.float64)
        flow64 = wk.transform_warp_pairs_plain(*args, h, w, temp,
                                               dtype=torch.float64)[1]
        _, flow32, lse32 = wk.transform_warp_pairs_plain(*args, h, w, temp)
        # K4 given the plain version's own flow and lse, which the plain
        # backward differentiates at: its arithmetic alone
        same_flow = wk.transform_warp_pairs_bwd(*args, flow32, lse32, gw, gf,
                                                h, w, temp)
        # rows whose flow lies in another pixel cell than the exact flow's:
        # the bilinear warp's gradient jumps at a cell edge
        moved = {name: int((flow_cells(f, h, w) != flow_cells(flow64, h, w)
                            ).any(-1).sum())
                 for name, f in (("kernel", flow), ("plain", flow32))}
        rel = {"kernel_vs_plain": rel_err(got, want),
               "kernel_on_plain_flow_vs_plain": rel_err(same_flow, want),
               "kernel_vs_float64": rel_err(got, exact),
               "plain_vs_float64": rel_err(want, exact),
               "rows_in_another_cell_than_float64": moved, "rows": g * ns * t}
        print(f"[kernel] transform_warp_pairs_bwd (K4) temp {temp}: error "
              f"over max(1, max|reference|) per cotangent {json.dumps(rel)}",
              flush=True)
        check(max(rel["kernel_on_plain_flow_vs_plain"].values()) <= BWD_RTOL,
              f"transform_warp_pairs_bwd disagrees with its plain version "
              f"given the same flow at temp {temp}: {rel}")
        if temp == 10.0:
            check(max(rel["kernel_vs_plain"].values()) <= BWD_RTOL
                  and max(rel["kernel_vs_float64"].values()) <= BWD_RTOL,
                  f"transform_warp_pairs_bwd disagrees with its plain "
                  f"version at temp 10: {rel}")
            res = {"max_abs_err": max((a - b).abs().max().item()
                                      for a, b in zip(got, want)),
                   "rel_err": max(rel["kernel_vs_plain"].values())}
        del want, exact, flow64, flow32, lse32, same_flow
    # timed at the config's temp 100
    res["ms"] = time_ms(bwd)
    res["plain_ms"] = time_ms(lambda: wk.transform_warp_pairs_bwd_plain(
        *args, gw, gf, h, w, temp), iters=3)
    res["bound_ms"], res["bound_by"] = bound(
        in_bytes + 4 * pairs * t * (c + 5)          # flow, lse, gw, gf
        + 4 * (2 * g * ns * t * c + g * nf * t * c + g * ns * t + g * nf * t
               + 2 * t),                             # the six cotangents
        pairs * t * t * (6 * c + 20))
    res.update(replaces="wacv23_tsnet_tpu/ops/pallas_similarity.py:824",
               source="wacv23_tsnet_tpu_torch/csrc/transform_warp_bwd.cu")
    results["transform_warp_pairs_bwd"] = res
    print(f"[kernel] transform_warp_pairs_bwd (K4, six cotangents): "
          f"max_abs_err={res['max_abs_err']:.3e} (temp 10, rtol "
          f"{BWD_RTOL} of max(1, max|plain|)) kernel_ms={res['ms']:.4f} "
          f"plain_ms={res['plain_ms']:.4f} library_ms=none "
          f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}) | {line}",
          flush=True)
    return results


def train_batch(cfg, bs: int, seed: int = 0) -> dict:
    """A random face batch made from a numpy seed, on the card."""
    rng = np.random.default_rng(seed)
    s, hw, nl = cfg.n_source, cfg.image_size, cfg.label_nc
    arrays = {"src_img": rng.random((bs, s, hw, hw, 3), np.float32),
              "src_lbl": rng.integers(0, 2, (bs, s, hw, hw, nl)),
              "src_bbox": rng.integers(0, 2, (bs, s, hw, hw)),
              "tar_img": rng.random((bs, hw, hw, 3), np.float32),
              "tar_lbl": rng.integers(0, 2, (bs, hw, hw, nl)),
              "tar_bbox": rng.integers(0, 2, (bs, hw, hw))}
    return {k: torch.as_tensor(v.astype(np.float32), device="cuda")
            for k, v in arrays.items()}


def grads_of(state, names=GEN_SUBNETS + ("netD",)) -> dict:
    """Each subnet's gradients, flattened into one vector."""
    return {name: torch.cat([p.grad.flatten() for p in
                             getattr(state.mods, name).parameters()
                             if p.grad is not None])
            for name in names}


def generator_vjp(state, batch: dict, rec_ct, use_kernels: bool) -> dict:
    """Each generator subnet's gradient of sum(rec_img * rec_ct) +
    loss_warp + loss_align, from one forward of the state's modules."""
    state.gen_opt.zero_grad(set_to_none=True)
    out = tsnet_forward(state.mods, *(batch[k] for k in FORWARD_KEYS),
                        tar_img=batch["tar_img"], train=True,
                        use_kernels=use_kernels)
    ((out["rec_img"] * rec_ct).sum() + out["loss_warp"]
     + out["loss_align"]).backward()
    return grads_of(state, GEN_SUBNETS)


def train_phase(line: str) -> dict:
    """The GAN train step at the full width of face_config(), batch 15."""
    cfg = face_config()
    torch.cuda.empty_cache()
    batch = train_batch(cfg, TRAIN_BATCH)

    # the first step from one seeded state through the kernels, through
    # the plain versions, and through the plain versions with the input
    # images moved by 1e-6 relative (how far rounding-level input changes
    # move the gradients), at temp 10 and at the config's 100; the
    # temp-100 kernel state goes on into the main path
    gen = torch.Generator().manual_seed(2)
    dev = batch["tar_img"].device
    rec_ct = torch.randn(batch["tar_img"].shape, generator=gen).to(dev)
    nudged = dict(batch)
    for k in ("src_img", "tar_img"):
        nudged[k] = batch[k] * (1 + INPUT_NUDGE * torch.randn(
            batch[k].shape, generator=gen).to(dev))
    paths = {"plain": (False, batch), "nudged": (False, nudged),
             "kernel": (True, batch)}
    for temp in (10.0, cfg.softmax_temp):
        tcfg = dataclasses.replace(cfg, softmax_temp=temp)
        runs = {}
        for name, (use_kernels, data) in paths.items():
            state = create_train_state(tcfg, device="cuda", seed=0)
            with torch.no_grad():
                flows = tsnet_forward(state.mods, *(data[k] for k in
                                                    FORWARD_KEYS),
                                      use_kernels=use_kernels,
                                      return_flow=True)["flows"]
            vjp = generator_vjp(state, data, rec_ct, use_kernels)
            step = make_train_step(state, use_kernels=use_kernels)
            cuda_build.reset_launches()
            _, metrics, _ = step(state, data, TRAIN_LR)
            torch.cuda.synchronize()
            launches = dict(cuda_build.LAUNCHES)
            check(all(launches[k] == int(use_kernels) for k in TRAIN_KERNELS)
                  and sum(launches.values()) == 3 * int(use_kernels),
                  f"train: first step's launches on the {name} path: "
                  f"{launches}")
            runs[name] = {"metrics": {k: v.item() for k, v in metrics.items()},
                          "step": grads_of(state), "vjp": vjp, "flows": flows}
            if not (use_kernels and temp == cfg.softmax_temp):
                del state, step
                torch.cuda.empty_cache()

        def rel_l2(name, kind):
            return {k: ((v - runs["plain"][kind][k]).norm()
                        / runs["plain"][kind][k].norm()).item()
                    for k, v in runs[name][kind].items()}

        mp = runs["plain"]["metrics"]
        err = {"metrics": {k: abs(v - mp[k]) / max(1.0, abs(mp[k]))
                           for k, v in runs["kernel"]["metrics"].items()}}
        for name in ("kernel", "nudged"):
            for kind in ("step", "vjp"):
                err[f"{name}_{kind}"] = rel_l2(name, kind)
            # flow rows in another pixel cell than on the plain path (the
            # warps' gradients jump at a cell edge)
            fh, fw = runs[name]["flows"].shape[2:4]
            err[f"{name}_flow_rows_in_another_cell"] = int((
                flow_cells(runs[name]["flows"], fh, fw)
                != flow_cells(runs["plain"]["flows"], fh, fw)).any(-1).sum())
        del runs
        print(f"[train] first step at temp {temp}, kernel path and nudged "
              f"plain path vs plain path (gradients relative L2; vjp: the "
              f"generator's given one cotangent): {json.dumps(err)}",
              flush=True)
        check(max(err["metrics"].values()) <= STEP_METRIC_RTOL,
              f"train: first-step metrics at temp {temp}, kernel vs plain "
              f"path: {err['metrics']}")
        check(err["kernel_step"]["netD"] <= STEP_GRAD_RTOL,
              f"train: first-step netD gradient at temp {temp}, kernel vs "
              f"plain path: {err['kernel_step']}")
        for kind in ("step", "vjp"):
            worst = {k: v for k, v in err[f"kernel_{kind}"].items()
                     if v > max(STEP_GRAD_RTOL,
                                NUDGE_MARGIN * err[f"nudged_{kind}"][k])}
            check(not worst, f"train: first-step {kind} gradients at temp "
                  f"{temp}, kernel vs plain path, beyond the nudged path's "
                  f"spread: {worst}")

    # the main path: TRAIN_STEPS steps on the fixed batch
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    history, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        _, metrics, rec = step(state, batch, TRAIN_LR)
        history.append({k: v.item() for k, v in metrics.items()})
        step_ms.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    check(all(per_step[k] == 1 for k in TRAIN_KERNELS),
          f"train: launches per step {per_step}")
    check(all(per_step[k] == 0 for k in (
        "transform_warp_pairs_mean", "transform_warp_pairs_nf",
        "fuse_pair_conv2", "conv3x3_in")),
          f"train: launched an inference kernel: {per_step}")
    check(all(np.isfinite(v) for h in history for v in h.values()),
          "train: non-finite metric")
    check(tuple(rec.shape) == (TRAIN_BATCH, cfg.image_size, cfg.image_size, 3),
          "train: reconstruction shape")
    vgg = [h["G_VGG"] for h in history]
    check(np.mean(vgg[-5:]) < np.mean(vgg[:5]),
          f"train: G_VGG did not fall: {vgg}")
    # ms/step without the first (its host-side allocations settle)
    ms = float(np.mean(step_ms[1:]))
    print(f"[train] {TRAIN_STEPS} steps at batch {TRAIN_BATCH}: "
          f"{ms:.2f} ms/step, {TRAIN_BATCH / ms * 1e3:.2f} samples/s, peak "
          f"memory {peak_gb:.2f} GB; G_VGG first5 {np.mean(vgg[:5]):.4f} "
          f"last5 {np.mean(vgg[-5:]):.4f}; D first5 "
          f"{np.mean([h['D'] for h in history[:5]]):.4f} last5 "
          f"{np.mean([h['D'] for h in history[-5:]]):.4f}; launches per step "
          f"{json.dumps(per_step)} | {line}", flush=True)
    print(f"[train] metrics of the last step: {json.dumps(history[-1])}",
          flush=True)

    # CUDA-event stage split of one more step, then a profile of one
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    timed = make_train_step(state, mark=mark)
    mark("start")
    timed(state, batch, TRAIN_LR)
    torch.cuda.synchronize()
    stages = {name: marks[i - 1][1].elapsed_time(ev)
              for i, (name, ev) in enumerate(marks) if i}
    split = {"g_forward": stages["g_forward"], "d_phase": stages["d_phase"],
             "g_loss_backward": stages["g_loss_backward"],
             "optimizer_steps": stages["d_opt"] + stages["g_opt"]}
    print(f"[train] stage split (CUDA events, ms): {json.dumps(split)} | "
          f"{line}", flush=True)
    prof = device_breakdown(lambda: step(state, batch, TRAIN_LR), "train",
                            top=15)
    print(f"[train] profile of one step: {json.dumps(prof)} | {line}",
          flush=True)
    return {"launches": launches, "ms_per_step": ms,
            "samples_per_s": TRAIN_BATCH / ms * 1e3, "peak_mem_gb": peak_gb,
            "stage_ms": split, **prof}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    line = gpu_line()
    print(f"[card] {line}", flush=True)
    print(f"[versions] python {sys.version.split()[0]} "
          f"torch {torch.__version__}"
          f" cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    per_source = cuda_build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s wall, per source "
          f"{json.dumps(per_source)}", flush=True)
    for name in cuda_build.SOURCES:
        log = cuda_build.library_path(name).with_suffix(".log").read_text()
        for text in log.splitlines():
            if "Used" in text or "spill" in text:
                print(f"[ptxas] {name}: {text.strip()}")

    kernels = kernel_checks(line)
    train_kernels = train_kernel_checks(line)
    report = main_path(line)
    report["train"] = train_phase(line)

    rows = []
    for name, k in train_kernels.items():
        kernels[name] = dict(k, tier="train")
    for name, k in kernels.items():
        # K2 is one kernel: its row is the f32 form, on the bit-parity
        # clip path (the bf16 form is checked and printed above); K7's row
        # is its relu form (the skip form is checked and printed above)
        if k.get("tier") is None or name == "instance_norm_mean_bf16":
            continue
        rows.append({
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": report[k["tier"]]["launches"][
                "instance_norm_mean" if name.startswith("instance_norm")
                else k.get("launch", name)],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
