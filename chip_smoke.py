#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`wacv23_tsnet_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU, nvcc and the repository around it; exits
non-zero, printing no result, where CUDA or the package is missing.

1. Prints the card's name and power limit and the torch/CUDA versions.
2. Builds every CUDA kernel from `wacv23_tsnet_tpu_torch/csrc/` (one nvcc
   per source, all started together) and prints ptxas's resource lines,
   and the sha256 of K6's output bits on seeded inputs.
3. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (S=3 sources, T=32x32 pixels, C=512, F=32 frames;
   K2 at (3, 32, 32, 32, 1024) and, past its cluster, (3, 8, 64, 64,
   1024); K6 at S=3, F=32, 32x32, K=1024; K7 with relu and with skip at
   (32, 32, 32, 512), and at the clip's B=64), and times both with CUDA
   events; for K6 and K7 also cuDNN's bf16 conv alone, as a yardstick;
   for K6 its two launches (statistics, conv) each alone, for K7 and K2
   the launches of their two-pass paths each alone, and what one call
   launches by CUDA kernel (a torch.profiler trace) with its cluster.
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
   given the plain version's own flow; two calls the same bits outside
   da; its five launches, warp_bwd, logits, gtn, gsn and reduce, each
   timed alone).
6. Drives the GAN train step (`train.make_train_step`) at the full width
   of `face_config()`, bit-parity tier, batch 15: the first step from one
   seeded state through the kernels and through the plain versions
   (metrics and per-subnet gradients compared, at temp 10 and at the
   config's 100), then 20 steps on a fixed
   batch with the launch counts zeroed just before and read just after
   (one K3-flow, one K4 and one K2 a step; no inference kernel), with
   ms/step, samples/s, the CUDA-event stage split, peak memory and a
   profile; the metrics must stay finite and G_VGG must fall.
7. Serves from a saved model (`[serve]`): the train state after those
   steps saved as a trainer snapshot (flax msgpack, the JAX package's
   format) and restored into a fresh state bit for bit (parameters, Adam
   moments, step counts, step), the generator saved as a reference `.pth`
   and loaded back bit for bit; the keypoint rasterizer on the card held
   against its CPU run and timed a 32-frame chunk; then in the bench tier
   (the CLI's defaults) and the bit-parity tier, the snapshot loaded by
   `cli.demo_face.load_params` and served by `cli.serve.Server` on
   127.0.0.1 from a thread: a session of 3 references, a 64-frame base64
   keypoint request with the launch counts zeroed just before and read
   just after (one K1 and one K2 a chunk in bench, one K3-nf and one K2
   in bit-parity, nothing else), five timed 32-frame requests (client
   wall and server ms, peak memory) and a 2-frame int-list request, all
   within 1 LSB of an in-process `push_keypoints`, and the model-space
   kernel path against the plain path (bit-parity <=1e-3 max abs, bench
   <=0.01 mean L1). Two frames decoded alone against the same frames in
   a 32-frame chunk, on the kernel path (held to the same limit) and on
   the plain path (printed beside it). One 32-frame request split into
   its stages, each timed alone (rasterize, extent bbox, decode, copy
   back, RGB copy, base64, JSON both ways), and profiled: its CUDA
   launches and the device's busy share. Files go to a temporary
   directory in the checkout.
8. Drives the two kernels that no model path reaches through their own
   entry points at full width, launch counts zeroed just before each call
   and read just after (exactly one launch a call): K5 through
   `transformation_warp(use_kernels=True)` at B=15, 32x32, C=512 (temps
   100 and 10; flow and warped output against the plain path; the five
   input gradients under a fixed flow cotangent; SDPA on the mask-folded
   inputs as a yardstick), and K8 `instance_norm_fused` at
   (32, 256, 256, 64) and, with `phase_groups=4`, (32, 128, 128, 256), in
   bf16 and f32, relu on and off (the path its planner chose and its
   cluster; against its plain version, and so is its three-launch path,
   forced, with its launches timed apart; the phase identity with
   `space_to_depth`; `F.instance_norm` on the NCHW or the (B, C/G, N*G)
   view as a yardstick).
9. Prints one `kernels` JSON line, the card line again, and last
   `{"ok": true, "device": {...}}`.

    python3 chip_smoke.py --parts

prints only what one call of K7 and of K2 launches at the main paths'
shapes and of K8 at its two standalone shapes, by CUDA kernel, and K6's
output bits, and

    python3 chip_smoke.py --requests

only the median of ten 32-frame session requests in the bit-parity and
bench tiers (the main run times one request, after its kernel checks);
both through entry points that every version of the port has, so that
loaded beside an earlier tree's package they read that tree the same way.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend
from torch.profiler import ProfilerActivity, profile

from wacv23_tsnet_tpu_torch.cli.demo_face import load_params
from wacv23_tsnet_tpu_torch.cli.serve import Server, make_handler
from wacv23_tsnet_tpu_torch.compat import (export_flax_params,
                                           save_reference_checkpoint)
from wacv23_tsnet_tpu_torch.configs import face_config
from wacv23_tsnet_tpu_torch.data.rasterize_device import rasterize_face_clip
from wacv23_tsnet_tpu_torch.infer import RetargetSession
from wacv23_tsnet_tpu_torch.models import (TSNetModules, tsnet_forward,
                                           tsnet_forward_clip)
from wacv23_tsnet_tpu_torch.models.tsnet import (decode_with_sources,
                                                 encode_sources)
from wacv23_tsnet_tpu_torch.nn import fuse_clip
from wacv23_tsnet_tpu_torch.ops import conv_kernels as ck
from wacv23_tsnet_tpu_torch.ops import cuda_build
from wacv23_tsnet_tpu_torch.ops import flow_kernels as fl
from wacv23_tsnet_tpu_torch.ops import fuse_kernels as fk
from wacv23_tsnet_tpu_torch.ops import norm_kernels as nk
from wacv23_tsnet_tpu_torch.ops import warp_kernels as wk
from wacv23_tsnet_tpu_torch.ops.coords import normalized_grid
from wacv23_tsnet_tpu_torch.ops.norms import l2_normalize
from wacv23_tsnet_tpu_torch.ops.precision import tf32
from wacv23_tsnet_tpu_torch.ops.resize import resize_nearest
from wacv23_tsnet_tpu_torch.ops.similarity import (
    transformation_warp, transformation_warp_clip,
    transformation_warp_clip_mean)
from wacv23_tsnet_tpu_torch.ops.warp import space_to_depth
from wacv23_tsnet_tpu_torch.train import (GEN_SUBNETS, create_train_state,
                                          find_latest_checkpoint,
                                          make_train_step,
                                          restore_checkpoint,
                                          save_checkpoint)

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
# K5 and K8: no model path reaches them, in either package; each is driven
# through its own entry point (flow_phase, norm_phase)
STANDALONE_KERNELS = ("masked_attention_flow_fused", "instance_norm_fused")
STANDALONE = "standalone"
# K5's five input gradients, kernel path against plain path: the backward
# recomputes the plain composition, so they differ by rounding at most
FLOW_GRAD_RTOL = 1e-6
# K8 at the decoder's last up stage for one 32-frame request, and its 2x2
# phase layout (phase_groups=4)
K8_SHAPES = {1: (32, 256, 256, 64), 4: (32, 128, 128, 256)}
FORWARD_KEYS = ("src_img", "src_lbl", "src_bbox", "tar_lbl", "tar_bbox")
# the serve phase: a 64-frame base64 request in two 32-frame chunks, then
# SERVE_REPEATS timed 32-frame requests and a 2-frame int-list request
SERVE_FRAMES = 64
SERVE_REPEATS = 5
SERVE_KERNELS = {"bench": "transform_warp_pairs_mean",
                 "bit-parity": "transform_warp_pairs_nf"}


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


def parts_ms(launch, phases, prefix: str = "") -> dict:
    """CUDA-event ms of each launch of one kernel call, run alone:
    launch(1 << i) runs the launch named phases[i]."""
    return {prefix + name: time_ms(lambda i=i: launch(1 << i))
            for i, name in enumerate(phases)}


def device_parts(call, iters: int = 5) -> dict:
    """What one call of `call` launches on the card, by CUDA kernel: the
    device ms of one launch and the launches per call, from a
    torch.profiler trace of `iters` calls (a trace may miss a launch's
    record, so the ms are taken per launch traced)."""
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    parts = {}
    for e in prof.key_averages():
        if e.device_type == cuda and e.self_device_time_total > 0:
            name = re.sub(r"\(anonymous namespace\)::|^void ", "",
                          e.key).split("(")[0][:48]
            parts[name] = {"ms": e.self_device_time_total / 1e3 / e.count,
                           "launches": e.count / iters}
    return parts


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


def ptxas_resources(name: str) -> list[dict]:
    """Registers a thread, static shared memory and spill bytes of each
    kernel of `csrc/<name>.cu`, from ptxas's log beside its library."""
    log = cuda_build.library_path(name).with_suffix(".log").read_text()
    rows = []
    for text in log.splitlines():
        if "Compiling entry function" in text:
            rows.append({"kernel": text.split("'")[1]})
        elif rows and "spill stores" in text:
            rows[-1].update({f"spill_{kind}_bytes": int(n) for n, kind in
                             re.findall(r"(\d+) bytes spill (\w+)", text)})
        elif rows and "Used" in text:
            regs = re.search(r"Used (\d+) registers", text)
            smem = re.search(r"(\d+) bytes smem", text)
            rows[-1].update(registers=int(regs.group(1)) if regs else None,
                            smem_bytes=int(smem.group(1)) if smem else 0)
    names = subprocess.run(["c++filt"], input="\n".join(
        r["kernel"] for r in rows), capture_output=True, text=True)
    if names.returncode == 0:
        for r, full in zip(rows, names.stdout.splitlines()):
            r["kernel"] = full.replace("(anonymous namespace)::", "").split(
                "(", 1)[0].removeprefix("void ")
    return rows


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
            k2_case(x32, IN_TOL["f32"]), tier="bit-parity"),
    }
    x16 = x32.to(torch.bfloat16)
    cases["instance_norm_mean_bf16"] = dict(k2_case(x16, IN_TOL["bf16"]),
                                            tier="bench")
    # a 64 x 64 plane: 32 tiles, past the cluster (the two-pass path)
    cases["instance_norm_mean_64x64_f32"] = k2_case(
        (torch.randn(s, 8, 64, 64, 2 * c, generator=g) * 2 + 1).to(dev),
        IN_TOL["f32"])
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
        if "parts" in case:  # the launches of one call, each timed alone
            res["parts_ms"] = case["parts"]()
            yardstick += f" parts_ms={json.dumps(res['parts_ms'])}"
        if "profile" in case:  # what one call launches, by CUDA kernel
            res["device_parts"] = device_parts(case["kernel"])
            yardstick += (f" cluster={case['cluster']} device_parts="
                          f"{json.dumps(res['device_parts'])}")
        if "conv_alone" in case:
            res["conv_alone_ms"] = time_ms(case["conv_alone"])
            yardstick += (f" conv_alone_ms={res['conv_alone_ms']:.4f} (cuDNN "
                         "bf16 3x3 conv alone on a pre-padded input, "
                         "yardstick only)")
        results[name] = res
        print(f"[kernel] {name}: max_abs_err={res['max_abs_err']:.3e} "
              f"mean_abs_err={res['mean_abs_err']:.3e} "
              f"(atol, rtol)={case['tol']} "
              f"worst_err_over_tol={res['worst_err_over_tol']:.3f} "
              f"kernel_ms={res['ms']:.4f} "
              f"plain_ms={res['plain_ms']:.4f} library_ms=none "
              f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}) "
              f"bound_share={res['bound_ms'] / res['ms']:.4f}"
              f"{yardstick} | {line}", flush=True)
    torch.cuda.synchronize()
    return results


def k2_case(x, tol) -> dict:
    """K2 on x (S, F, H, W, C), against its plain version in fp32; its
    two-pass path's launches timed apart (forced at any plane)."""
    s, f, h, w, c = x.shape
    nbytes = x.numel() * x.element_size()
    return dict(
        kernel=lambda: nk.instance_norm_mean(x),
        plain=lambda: nk.instance_norm_mean_plain(x, out_dtype=torch.float32),
        parts=lambda: parts_ms(nk.launcher(x, two_pass=True)[0], nk.PHASES,
                               "two_pass_"),
        profile=True, tol=tol, bytes=nbytes + nbytes // s,
        flops=7 * x.numel(), launch="instance_norm_mean", tier=None,
        cluster=(f"{nk.mean_tiles(h, w)} blocks"
                 if nk.mean_tiles(h, w) <= nk.MAX_CLUSTER else "none (two-pass)"),
        replaces="wacv23_tsnet_tpu/ops/pallas_norms.py:135",
        source="wacv23_tsnet_tpu_torch/csrc/in_mean.cu")


def k7_case(x, wc, skip, relu, g) -> dict:
    """K7 on x (B, H, W, C) with weight wc (relu, or + skip), against its
    plain version; its two-pass path's launches timed apart (forced at
    any plane), cuDNN's conv alone as a yardstick."""
    b, h, w, c = x.shape
    co = wc.shape[0]
    ins = 2 * x.numel() * (1 if skip is None else 2)
    return dict(
        kernel=lambda: ck.conv3x3_in(x, wc, skip=skip, relu=relu),
        plain=lambda: ck.conv3x3_in_plain(x, wc, skip=skip, relu=relu),
        parts=lambda: parts_ms(
            ck.launcher(x, wc, skip=skip, relu=relu, two_pass=True)[0],
            ck.PHASES, "two_pass_"),
        profile=True, tol=TC_TOL, flops=2 * b * h * w * 9 * c * co,
        peak=BF16_TC_FLOP_PER_S, bytes=ins + 2 * (wc.numel() + b * h * w * co),
        conv_alone=conv_alone(b, c, co, h, w, g), launch="conv3x3_in",
        tier=None,
        cluster=(f"{ck.tiles(h, w)} blocks, "
                 f"{ck.max_active_clusters(h, w, co)} clusters at once"),
        replaces="wacv23_tsnet_tpu/ops/pallas_conv.py:122",
        source="wacv23_tsnet_tpu_torch/csrc/conv3x3_in.cu")


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
    x64 = torch.randn(2 * b, h, w, c, generator=g).to(dev, torch.bfloat16)
    return {
        "fuse_pair_conv2": dict(
            kernel=lambda: fk.fuse_pair_conv2(c1a, c1t, w2),
            parts=lambda: parts_ms(fk.launcher(c1a, c1t, w2)[0], fk.PHASES),
            plain=lambda: fk.fuse_pair_conv2_plain(c1a, c1t, w2),
            tol=K6_TOL, peak=BF16_TC_FLOP_PER_S,
            bytes=2 * (c1a.numel() + c1t.numel() + w2.numel()
                       + s * f * n * k),
            flops=2 * s * f * n * 9 * k * k,
            conv_alone=conv_alone(s * f, k, k, h, w, g), tier=FUSED_TIER,
            launch="fuse_pair_conv2",
            replaces="wacv23_tsnet_tpu/ops/pallas_fuse.py:124",
            source="wacv23_tsnet_tpu_torch/csrc/fuse_pair_conv2.cu"),
        "conv3x3_in": dict(k7_case(x, wc, None, True, g), tier=FUSED_TIER),
        "conv3x3_in_skip": k7_case(x, wc, skip, False, g),
        # a 64-frame clip's decoder blocks
        "conv3x3_in_b64": k7_case(x64, wc, None, True, g),
    }


def device_breakdown(forward, tier: str, top: int = 12) -> dict:
    """Device time of one call by kernel (torch.profiler/CUPTI): the time
    some kernel ran, its share of the same profiled call's host-clock
    time, the CUDA launches (kernels, copies, fills), and the kernels
    that take the most."""
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
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda)
    busy_us, last_end = 0.0, float("-inf")
    for start, end in spans:
        if end > last_end:
            busy_us += end - max(start, last_end)
            last_end = end
    for e in rows[:top]:
        print(f"[profile] {tier}: {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:110]}")
    return {"device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / wall_s,
            "profiled_wall_ms": 1e3 * wall_s, "cuda_launches": len(spans)}


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
                  and launches["conv3x3_in"] == 0
                  and all(launches[k] == 0 for k in STANDALONE_KERNELS),
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
          f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}) "
          f"bound_share={res['bound_ms'] / res['ms']:.4f} | {line}",
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
    # two calls give the same bits but in da (a scatter by atomics)
    again = bwd()
    check(all(torch.equal(a, b) for a, b in zip(got[1:], again[1:])),
          "transform_warp_pairs_bwd: two calls differ outside da")
    del again
    # timed at the config's temp 100, the whole call and each launch alone
    res["ms"] = time_ms(bwd)
    launch, _ = wk.bwd_launcher(*args, flow, lse, gw, gf, h, w, temp)
    res["parts_ms"] = parts_ms(launch, wk.BWD_PHASES)
    del launch
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
          f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}) "
          f"bound_share={res['bound_ms'] / res['ms']:.4f} "
          f"parts_ms={json.dumps(res['parts_ms'])} | {line}", flush=True)
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


def train_phase(line: str):
    """The GAN train step at the full width of face_config(), batch 15.
    Returns the report and the state after its steps."""
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
        "fuse_pair_conv2", "conv3x3_in") + STANDALONE_KERNELS),
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
            "stage_ms": split, **prof}, state


def _http(url: str, payload: dict | None = None) -> dict:
    """GET (no payload) or POST JSON to the local server; the reply's
    JSON, which must come with status 200."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        check(resp.status == 200, f"serve: {url} answered {resp.status}")
        return json.loads(resp.read())


def _frames(body: dict) -> np.ndarray:
    if "frames_b64" in body:
        return np.frombuffer(base64.b64decode(body["frames_b64"]),
                             np.uint8).reshape(body["shape"])
    return np.asarray(body["frames"], np.uint8)


def _train_state_equal(a, b) -> list[str]:
    """Names of what differs between two TrainStates: every parameter
    (generator, netD, VGG19), each Adam moment and per-parameter step,
    and the step. A parameter without a gradient (FuseNet's conv2 bias)
    has no torch Adam state in a trained state; restored, it holds optax's
    count and zero moments."""
    bad = [f"param {n}" for (n, p), (_, q) in zip(
        list(a.mods.named_parameters()) + list(a.vgg.named_parameters()),
        list(b.mods.named_parameters()) + list(b.vgg.named_parameters()))
        if not torch.equal(p, q)]
    for tag in ("gen_opt", "disc_opt"):
        oa, ob = getattr(a, tag), getattr(b, tag)
        for ga, gb in zip(oa.param_groups, ob.param_groups):
            for i, (pa, pb) in enumerate(zip(ga["params"], gb["params"])):
                sa, sb = oa.state.get(pa, {}), ob.state.get(pb, {})
                if not sa:
                    if any(sb[k].any() for k in ("exp_avg", "exp_avg_sq")):
                        bad.append(f"{tag} {ga['name']}[{i}] moments")
                    continue
                bad += [f"{tag} {ga['name']}[{i}] {k}" for k in sa
                        if not torch.equal(sa[k], sb[k])]
    if a.step != b.step:
        bad.append("step")
    return bad


def serve_phase(line: str, state) -> dict:
    """Serving from a saved model, at the full width of face_config():
    the train phase's state (20 Adam steps) saved as a trainer snapshot
    and restored bit for bit; the generator saved as a reference `.pth`
    and loaded bit for bit; then, per tier (bench = the CLI's defaults,
    and bit-parity), the snapshot loaded onto the card by `load_params`
    and served by `cli.serve.Server` on 127.0.0.1 from a thread: one
    session, a 64-frame base64 keypoint request (launches counted: one
    warp kernel and one K2 a chunk, nothing else), timed 32-frame
    requests and a 2-frame int-list request, held against an in-process
    `push_keypoints` (1 LSB) and the model-space kernel path against the
    plain path (PERF.md §2's limits). The rasterizer on the card is held
    against its CPU run and timed a 32-frame chunk."""
    cfg = face_config()
    hw = cfg.image_size
    report = {}
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_",
                                     dir=root) as tmp:
        snap = os.path.join(tmp, f"TSNet_S{state.step:06d}.msgpack")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(snap, state)
        report["save_s"] = time.perf_counter() - t0
        report["snapshot_bytes"] = os.path.getsize(snap)
        check(find_latest_checkpoint(tmp) == snap, "serve: latest snapshot")
        fresh = create_train_state(cfg, device="cuda", seed=1)
        t0 = time.perf_counter()
        restore_checkpoint(snap, fresh)
        torch.cuda.synchronize()
        report["restore_s"] = time.perf_counter() - t0
        bad = _train_state_equal(state, fresh)
        check(not bad, f"serve: restored state differs: {bad[:8]}")
        del fresh

        tree = export_flax_params(state.mods)
        pth = os.path.join(tmp, "TSNet_generator.pth")
        t0 = time.perf_counter()
        save_reference_checkpoint(pth, {k: tree[k] for k in GEN_SUBNETS},
                                  cfg, example=state.step)
        report["pth_save_s"] = time.perf_counter() - t0
        report["pth_bytes"] = os.path.getsize(pth)
        t0 = time.perf_counter()
        from_pth = load_params(pth, cfg, device="cuda")
        report["pth_load_s"] = time.perf_counter() - t0
        trained = dict(state.mods.named_parameters())
        bad = [n for n, p in from_pth.named_parameters()
               if not torch.equal(p, trained[n])]
        check(not bad, f"serve: .pth generator differs: {bad[:8]}")
        del from_pth, tree, trained
        torch.cuda.empty_cache()
        print(f"[serve] checkpoints: {json.dumps(report)} | {line}",
              flush=True)

        rng = np.random.default_rng(3)
        s = cfg.n_source
        payload = {"src_img": rng.integers(0, 256, (s, hw, hw, 3)).tolist(),
                   "src_lbl": rng.integers(0, 2, (s, hw, hw)).tolist(),
                   "src_bbox": rng.integers(0, 2, (s, hw, hw)).tolist()}
        kp = rng.uniform(8, hw - 8, (SERVE_FRAMES, 68, 2)).astype(np.float32)

        # the rasterizer on the card against its CPU run, and its time
        kp_dev = torch.as_tensor(kp[:CHUNK], device="cuda")
        ones = torch.ones(CHUNK, device="cuda")
        lbl_dev = rasterize_face_clip(kp_dev, ones, hw, hw).cpu()
        lbl_cpu = rasterize_face_clip(torch.as_tensor(kp[:CHUNK]),
                                      torch.ones(CHUNK), hw, hw)
        differing = int((lbl_dev != lbl_cpu).sum())
        report["rasterizer"] = {
            "pixels_differing_from_cpu": differing,
            "agreement": 1.0 - differing / lbl_cpu.numel(),
            "ms_per_chunk": time_ms(lambda: rasterize_face_clip(
                kp_dev, ones, hw, hw), iters=5)}
        print(f"[serve] rasterizer, {CHUNK} frames at {hw}^2: "
              f"{json.dumps(report['rasterizer'])} | {line}", flush=True)
        check(report["rasterizer"]["agreement"] >= 0.9999,
              "serve: rasterizer on the card vs its CPU run")

        for tier in ("bench", "bit-parity"):
            report[tier] = serve_tier(line, tier, snap, payload, kp)
    return report


def request_stages(server: Server, sid: str, kp: np.ndarray) -> dict:
    """One base64 request of the frames `kp` (one chunk) split into its
    stages as `Server.run_frames` and `push_keypoints` run them, each
    timed alone on the host clock with the card synchronized before and
    after (median ms of SERVE_REPEATS): the client's JSON of the request,
    the server's parse and keypoint array, the upload, the rasterizer,
    the extent bbox, the decode (one-hot, `decode_with_sources`, display
    uint8), the copy back, the RGB copy, base64, the reply's JSON, and
    the client's JSON parse and base64 decode."""
    sess = server.sessions[sid]
    hw = sess.mods.cfg.image_size
    request = {"session": sid, "keypoints": kp.tolist(),
               "encoding": "base64"}
    runs = []
    for _ in range(SERVE_REPEATS):
        t, out = {}, {}

        def stage(name, fn, device=False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = fn()
            if device:
                torch.cuda.synchronize()
            t[name] = 1e3 * (time.perf_counter() - t0)
            return out[name]

        body = stage("client_json_dumps", lambda: json.dumps(request).encode())
        got = stage("server_json_loads", lambda: json.loads(body))
        arr = stage("keypoint_array", lambda: np.asarray(got["keypoints"],
                                                         np.float32))
        with torch.inference_mode():
            k = stage("upload", lambda: torch.as_tensor(arr).to(sess.device),
                      True)
            ones = torch.ones(len(arr), device=sess.device)
            lbl = stage("rasterize", lambda: rasterize_face_clip(
                k, ones, hw, hw), True)
            bbox = stage("extent_bbox", lambda: sess._extent_bbox(
                k[..., 0], k[..., 1], hw), True)
            dec = stage("decode", lambda: sess._decode(lbl, bbox), True)
            rec = stage("copy_back", lambda: dec.cpu().numpy(), True)
        rgb = stage("rgb_copy", lambda: np.ascontiguousarray(rec[..., ::-1]))
        b64 = stage("base64_encode",
                    lambda: base64.b64encode(rgb.tobytes()).decode())
        reply = stage("reply_json_dumps", lambda: json.dumps(
            {"frames_b64": b64, "shape": list(rgb.shape), "dtype": "uint8",
             "ms": 0.0}).encode())
        back = stage("client_json_loads", lambda: json.loads(reply))
        stage("client_base64_decode", lambda: _frames(back))
        check(np.array_equal(out["client_base64_decode"], rgb),
              "serve: stage split's frames")
        runs.append(t)
    return {name: float(np.median([r[name] for r in runs]))
            for name in runs[0]}


def request_profile(server: Server, sid: str, kp: np.ndarray,
                    tier: str) -> dict:
    """`device_breakdown` of one `Server.run_frames` of the frames `kp`
    (one chunk, base64) and of one rasterizer call on them."""
    request = {"session": sid, "keypoints": kp.tolist(),
               "encoding": "base64"}
    hw = server.cfg.image_size
    k = torch.as_tensor(kp, device=server.device)
    ones = torch.ones(len(kp), device=server.device)
    server.run_frames(request)
    return {"request": device_breakdown(lambda: server.run_frames(request),
                                        f"serve {tier}", top=8),
            "rasterize": device_breakdown(lambda: rasterize_face_clip(
                k, ones, hw, hw), f"serve {tier} rasterizer", top=0)}


def serve_tier(line: str, tier: str, snap: str, payload: dict,
               kp: np.ndarray) -> dict:
    """One tier of the serve phase (see `serve_phase`)."""
    base = face_config()
    cfg = (dataclasses.replace(base, precision="high", fast_tail=True,
                               fast_trunk=True) if tier == "bench" else base)
    mods = load_params(snap, cfg, device="cuda")
    server = Server(cfg, mods, chunk=CHUNK)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    res = {}
    try:
        check(_http(url + "/healthz")["backend"] == "cuda",
              f"serve {tier}: healthz backend")
        t0 = time.perf_counter()
        sid = _http(url + "/session", payload)["session"]
        res["session_ms"] = 1e3 * (time.perf_counter() - t0)

        request = {"session": sid, "keypoints": kp.tolist(),
                   "encoding": "base64"}
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        body = _http(url + "/frames", request)
        torch.cuda.synchronize()
        launches = dict(cuda_build.LAUNCHES)
        frames = _frames(body)
        res["launches"] = launches
        res["first_request_server_ms"] = body["ms"]
        chunks = -(-SERVE_FRAMES // CHUNK)
        want = {SERVE_KERNELS[tier]: chunks, "instance_norm_mean": chunks}
        check(all(launches[k] == want.get(k, 0) for k in launches),
              f"serve {tier}: launches {launches}, want {want}")
        check(frames.shape == (SERVE_FRAMES, base.image_size,
                               base.image_size, 3),
              f"serve {tier}: frames shape {frames.shape}")

        # 32-frame requests: client wall (base64 decode included), and
        # the server's ms; peak memory over them
        one = {"session": sid, "keypoints": kp[:CHUNK].tolist(),
               "encoding": "base64"}
        torch.cuda.reset_peak_memory_stats()
        wall, server_ms = [], []
        for _ in range(SERVE_REPEATS):
            t0 = time.perf_counter()
            reply = _http(url + "/frames", one)
            _frames(reply)
            wall.append(1e3 * (time.perf_counter() - t0))
            server_ms.append(reply["ms"])
        res["request_wall_ms"] = float(np.median(wall))
        res["request_server_ms"] = float(np.median(server_ms))
        res["request_wall_ms_all"] = wall
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        listed = _frames(_http(url + "/frames", {
            "session": sid, "keypoints": kp[:2].tolist()}))

        # the same session in process on the same frames; the 2-frame
        # request is held against 2 frames in process
        sess = server.sessions[sid]
        inproc = sess.push_keypoints(kp)[..., ::-1]
        inproc2 = sess.push_keypoints(kp[:2])[..., ::-1]
        res["http_vs_inprocess_max_levels"] = int(np.abs(
            frames.astype(np.int16) - inproc).max())
        res["int_list_vs_inprocess_max_levels"] = int(np.abs(
            listed.astype(np.int16) - inproc2).max())
        res["batch2_vs_batch32_max_levels"] = int(np.abs(
            inproc2.astype(np.int16) - inproc[:2]).max())
        # model space: the kernel path against the plain path, and each
        # path's 2 frames decoded alone against the same frames in a
        # 32-frame chunk (the plain path launches none of the port's
        # kernels: a distance there is cuDNN's and cuBLAS's, whose
        # algorithms go by batch size)
        inputs = server.session_inputs(payload)
        model, alone = [], []
        for k in (True, False):
            plain_sess = RetargetSession(mods, *inputs, chunk=CHUNK,
                                         device=mods.device, use_kernels=k)
            model.append(plain_sess.push_keypoints(kp))
            alone.append(plain_sess.push_keypoints(kp[:2]))
        diff = np.abs(model[0] - model[1])
        res["vs_plain_max_abs"] = float(diff.max())
        res["vs_plain_mean_abs"] = float(diff.mean())
        for path, m, a in zip(("kernels", "plain"), model, alone):
            d = np.abs(a - m[:2])
            res[f"batch2_vs_batch32_{path}_max_abs"] = float(d.max())
            res[f"batch2_vs_batch32_{path}_mean_abs"] = float(d.mean())
        res["stages_ms"] = request_stages(server, sid, kp[:CHUNK])
        res["stages_sum_ms"] = sum(res["stages_ms"].values())
        res["profile"] = request_profile(server, sid, kp[:CHUNK], tier)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), f"serve {tier}: server thread still alive")
    print(f"[serve] {tier}: {json.dumps(res)} | {line}", flush=True)
    check(res["http_vs_inprocess_max_levels"] <= 1
          and res["int_list_vs_inprocess_max_levels"] <= 1,
          f"serve {tier}: served frames vs in-process push_keypoints")
    key, tol = (("max_abs", 1e-3) if tier == "bit-parity"
                else ("mean_abs", 0.01))
    check(res[f"vs_plain_{key}"] <= tol,
          f"serve {tier}: kernel path vs plain path")
    check(res[f"batch2_vs_batch32_kernels_{key}"] <= tol,
          f"serve {tier}: 2 frames alone vs in a 32-frame chunk")
    del mods, server
    torch.cuda.empty_cache()
    return res


def one_launch(name: str, call):
    """Run `call` with the launch counts zeroed just before and read just
    after; it must launch kernel `name` once and nothing else."""
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    out = call()
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    check(launches[name] == 1 and sum(launches.values()) == 1,
          f"{STANDALONE}: {name} call launched {launches}")
    return out


def sdpa_backend(q, k, v, scale: float) -> str:
    """The backend SDPA's dispatch picks for these inputs (the choice
    `F.scaled_dot_product_attention` makes on them)."""
    names = {int(b): n for n, b in SDPBackend.__members__.items()}
    return names[torch._fused_sdp_choice(q, k, v, scale=scale)]


def flow_phase(line: str) -> dict:
    """K5 through `transformation_warp(use_kernels=True)`, one source of
    the train batch (B=15, 32x32, C=512): flow and warped output at temps
    100 and 10 against the plain path, the five input gradients under a
    fixed cotangent of the flow, and times beside SDPA."""
    dev = torch.device("cuda")
    b, h, w, c = TRAIN_BATCH, 32, 32, 512
    t = h * w
    gen = torch.Generator().manual_seed(3)
    src = torch.randn(b, h, w, c, generator=gen)
    args = tuple(x.to(dev).contiguous() for x in (
        src, l2_normalize(torch.randn(b, h, w, c, generator=gen)),
        l2_normalize(src), (torch.rand(b, h, w, generator=gen) > 0.5).float(),
        (torch.rand(b, h, w, generator=gen) > 0.5).float()))
    name = "masked_attention_flow_fused"
    launches = 0
    for temp in (100.0, 10.0):
        warped, flow = one_launch(name, lambda: transformation_warp(
            *args, temp=temp, use_kernels=True))
        launches += 1
        plain_w, plain_f = transformation_warp(*args, temp=temp)
        errs = {"flow": compare(flow, plain_f, TOL["f32"]),
                "warped": compare(warped, plain_w, TOL["f32"])}
        print(f"[kernel] {name} (K5) via transformation_warp, temp {temp}: "
              f"(atol, rtol)={TOL['f32']} {json.dumps(errs)}", flush=True)
        check(all(e["worst_err_over_tol"] <= 1.0 for e in errs.values()),
              f"{name} disagrees with the plain path at temp {temp}: {errs}")
        if temp == 100.0:
            res = {"max_abs_err": max(e["max_abs_err"] for e in errs.values())}

    # the five input gradients under one fixed cotangent of the flow
    flat = (args[1].reshape(b, t, c), args[2].reshape(b, t, c),
            args[3].reshape(b, t), args[4].reshape(b, t),
            normalized_grid(h, w, device=dev).reshape(t, 2))
    ct = torch.randn(b, t, 2, generator=gen).to(dev)
    names = ("tar_fea", "src_fea", "tar_mask", "src_mask", "grid")
    grads = {}
    for path, fn in (("kernel", fl.masked_attention_flow_fused),
                     ("plain", fl.masked_attention_flow)):
        inputs = [x.clone().requires_grad_(True) for x in flat]
        grads[path] = torch.autograd.grad(fn(*inputs, temp=100.0), inputs, ct)
    rel = {n: ((a - p).abs().max() / max(1.0, p.abs().max().item())).item()
           for n, a, p in zip(names, grads["kernel"], grads["plain"])}
    print(f"[kernel] {name} (K5) gradients at temp 100, kernel path vs plain "
          f"path, max |diff| over max(1, max|plain|): {json.dumps(rel)}",
          flush=True)
    check(max(rel.values()) <= FLOW_GRAD_RTOL,
          f"{name}: input gradients differ from the plain path's: {rel}")
    del grads

    # times at temp 100; the yardstick is SDPA on the mask-folded inputs:
    # <[mt t, (1-mt) t], [ms s, (1-ms) s]> = coeff * <t, s>, v = the grid
    # zero-padded to 8 columns (the port never calls SDPA)
    tar, srcn, mt, ms, grid = flat
    res["ms"] = time_ms(lambda: fl.masked_attention_flow_fused(*flat))
    res["plain_ms"] = time_ms(lambda: fl.masked_attention_flow(*flat),
                              iters=3)
    q = torch.cat([mt[..., None] * tar, (1 - mt[..., None]) * tar], -1)
    k = torch.cat([ms[..., None] * srcn, (1 - ms[..., None]) * srcn], -1)
    q, k = q[:, None], k[:, None]                          # (B, 1, T, 2C)
    v = F.pad(grid, (0, 6)).expand(b, 1, t, 8).contiguous()

    def sdpa():
        with tf32(False):
            return F.scaled_dot_product_attention(q, k, v, scale=100.0)

    backend = sdpa_backend(q, k, v, 100.0)
    res["library_ms"] = time_ms(sdpa)
    sdpa_err = (sdpa()[:, 0, :, :2] - fl.masked_attention_flow(*flat)).abs()
    res["bound_ms"], res["bound_by"] = bound(
        4 * (2 * b * t * c + 2 * b * t + 2 * t + 2 * b * t),
        b * t * t * (2 * c + 10))
    res.update(launches=launches, tier=STANDALONE,
               replaces="wacv23_tsnet_tpu/ops/pallas_similarity.py:74",
               source="wacv23_tsnet_tpu_torch/csrc/attention_flow.cu")
    print(f"[kernel] {name} (K5, B={b}, T=S={t}, C={c}, temp 100): "
          f"max_abs_err={res['max_abs_err']:.3e} kernel_ms={res['ms']:.4f} "
          f"plain_ms={res['plain_ms']:.4f} library_ms={res['library_ms']:.4f} "
          f"(SDPA, backend {backend}, fp32, TF32 off, q/k {2 * c} wide; its "
          f"flow vs plain max_abs_err {sdpa_err.max().item():.3e}) "
          f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}) "
          f"bound_share={res['bound_ms'] / res['ms']:.4f} | {line}",
          flush=True)
    return res


def norm_phase(line: str) -> tuple[dict, dict]:
    """K8 `instance_norm_fused` at the decoder's last up stage of one
    32-frame request, (32, 256, 256, 64), and its phase layout
    (32, 128, 128, 256) with phase_groups=4; bf16 and f32, relu on and
    off; the path the planner chose (its cluster, and how many such
    clusters run at once) against the plain version in fp32 (before its
    one rounding), the forced three-launch path the same way with its
    launches timed apart, what one call launches by CUDA kernel, the phase
    identity, and times beside `F.instance_norm` (on the NCHW view, or
    with phase groups on the (B, C/G, N*G) view). Returns the kernels
    line's rows: the bf16 case of each shape."""
    name = "instance_norm_fused"
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases, launches = {}, 0
    for groups, shape in K8_SHAPES.items():
        b, h, w, c = shape
        x32 = torch.randn(shape, generator=gen, device="cuda") * 2 + 1
        for dtype, x in (("bf16", x32.to(torch.bfloat16)), ("f32", x32)):
            plan = nk.fused_plan(h * w, c, groups, x.element_size(),
                                 x.data_ptr() % 16 == 0)
            where = plan.path
            if plan.path == "cluster":
                where += (f" of {plan.cluster} blocks x {plan.rows_per_block}"
                          f" pixels, slab {plan.slab} channels, "
                          f"{plan.smem_bytes} B shared a block, "
                          f"{nk.fused_max_clusters(plan, x.dtype)} clusters "
                          "at once")
            # the library's one call: relu off, the groups pooled by a view
            lib_view = (x.permute(0, 3, 1, 2) if groups == 1 else
                        x.view(b, h * w * groups, c // groups).transpose(1, 2))
            for relu in (False, True):
                def kernel():
                    return nk.instance_norm_fused(x, relu=relu,
                                                  phase_groups=groups)
                out = one_launch(name, kernel)
                launches += 1
                check(out.dtype == x.dtype and out.shape == x.shape,
                      f"{name}: output {out.dtype} {tuple(out.shape)}")
                want = nk.instance_norm_fused_plain(
                    x, relu=relu, phase_groups=groups,
                    out_dtype=torch.float32)
                res = compare(out, want, IN_TOL[dtype])
                del out
                key = f"{name}_g{groups}_{dtype}" + ("_relu" if relu else "")
                check(res["worst_err_over_tol"] <= 1.0,
                      f"{key} {shape} disagrees with its plain version: {res}")
                # the three-launch path, forced, held the same way
                launch3, out3 = nk.fused_launcher(
                    x, relu=relu, phase_groups=groups, path="three_launch")
                launch3()
                torch.cuda.synchronize()
                three = compare(out3, want, IN_TOL[dtype])
                del out3, want
                check(three["worst_err_over_tol"] <= 1.0,
                      f"{key} {shape} three-launch path disagrees with the "
                      f"plain version: {three}")
                res["ms"] = time_ms(kernel)
                res["plain_ms"] = time_ms(lambda: nk.instance_norm_fused_plain(
                    x, relu=relu, phase_groups=groups), iters=3)
                res["three_launch_ms"] = time_ms(launch3)
                res["parts_ms"] = parts_ms(launch3, nk.FUSED_PHASES,
                                           "three_launch_")
                res["device_parts"] = device_parts(kernel)
                res["library_ms"] = None if relu else time_ms(
                    lambda: F.instance_norm(lib_view, eps=1e-5))
                res["bound_ms"], res["bound_by"] = bound(
                    2 * x.numel() * x.element_size(), 7 * x.numel())
                cases[key] = res
                library = ("none (relu)" if res["library_ms"] is None else
                           f"{res['library_ms']:.4f} (F.instance_norm, "
                           + ("NCHW view)" if groups == 1 else
                              "(B, C/G, N*G) view)"))
                print(f"[kernel] {key} (K8, {shape}, {where}): max_abs_err="
                      f"{res['max_abs_err']:.3e} mean_abs_err="
                      f"{res['mean_abs_err']:.3e} (atol, rtol)="
                      f"{IN_TOL[dtype]} kernel_ms={res['ms']:.4f} plain_ms="
                      f"{res['plain_ms']:.4f} library_ms={library} bound_ms="
                      f"{res['bound_ms']:.4f} ({res['bound_by']}) "
                      f"bound_share={res['bound_ms'] / res['ms']:.4f} "
                      f"device_parts={json.dumps(res['device_parts'])} | "
                      f"{line}", flush=True)
                print(f"[kernel] {key} three-launch path (forced): "
                      f"max_abs_err={three['max_abs_err']:.3e} "
                      f"ms={res['three_launch_ms']:.4f} parts_ms="
                      f"{json.dumps(res['parts_ms'])} | {line}", flush=True)
        if groups == 1:
            # the phase layout of x normalises as x does
            phase = nk.instance_norm_fused(space_to_depth(x32, 2),
                                           phase_groups=4)
            ident = compare(phase, space_to_depth(
                nk.instance_norm_fused(x32), 2), IN_TOL["f32"])
            print(f"[kernel] {name} phase identity (f32, {shape}): "
                  f"{json.dumps(ident)}", flush=True)
            check(ident["worst_err_over_tol"] <= 1.0,
                  f"{name}: phase layout vs interleaved: {ident}")
            del phase
        del x32, x, lib_view
        torch.cuda.empty_cache()
    # the kernels line's rows: the bf16 case of each shape (phase_groups=4
    # ran furthest from its bound on the three-launch path)
    rows = tuple(dict(cases[f"{name}_g{g}_bf16"], tier=STANDALONE,
                      launch=name,
                      replaces="wacv23_tsnet_tpu/ops/pallas_norms.py:206",
                      source="wacv23_tsnet_tpu_torch/csrc/in_fused.cu")
                 for g in K8_SHAPES)
    rows[0]["launches"] = launches
    return rows


def k6_bits(s: int, f: int, hw: int, k: int, co: int, seed: int) -> str:
    """sha256 of K6's output bits on inputs made from a numpy seed (the
    weight scaled by 0.05); tests/test_torch_cuda.py pins the small case."""
    rng = np.random.default_rng(seed)
    c1a = torch.from_numpy(rng.standard_normal((s, hw, hw, k), np.float32))
    c1t = torch.from_numpy(rng.standard_normal((f, hw, hw, k), np.float32))
    w2 = torch.from_numpy(rng.standard_normal((co, k, 3, 3), np.float32))
    out = fk.fuse_pair_conv2(c1a.to("cuda", torch.bfloat16),
                             c1t.to("cuda", torch.bfloat16),
                             (w2 * 0.05).to("cuda"))
    return hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes()
                          ).hexdigest()


def parts_phase(line: str) -> None:
    """`--parts`: what one call of K7 and of K2 launches at the main
    paths' shapes, and of K8 at K8_SHAPES (bf16 and f32, also its ms by
    CUDA events), by CUDA kernel (device ms and launches per call), and
    K6's output bits; only entry
    points that every version of the port has, so that the same script
    reads an earlier tree's kernels."""
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    wc = (torch.randn(512, 512, 3, 3, generator=g) * 0.02).to(dev)
    for b in (32, 64):
        x = torch.randn(b, 32, 32, 512, generator=g).to(dev, torch.bfloat16)
        for relu, skip in ((True, None), (False, x)):
            parts = device_parts(lambda: ck.conv3x3_in(x, wc, skip=skip,
                                                       relu=relu))
            print(f"[parts] conv3x3_in B={b} {'relu' if relu else 'skip'}: "
                  f"{json.dumps(parts)} | {line}", flush=True)
    x = (torch.randn(3, 32, 32, 32, 1024, generator=g) * 2 + 1).to(dev)
    for name, xx in (("f32", x), ("bf16", x.to(torch.bfloat16))):
        parts = device_parts(lambda: nk.instance_norm_mean(xx))
        print(f"[parts] instance_norm_mean_{name} (3, 32, 32, 32, 1024): "
              f"{json.dumps(parts)} | {line}", flush=True)
    for groups, shape in K8_SHAPES.items():
        x = (torch.randn(shape, generator=g) * 2 + 1).to(dev)
        for name, xx in (("bf16", x.to(torch.bfloat16)), ("f32", x)):
            def call():
                return nk.instance_norm_fused(xx, phase_groups=groups)
            parts = device_parts(call)
            # and by CUDA events, as the standalone phase times it
            print(f"[parts] instance_norm_fused_g{groups}_{name} {shape}: "
                  f"{json.dumps(parts)} ms={time_ms(call):.4f} | {line}",
                  flush=True)
        del x, xx
    print(f"[bits] fuse_pair_conv2 sha256: (2, 3, 12, 64 -> 72, seed 20) "
          f"{k6_bits(2, 3, 12, 64, 72, 20)}; (3, 8, 32, 1024 -> 1024, seed "
          f"21) {k6_bits(3, 8, 32, 1024, 1024, 21)}", flush=True)


def requests_phase(line: str, repeats: int = 10) -> None:
    """`--requests`: `repeats` 32-frame session requests (one
    `RetargetSession.push_labels` each, host clock, frames copied back)
    in the bit-parity and bench tiers, on fresh modules and before any
    other phase; prints their median and all of them. Entry points every
    version of the port has, as for `--parts`."""
    base = face_config()
    tiers = {"bit-parity": base,
             "bench": dataclasses.replace(base, precision="high",
                                          fast_tail=True, fast_trunk=True)}
    rng = np.random.default_rng(0)
    s, hw, nl = base.n_source, base.image_size, base.label_nc
    dev = torch.device("cuda")
    src = (torch.as_tensor(rng.random((s, hw, hw, 3), np.float32), device=dev),
           torch.as_tensor(rng.integers(0, 2, (s, hw, hw, nl)).astype(
               np.float32), device=dev),
           torch.as_tensor(rng.integers(0, 2, (s, hw, hw)).astype(np.float32),
                           device=dev))
    lbl = torch.as_tensor(rng.integers(0, 2, (CHUNK, hw, hw, nl)).astype(
        np.float32), device=dev)
    box = torch.as_tensor(rng.integers(0, 2, (CHUNK, hw, hw)).astype(
        np.float32), device=dev)
    for tier, cfg in tiers.items():
        mods = TSNetModules(cfg, device="cuda", seed=0)
        sess = RetargetSession(mods, *src, chunk=CHUNK)
        for _ in range(3):                           # warm-up (cuDNN plans)
            sess.push_labels(lbl, box)
        torch.cuda.synchronize()
        ms = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            sess.push_labels(lbl, box)
            ms.append(1e3 * (time.perf_counter() - t0))
        print(f"[requests] {tier}: median {np.median(ms):.2f} ms of "
              f"{repeats}: {json.dumps([round(m, 2) for m in ms])} | {line}",
              flush=True)
        del mods, sess
        torch.cuda.empty_cache()


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
    if sys.argv[1:] == ["--parts"]:
        parts_phase(line)
        return 0
    if sys.argv[1:] == ["--requests"]:
        requests_phase(line)
        return 0

    t0 = time.perf_counter()
    per_source = cuda_build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s wall, per source "
          f"{json.dumps(per_source)}", flush=True)
    for name in cuda_build.SOURCES:
        log = cuda_build.library_path(name).with_suffix(".log").read_text()
        for text in log.splitlines():
            if "Used" in text or "spill" in text:
                print(f"[ptxas] {name}: {text.strip()}")
    # the shared logit tile (csrc/attention_tile_sm90.cuh) in its kernels
    print("[tile] registers, shared memory and spills: " + json.dumps(
        {name: ptxas_resources(name)
         for name in ("transform_warp", "attention_flow")}), flush=True)
    # K4's five kernels (the logit tile, the fp32 GEMM tile) and K6's two
    print("[ptxas] K4 and K6 kernels: registers, shared memory and spills: "
          + json.dumps({name: ptxas_resources(name) for name in (
              "transform_warp_bwd", "fuse_pair_conv2")}), flush=True)
    # K7's cluster and two-pass kernels, K2's tile and statistics kernels
    print("[ptxas] K7 and K2 kernels: registers, shared memory and spills: "
          + json.dumps({name: ptxas_resources(name) for name in (
              "conv3x3_in", "in_mean")}), flush=True)
    print(f"[bits] fuse_pair_conv2 sha256 (2, 3, 12, 64 -> 72, seed 20): "
          f"{k6_bits(2, 3, 12, 64, 72, 20)}", flush=True)

    kernels = kernel_checks(line)
    train_kernels = train_kernel_checks(line)
    report = main_path(line)
    report["train"], state = train_phase(line)
    t0 = time.perf_counter()
    report["serve"] = serve_phase(line, state)
    print(f"[serve] phase {time.perf_counter() - t0:.1f} s", flush=True)
    del state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    flow = flow_phase(line)
    norm, norm_g4 = norm_phase(line)
    standalone = {"masked_attention_flow_fused": flow,
                  "instance_norm_fused": norm}
    print(f"[{STANDALONE}] K5 and K8 phase {time.perf_counter() - t0:.1f} s",
          flush=True)
    report[STANDALONE] = {"launches": {n: k.pop("launches")
                                       for n, k in standalone.items()}}

    rows = []
    for name, k in train_kernels.items():
        kernels[name] = dict(k, tier="train")
    kernels.update(standalone)
    kernels["instance_norm_fused_g4"] = norm_g4  # K8 at phase_groups=4
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
                "instance_norm_mean" if name.startswith("instance_norm_mean")
                else k.get("launch", name)],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k.get("library_ms")})
    print(json.dumps({"kernels": rows}))
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
