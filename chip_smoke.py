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
8. Trains from files on disk (`[loop]`): a synthetic face dataset (15
   videos x 10 seeded-noise PNG frames at 320x320, written by the port's
   PNG writer, with 68-point landmark files) in a temporary directory of
   the checkout; `cli.train_face.main` at the full width of
   `face_config()`, bit-parity tier, batch 15, 14 steps (two clip batches
   of 7) with the launch counts zeroed just before and read just after
   (one K3-flow, one K4 and one K2 a step, nothing else), ms/step over
   steps 2-14, the loader's data wait as a share of the loop's wall, peak
   memory; the final snapshot restored and held equal to the trained
   state, then one more step through `--restore-from --set-start` (its
   launches counted under torch.profiler). The fast train tier
   (`precision="high"`, `bwd_precision="default"`, `fast_tail`): the
   full-generator gradient cosines of the bf16 backward against the f32
   backward and of the bf16 tail against the f32 tail (each >= 0.99, the
   plain path's beside it), 10 timed steps of it and of the bit-parity
   tier; `remat=True`'s peak memory and gradients (within the plain
   path's own 1e-6-nudge spread). `ClipInference` on a 64-frame clip of
   the dataset in both tiers: bit-equal to `tsnet_forward_clip` over the
   same 32-frame chunks, one warp kernel and one K2 a chunk,
   `run_renormalized` against its plain path, `l1`/`psnr`/`ssim` on the
   card against the CPU.
9. Runs the face test-time workflow (`[demo]`): a synthetic test set (a
   subject and a driving clip of 40 ramp-and-noise PNG frames at 320x320,
   faces of different sizes, so the retargeter rescales) through
   `cli.demo_face.main` at the full width of `face_config()` with seeded
   random weights, in its default tier (K3-nf) and with `--fast-tail`
   (K1): 40 frames in two 32-frame chunks, the second padded by wrapping,
   with the launch counts zeroed just before and read just after (one
   warp kernel and one K2 a chunk, nothing else); the reconstruction
   against `ClipInference(use_kernels=False)` on the same sample and
   weights (0.01 mean L1), each montage PNG decoded by the port against
   the frames it was built from, the GIF's header, frame count and
   delays; the CLI's frames/s, the PNGs' wall time and the GIF's encode
   time. Then `cli.eval_snapshots.main` over `[loop]`'s snapshots (one CSV
   row each, finite metrics, restore and inference seconds),
   `cli.quick_start.main([])` (one step at batch 4, 256x256, under
   torch.profiler: one K3-flow, K4 and K2; finite losses; ms and peak
   memory) and `cli.profile_stages` on a 64-frame clip in the bit-parity
   tier (its SUM of stages within 15% of `[fps]`'s clip) and its default
   tier, and the train stages at batch 15.
10. Drives the two kernels that no model path reaches through their own
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
11. Drives the pose variant (`[pose]`, after `[serve]` has freed the
   train phase's state) at the full width of `pose_config()` (256²,
   label_nc=25, 3 sources, netD and netDF) with seeded random weights
   and seeded one-hot pose label maps (body regions; in each batch a
   face blob, head classes only, neither, and a face at the border):
   K3-flow and K4 at G=10 and K2 at (3, 10, 32, 32, 1024) in f32 and
   bf16 against their plain versions; a 64-frame clip in the bit-parity
   tier (K3-nf + K2) and the JAX package's pose inference tier ("high" +
   fast_tail + fast_trunk: K1 + K2), launches counted, against the plain
   path (1e-3 max abs / 0.01 mean L1), the background columns equal to
   the mean colour exactly, frames/s, stage split and peak memory, and a
   32-frame `RetargetSession.push_labels` against `decode_with_sources`;
   `crop_faces` under `torch.cuda.set_sync_debug_mode("error")`; the
   first train step at batch 10 through the kernels, the plain versions
   and the plain versions on nudged inputs (the 16 metrics, netD and
   netDF gradients, each generator subnet's); 20 steps (one K3-flow, K4
   and K2 a step; ms/step over steps 2-20, stage split, peak memory);
   the trained state saved and restored bit for bit (netDF and its Adam
   moments); the fast train tier's ms/step, and the cosines of its
   generator gradient (the G-phase loss at the seeded discriminators, as
   the JAX package measured its tiers) against "high" at temp 100 and
   the bit-parity tier at temp 10 (each >= 0.9), and against the
   bit-parity tier at temp 100, printed.
12. Prints one `kernels` JSON line (with each kernel's launches on the
   pose path, `pose_launches`, and for K3-flow, K4 and K2 its check at
   the pose train shape, `pose`), the card line again, and last
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

    python3 chip_smoke.py --pose

builds the kernels and runs only the pose phase (step 11).
"""

from __future__ import annotations

import base64
import collections
import contextlib
import dataclasses
import hashlib
import json
import os
import random
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

from wacv23_tsnet_tpu_torch.cli import (demo_face, eval_snapshots,
                                        profile_stages, quick_start,
                                        train_face)
from wacv23_tsnet_tpu_torch.cli.demo_face import load_params
from wacv23_tsnet_tpu_torch.cli.serve import Server, make_handler
from wacv23_tsnet_tpu_torch.compat import (export_flax_params,
                                           save_reference_checkpoint)
from wacv23_tsnet_tpu_torch.configs import face_config, pose_config
from wacv23_tsnet_tpu_torch.data.datasets import (FaceDatasetTest,
                                                  FaceDatasetTrain)
from wacv23_tsnet_tpu_torch.data.image_io import read_png, write_png
from wacv23_tsnet_tpu_torch.data.rasterize_device import rasterize_face_clip
from wacv23_tsnet_tpu_torch.infer import (ClipInference, RetargetSession,
                                          to_display_rgb)
from wacv23_tsnet_tpu_torch.infer import metrics as im
from wacv23_tsnet_tpu_torch.losses import (feature_matching_loss,
                                           lsgan_loss, vgg_perceptual_loss)
from wacv23_tsnet_tpu_torch.models import (TSNet, TSNetModules,
                                           tsnet_forward, tsnet_forward_clip)
from wacv23_tsnet_tpu_torch.models.tsnet import (crop_faces,
                                                 decode_with_sources,
                                                 encode_sources,
                                                 get_face_bbox,
                                                 label_features, propagate)
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
from wacv23_tsnet_tpu_torch.ops.similarity import transformation_warp
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
# the loop phase: a synthetic face dataset (LOOP_VIDEOS videos of
# LOOP_FRAMES PNG frames at LOOP_HW^2), trained through cli.train_face for
# LOOP_STEPS steps (two clip batches of 7 steps) at batch 15
LOOP_VIDEOS = 15
LOOP_FRAMES = 10
LOOP_HW = 320
LOOP_STEPS = 14
LOOP_PRINT_FREQ = 7
# the fast train tier (the JAX package's shipped tier) and its fidelity
# floors: full-generator gradient cosines against the f32 backward and
# the f32 tail (JAX on its chip: 0.99947 and 0.9937)
FAST_TIER = dict(precision="high", bwd_precision="default", fast_tail=True)
GRAD_COS_FLOOR = 0.99
TIER_STEPS = 10
# the demo phase: a synthetic face test set (a subject and a driving clip
# of DEMO_FRAMES PNG frames at LOOP_HW^2, faces DEMO_FACE_R apart in size)
# through cli.demo_face in two chunks of CHUNK frames, the second padded by
# wrapping; its tiers, each held against the plain path at the 0.01
# mean-L1 budget of QUIRKS.md "Numerics decisions" ("high" is one of the
# fast tiers there), and the kernels each launches a chunk
DEMO_FRAMES = 40
DEMO_FACE_R = {"subject": 70, "driving": 52}
DEMO_TIERS = {"default": ([], "transform_warp_pairs_nf"),
              "fast-tail": (["--fast-tail"], "transform_warp_pairs_mean")}
DEMO_TOL = 0.01
# profile_stages' SUM of stages against [fps]'s clip in the same tier
STAGE_SUM_TOL = 0.15
# the pose phase: pose_config() at full width; the reference's train
# batch (train_pose.py: 10); the clip tiers with the warp kernel each
# launches and the one it must not; the fast train tier's generator-
# gradient cosine against the bit-parity tier: a sanity floor on random
# weights (the JAX package measured 0.974 between its tiers, printed as
# a reference)
POSE_BATCH = 10
POSE_STEPS = 20
POSE_TIERS = {
    "bit-parity": ({}, "transform_warp_pairs_nf",
                   "transform_warp_pairs_mean"),
    "pose-fast": (dict(precision="high", fast_tail=True, fast_trunk=True),
                  "transform_warp_pairs_mean", "transform_warp_pairs_nf"),
}
POSE_COS_FLOOR = 0.9
POSE_JAX_COSINE = 0.974
# the JAX package compared its fast tier with "high", which on the TPU is
# three bf16 passes, near fp32; the port's "high" is TF32, whose forward
# alone turns the generator's gradient by a cosine of ~0.78 at temp 100
# with random weights (~0.99 at temp 10). So the floor holds the fast
# tier against "high" at the config's temp, as the JAX package measured
# it, and against the bit-parity tier at temp 10; the fast tier against
# the bit-parity tier at temp 100 is printed
POSE_COS_CASES = (("fast_vs_high", 100.0, True),
                  ("fast_vs_bit_parity", 10.0, True),
                  ("fast_vs_bit_parity", 100.0, False),
                  ("high_vs_bit_parity", 100.0, False))
POSE_SUBNETS = GEN_SUBNETS + ("netD", "netDF")
# the G-phase metrics read through the discriminators after their first
# Adam step, which moves each weight by about its lr whatever the size
# of its gradient: where the kernel path's netDF gradient has the other
# sign from the plain path's (their relative L2 differs by ~1e-3 on the
# 64^2 crops), the weight lands 2 lr away. These metrics are held as the
# gradients are: within STEP_METRIC_RTOL or NUDGE_MARGIN times the
# plain path's own difference under the input nudges. One nudge is one
# sample of that spread: the pose phase takes two, POSE_NUDGES, as the
# CPU train-step tests do, and holds each quantity against the larger
POSE_D_READ_METRICS = ("G_GAN", "G_FML", "G", "GF_GAN", "GF_FML", "GF")
POSE_NUDGES = (1e-6, 1e-5)
# crop_faces on the card against its CPU run: the card's `arange / 63`
# differs from the CPU's in the last bit of 30 of 64 values, so a sample
# position below 256 may move by its ulp, 2^-16, which the bilinear
# weights multiply by the difference of two neighbouring pixels (below 1
# for these unit-uniform images)
CROP_TOL = 1e-4
POSE_CASES = ("face", "head", "neither", "border")


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
    return check_cases(cases, line)


def check_cases(cases: dict, line: str) -> dict:
    """Each case's kernel against its plain version, and both timed;
    prints a `[kernel]` line each."""
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
        tar_fea, tar_fea_n, tar_mask = label_features(mods, tar_lbl,
                                                      tar_bbox)
        mark("lbl_enc")
        prop = propagate(mods, pack, tar_fea_n, tar_mask)
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


def train_kernel_checks(line: str, g: int = TRAIN_BATCH) -> dict:
    """K3-flow and K4 against their plain versions at the train shape of
    batch g."""
    dev = torch.device("cuda")
    ns, nf, h, w, c = 3, 1, 32, 32, 512
    t, pairs = h * w, g * 3
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
    print(f"[kernel] transform_warp_pairs (K3-flow, warped + flow, temp 100, "
          f"G={g}):"
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
        print(f"[kernel] transform_warp_pairs_bwd (K4) temp {temp}, G={g}: "
              f"error over max(1, max|reference|) per cotangent "
              f"{json.dumps(rel)}",
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
    print(f"[kernel] transform_warp_pairs_bwd (K4, six cotangents, G={g}): "
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


def pose_labels(rng, n: int, hw: int, nl: int) -> torch.Tensor:
    """n one-hot pose label maps (n, hw, hw, nl) f32 on the card: body
    regions of the classes 5..nl-2 on background 0, and by sample i % 4
    a face blob (class nl-1) in a head (classes 1-4), head classes only,
    neither, or a face at the image's top-left corner (where the crop
    box's clamps bind)."""
    cls = np.zeros((n, hw, hw), np.int64)
    u = hw // 16
    for i in range(n):
        for _ in range(3):
            y, x = rng.integers(4 * u, 12 * u, 2)
            cls[i, y:y + 3 * u, x:x + 2 * u] = rng.integers(5, nl - 1)
        case = POSE_CASES[i % 4]
        y, x = rng.integers(u, 6 * u), rng.integers(5 * u, 10 * u)
        if case in ("face", "head"):
            cls[i, y:y + 3 * u, x:x + 3 * u] = rng.integers(1, 5)
        if case == "face":
            cls[i, y + u // 2:y + 5 * u // 2, x + u // 2:x + 5 * u // 2] = (
                nl - 1)
        if case == "border":
            cls[i, :2 * u, :3 * u] = nl - 1
    return F.one_hot(torch.as_tensor(cls, device="cuda"), nl).float()


def pose_batch(cfg, bs: int, seed: int) -> dict:
    """A pose train batch made from a numpy seed, on the card."""
    rng = np.random.default_rng(seed)
    s, hw, nl = cfg.n_source, cfg.image_size, cfg.label_nc
    dev = torch.device("cuda")
    rand = lambda *shape: torch.as_tensor(  # noqa: E731
        rng.random(shape, np.float32), device=dev)
    bits = lambda *shape: torch.as_tensor(  # noqa: E731
        rng.integers(0, 2, shape).astype(np.float32), device=dev)
    return {"src_img": rand(bs, s, hw, hw, 3),
            "src_lbl": pose_labels(rng, bs * s, hw, nl).reshape(
                bs, s, hw, hw, nl),
            "src_bbox": bits(bs, s, hw, hw), "tar_img": rand(bs, hw, hw, 3),
            "tar_lbl": pose_labels(rng, bs, hw, nl),
            "tar_bbox": bits(bs, hw, hw)}


def pose_clip_tier(line: str, tier: str, cfg, src, tar_lbl, tar_bbox,
                   launched: collections.Counter) -> dict:
    """One tier of the pose clip (see `pose_phase`); adds its launches
    to `launched`."""
    over, warp_kernel, other_kernel = POSE_TIERS[tier]
    mods = TSNetModules(dataclasses.replace(cfg, **over), seed=0)
    forward = lambda use_kernels=True: tsnet_forward_clip(  # noqa: E731
        mods, *src, tar_lbl, tar_bbox, use_kernels=use_kernels)
    forward()                                        # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    out = forward()
    sess = RetargetSession(mods, *src, chunk=CHUNK)
    pushed = torch.as_tensor(sess.push_labels(tar_lbl[:CHUNK],
                                              tar_bbox[:CHUNK]))
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    launched.update(launches)
    hw = cfg.image_size
    check(tuple(out.shape) == (CLIP_FRAMES, hw, hw, 3)
          and bool(torch.isfinite(out).all()), f"pose {tier}: clip output")
    check(launches[warp_kernel] == 2 and launches["instance_norm_mean"] == 2
          and sum(launches.values()) == 4,
          f"pose {tier}: launches of a clip and a session request "
          f"(one {warp_kernel} and one K2 each): {launches}")
    plain = forward(use_kernels=False)
    diff = (out - plain).abs()
    with torch.inference_mode():
        want = decode_with_sources(mods, sess.src_pack, tar_lbl[:CHUNK],
                                   tar_bbox[:CHUNK]).cpu()
    sess_diff = (pushed - want).abs()
    bg = torch.as_tensor(-cfg.img_mean_array() / 255.0, device="cuda")
    res = {"launches": launches,
           "vs_plain_max_abs": diff.max().item(),
           "vs_plain_mean_abs": diff.mean().item(),
           "session_vs_decode_max_abs": sess_diff.max().item(),
           "session_vs_decode_mean_abs": sess_diff.mean().item(),
           "background_exact": bool((out[:, :, :hw // 4] == bg).all()
                                    and (out[:, :, 3 * hw // 4:] == bg).all()
                                    and (plain[:, :, :hw // 4] == bg).all())}
    key, tol = (("max_abs", 1e-3) if tier == "bit-parity"
                else ("mean_abs", 0.01))
    check(res[f"vs_plain_{key}"] <= tol,
          f"pose {tier}: kernel path vs plain path: {res}")
    check(res[f"session_vs_decode_{key}"] <= tol,
          f"pose {tier}: session vs decode_with_sources: {res}")
    check(res["background_exact"], f"pose {tier}: background columns")
    del plain, diff, sess, pushed, want

    iters = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        forward()
    torch.cuda.synchronize()
    res["clip_ms"] = 1e3 * (time.perf_counter() - t0) / iters
    res["fps"] = CLIP_FRAMES / (res["clip_ms"] / 1e3)
    torch.cuda.reset_peak_memory_stats()
    forward()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["stage_ms"] = stage_ms(mods, src, tar_lbl, tar_bbox)
    print(f"[pose] clip {tier}: {json.dumps(res)} | {line}", flush=True)
    print(f"[fps] pose {tier}: {res['fps']:.2f} frames/s ({CLIP_FRAMES}-frame "
          f"clip, {res['clip_ms']:.2f} ms) on {line}", flush=True)
    del mods, out
    torch.cuda.empty_cache()
    return res


def pose_first_step(cfg, batch: dict, launched: collections.Counter):
    """The first pose train step from one seeded state through the
    kernels, the plain versions and the plain versions on input images
    moved by INPUT_NUDGE, at temp 10 and at the config's 100, held by
    [train]'s rules, with netDF beside netD; returns the temp-100 kernel
    path's state and step."""
    gen = torch.Generator().manual_seed(9)
    paths = [("plain", False, batch)]
    for eps in POSE_NUDGES:
        nudged = dict(batch)
        for k in ("src_img", "tar_img"):
            nudged[k] = batch[k] * (1 + eps * torch.randn(
                batch[k].shape, generator=gen).to(batch[k].device))
        paths.append((f"nudged_{eps:g}", False, nudged))
    paths.append(("kernel", True, batch))
    nudges = [name for name, _, _ in paths[1:-1]]
    for temp in (10.0, cfg.softmax_temp):
        tcfg = dataclasses.replace(cfg, softmax_temp=temp)
        runs = {}
        for name, use_kernels, data in paths:
            state = create_train_state(tcfg, device="cuda", seed=0)
            step = make_train_step(state, use_kernels=use_kernels)
            cuda_build.reset_launches()
            _, metrics, _ = step(state, data, TRAIN_LR)
            torch.cuda.synchronize()
            launches = dict(cuda_build.LAUNCHES)
            check(all(launches[k] == int(use_kernels) for k in TRAIN_KERNELS)
                  and sum(launches.values()) == 3 * int(use_kernels),
                  f"pose: first step's launches on the {name} path: "
                  f"{launches}")
            if use_kernels:
                launched.update(launches)
            runs[name] = {"metrics": {k: v.item()
                                      for k, v in metrics.items()},
                          "grads": grads_of(state, POSE_SUBNETS)}
            if not (use_kernels and temp == cfg.softmax_temp):
                del state, step
                torch.cuda.empty_cache()
        mp, gp = runs["plain"]["metrics"], runs["plain"]["grads"]
        err = {}
        for name in ["kernel"] + nudges:
            err[f"{name}_metrics"] = {
                k: abs(v - mp[k]) / max(1.0, abs(mp[k]))
                for k, v in runs[name]["metrics"].items()}
            err[f"{name}_grads"] = {
                k: ((v - gp[k]).norm() / gp[k].norm()).item()
                for k, v in runs[name]["grads"].items()}
        for kind in ("metrics", "grads"):
            err[f"nudged_{kind}"] = {k: max(err[f"{n}_{kind}"][k]
                                            for n in nudges)
                                     for k in err[f"kernel_{kind}"]}
        print(f"[pose] first step at temp {temp}, batch {POSE_BATCH}, kernel "
              f"path and nudged plain path vs plain path (gradients "
              f"relative L2): {json.dumps(err)}", flush=True)
        bad = {k: v for k, v in err["kernel_metrics"].items()
               if v > (max(STEP_METRIC_RTOL,
                           NUDGE_MARGIN * err["nudged_metrics"][k])
                       if k in POSE_D_READ_METRICS else STEP_METRIC_RTOL)}
        check(len(err["kernel_metrics"]) == 16 and not bad,
              f"pose: first-step metrics at temp {temp}: {bad}")
        check(err["kernel_grads"]["netD"] <= STEP_GRAD_RTOL,
              f"pose: first-step netD gradient at temp {temp}: "
              f"{err['kernel_grads']}")
        # netDF, on 64^2 crops, moves by a few 1e-3 under the nudge (the
        # kernel path's reconstruction differs from the plain path's by
        # rounding): it is held as the generator's subnets are
        worst = {k: v for k, v in err["kernel_grads"].items()
                 if k != "netD" and v > max(
                     STEP_GRAD_RTOL, NUDGE_MARGIN * err["nudged_grads"][k])}
        check(not worst, f"pose: first-step gradients at temp {temp} beyond "
              f"the nudged path's spread: {worst}")
    return state, step


def pose_g_grad(cfg, batch: dict) -> torch.Tensor:
    """The generator's gradient of the G-phase loss at the seeded initial
    discriminators, as the JAX package measured its pose tiers (its
    artifacts/round5/pose_train_tier.py: GAN, feature-matching and VGG
    terms of netD and of netDF on the face crops, and the warp loss), as
    one float64 vector."""
    state = create_train_state(cfg, device="cuda", seed=0)
    mods, vgg = state.mods, state.vgg
    for d in (mods.netD, mods.netDF):
        d.requires_grad_(False)
    out = tsnet_forward(mods, *(batch[k] for k in FORWARD_KEYS),
                        tar_img=batch["tar_img"], train=True)
    rec, tar, lbl = out["rec_img"], batch["tar_img"], batch["tar_lbl"]
    total = out["loss_warp"]
    face, face_real = crop_faces(rec, lbl), crop_faces(tar, lbl)
    for d, fake, real, d_fake, d_real in (
            (mods.netD, rec, tar, torch.cat([lbl, rec], -1),
             torch.cat([lbl, tar], -1)),
            (mods.netDF, face, face_real, face, face_real)):
        pf = d(d_fake)
        with torch.no_grad():
            pr = d(d_real)
        total = (total + lsgan_loss(pf[-1], True)
                 + feature_matching_loss(pf, pr, cfg.lambda_fml)
                 + cfg.lambda_vgg * vgg_perceptual_loss(vgg, fake, real))
    total.backward()
    grad = torch.cat([p.grad.flatten() for name in GEN_SUBNETS
                      for p in getattr(mods, name).parameters()
                      if p.grad is not None]).double()
    del state, mods, vgg, out
    torch.cuda.empty_cache()
    return grad


def pose_phase(line: str) -> dict:
    """The pose variant at the full width of pose_config() (see the
    module docstring, step 11). Returns its report, with the launches of
    its clip, session and train runs by kernel under "launches"."""
    cfg = pose_config()
    s, hw, nl = cfg.n_source, cfg.image_size, cfg.label_nc
    launched = collections.Counter()
    report = {"kernels": train_kernel_checks(line, POSE_BATCH)}
    g = torch.Generator().manual_seed(11)
    x = (torch.randn(3, POSE_BATCH, 32, 32, 2 * cfg.feat_ch, generator=g)
         * 2 + 1).to("cuda")
    report["kernels"].update(check_cases({
        "instance_norm_mean_pose_f32": k2_case(x, IN_TOL["f32"]),
        "instance_norm_mean_pose_bf16": k2_case(x.to(torch.bfloat16),
                                                IN_TOL["bf16"])}, line))
    del x

    # 1. the clip, 64 frames against 3 sources, in both inference tiers
    rng = np.random.default_rng(7)
    src = (torch.as_tensor(rng.random((s, hw, hw, 3), np.float32),
                           device="cuda"),
           pose_labels(rng, s, hw, nl),
           torch.as_tensor(rng.integers(0, 2, (s, hw, hw)).astype(
               np.float32), device="cuda"))
    tar_lbl = pose_labels(rng, CLIP_FRAMES, hw, nl)
    tar_bbox = torch.as_tensor(rng.integers(0, 2, (CLIP_FRAMES, hw, hw))
                               .astype(np.float32), device="cuda")
    for tier in POSE_TIERS:
        report[f"clip {tier}"] = pose_clip_tier(line, tier, cfg, src, tar_lbl,
                                                tar_bbox, launched)
    del src, tar_lbl, tar_bbox
    torch.cuda.empty_cache()

    # 2. the bit-parity train step at batch 10: crop_faces with no host
    # sync, the first step on three paths, then POSE_STEPS steps
    batch = pose_batch(cfg, POSE_BATCH, seed=8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        faces = crop_faces(batch["tar_img"], batch["tar_lbl"])
        boxes = get_face_bbox(batch["tar_lbl"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = crop_faces(batch["tar_img"].cpu(), batch["tar_lbl"].cpu())
    crop = {"shape": list(faces.shape),
            "vs_cpu_max_abs": (faces.cpu() - want).abs().max().item(),
            "boxes_yc_xc_side": [b.tolist() for b in boxes]}
    check(tuple(faces.shape) == (POSE_BATCH, hw // 4, hw // 4, 3)
          and crop["vs_cpu_max_abs"] <= CROP_TOL,
          f"pose: crop_faces on the card: {crop}")
    print(f"[pose] crop_faces under sync debug mode 'error' (no host sync): "
          f"{json.dumps(crop)}", flush=True)
    del faces, want

    state, step = pose_first_step(cfg, batch, launched)

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    history, step_ms = [], []
    for _ in range(POSE_STEPS):
        t0 = time.perf_counter()
        _, metrics, rec = step(state, batch, TRAIN_LR)
        history.append({k: v.item() for k, v in metrics.items()})
        step_ms.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    launched.update(launches)
    per_step = {k: v / POSE_STEPS for k, v in launches.items() if v}
    check(per_step == {k: 1 for k in TRAIN_KERNELS},
          f"pose: launches per step {per_step}")
    check(all(np.isfinite(v) for h in history for v in h.values()),
          "pose: non-finite metric")
    bg = torch.as_tensor(-cfg.img_mean_array() / 255.0, device="cuda")
    check(bool((rec[:, :, :hw // 4] == bg).all()),
          "pose: train reconstruction's background columns")
    vgg = [h["G_VGG"] for h in history]
    check(np.mean(vgg[-5:]) < np.mean(vgg[:5]),
          f"pose: G_VGG did not fall: {vgg}")
    train = {"ms_per_step": float(np.mean(step_ms[1:])),
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches_per_step": per_step,
             "g_vgg_first5": float(np.mean(vgg[:5])),
             "g_vgg_last5": float(np.mean(vgg[-5:])),
             "gf_vgg_first5": float(np.mean([h["GF_VGG"]
                                             for h in history[:5]])),
             "gf_vgg_last5": float(np.mean([h["GF_VGG"]
                                            for h in history[-5:]]))}
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    timed = make_train_step(state, mark=mark)
    mark("start")
    timed(state, batch, TRAIN_LR)
    torch.cuda.synchronize()
    train["stage_ms"] = {name: marks[i - 1][1].elapsed_time(ev)
                         for i, (name, ev) in enumerate(marks) if i}
    print(f"[pose] {POSE_STEPS} bit-parity steps at batch {POSE_BATCH}: "
          f"{json.dumps(train)}; metrics of the last step "
          f"{json.dumps(history[-1])} | {line}", flush=True)
    report["train"] = train

    # 3. the trained state saved and restored, netDF and its moments too
    # (before the fast tier, so that the two states are not held at once)
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pose_",
                                     dir=root) as tmp:
        snap = os.path.join(tmp, f"TSNet_S{state.step:06d}.msgpack")
        t0 = time.perf_counter()
        save_checkpoint(snap, state)
        snapshot = {"save_s": time.perf_counter() - t0,
                    "bytes": os.path.getsize(snap)}
        del step, timed
        torch.cuda.empty_cache()
        fresh = create_train_state(cfg, device="cuda", seed=1)
        t0 = time.perf_counter()
        restore_checkpoint(snap, fresh)
        torch.cuda.synchronize()
        snapshot["restore_s"] = time.perf_counter() - t0
    bad = _train_state_equal(state, fresh)
    groups = [grp["name"] for grp in fresh.disc_opt.param_groups]
    df_moments = all("exp_avg" in fresh.disc_opt.state[p]
                     for p in fresh.mods.netDF.parameters())
    check(not bad and groups == ["netD", "netDF"] and df_moments,
          f"pose: restored state differs: {bad[:8]}, groups {groups}, "
          f"netDF moments {df_moments}")
    print(f"[pose] snapshot: {json.dumps(snapshot)}, restored bit for bit "
          f"with netDF and its Adam moments | {line}", flush=True)
    report["snapshot"] = snapshot
    del state, fresh
    torch.cuda.empty_cache()

    # 4. the fast pose train tier on the same batch
    fast = create_train_state(dataclasses.replace(cfg, **FAST_TIER),
                              device="cuda", seed=0)
    fstep = make_train_step(fast)
    cuda_build.reset_launches()
    _, metrics, _ = fstep(fast, batch, TRAIN_LR)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    check(all(launches[k] == 1 for k in TRAIN_KERNELS)
          and sum(launches.values()) == 3,
          f"pose: fast tier's launches {launches}")
    check(all(bool(torch.isfinite(v)) for v in metrics.values()),
          "pose: fast tier metric")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TIER_STEPS):
        fstep(fast, batch, TRAIN_LR)
    torch.cuda.synchronize()
    report["fast_train"] = {
        "ms_per_step": 1e3 * (time.perf_counter() - t0) / TIER_STEPS,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    launched.update(cuda_build.LAUNCHES)
    del fast, fstep
    torch.cuda.empty_cache()
    tiers = {"bit_parity": {}, "high": dict(precision="high"),
             "fast": FAST_TIER}
    cos = {}
    for temp in (100.0, 10.0):
        grads = {name: pose_g_grad(dataclasses.replace(
            cfg, softmax_temp=temp, **over), batch)
            for name, over in tiers.items()
            if any(t == temp and name in case
                   for case, t, _ in POSE_COS_CASES)}
        for case, t, _ in POSE_COS_CASES:
            if t == temp:
                a, b = case.split("_vs_")
                cos[f"{case}_temp{t:g}"] = cosine(grads[a], grads[b])
        del grads
    report["fast_train"].update(grad_cosines=cos,
                                jax_package_fast_vs_high=POSE_JAX_COSINE)
    print(f"[pose] fast train tier (precision high, bwd_precision default, "
          f"fast_tail) at batch {POSE_BATCH}: {json.dumps(report['fast_train'])}"
          f" against bit-parity {train['ms_per_step']:.2f} ms/step | {line}",
          flush=True)
    low = {k: v for k, v in cos.items() if not np.isfinite(v) or any(
        held and k == f"{case}_temp{t:g}" and v < POSE_COS_FLOOR
        for case, t, held in POSE_COS_CASES)}
    check(not low, f"pose: generator-gradient cosines below "
          f"{POSE_COS_FLOOR}: {low}")
    del batch
    torch.cuda.empty_cache()
    report["launches"] = dict(launched)
    return report


def _face_landmarks(rng, cx, cy, r) -> np.ndarray:
    """A plausible 68-point layout (an ellipse jaw and feature clusters,
    as tests/test_train_loop.py draws it)."""
    t = np.linspace(np.pi * 0.1, np.pi * 0.9, 17)
    jaw = np.stack([cx + r * np.cos(t + np.pi / 2) * 1.2,
                    cy + r * np.sin(t)], 1)
    rest = rng.uniform(-r * 0.5, r * 0.5, (51, 2)) + [cx, cy - r * 0.2]
    return np.concatenate([jaw, rest])


def write_face_dataset(root: str, seed: int = 0) -> tuple[str, str]:
    """LOOP_VIDEOS videos of LOOP_FRAMES seeded-noise PNG frames at
    LOOP_HW^2, written by the port's own PNG writer, and a landmark file
    each; face widths of 140-200 px, so the jittered crops (2x the face)
    both shrink and grow to 256^2."""
    rng = np.random.default_rng(seed)
    lbl_root, img_root = os.path.join(root, "labels"), os.path.join(
        root, "images")
    for vid in range(LOOP_VIDEOS):
        os.makedirs(os.path.join(lbl_root, f"vid{vid:02d}"))
        os.makedirs(os.path.join(img_root, f"vid{vid:02d}"))
        r = 60 + 4 * vid
        for f in range(LOOP_FRAMES):
            kp = _face_landmarks(rng, 160 + 2 * f, 170 - f, r)
            np.savetxt(os.path.join(lbl_root, f"vid{vid:02d}",
                                    f"{f:03d}.txt"), kp, delimiter=",")
            write_png(os.path.join(img_root, f"vid{vid:02d}", f"{f:03d}.png"),
                      rng.integers(0, 256, (LOOP_HW, LOOP_HW, 3), np.uint8))
    return lbl_root, img_root


def tier_grad(cfg, batch: dict, use_kernels: bool = True,
              seed: int = 0) -> tuple[torch.Tensor, float]:
    """The full generator's gradient of mean|rec - tar| + 1e-3 warp
    loss (tests/test_fast_tail_train.py's loss) from the seeded weights,
    as one float64 vector, and the peak device memory of that pass (GB)."""
    mods = TSNetModules(cfg, device="cuda", seed=seed, train=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = tsnet_forward(mods, *(batch[k] for k in FORWARD_KEYS),
                        tar_img=batch["tar_img"], train=True,
                        use_kernels=use_kernels)
    ((out["rec_img"] - batch["tar_img"]).abs().mean()
     + 1e-3 * out["loss_warp"]).backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    grad = torch.cat([p.grad.flatten() for name in GEN_SUBNETS
                      for p in getattr(mods, name).parameters()
                      if p.grad is not None]).double()
    del mods, out
    torch.cuda.empty_cache()
    return grad, peak


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.dot(a, b) / (a.norm() * b.norm()))


def train_tiers(line: str) -> dict:
    """The fast train tier at full width and batch 15: its two gradient
    fidelity checks from one seeded state and one batch (kernel path, the
    plain path's beside it), TIER_STEPS timed steps of it and of the
    bit-parity tier, and remat's peak memory and gradients."""
    base = face_config()
    batch = train_batch(base, TRAIN_BATCH, seed=5)
    high = dataclasses.replace(base, precision="high")
    cases = {
        # bwd_precision "default" against None, both "high", f32 tail
        "bwd_default_vs_none": (dataclasses.replace(
            high, bwd_precision="default"), high),
        # fast_tail on against off, both "high" + "default" backward
        "fast_tail_vs_f32_tail": (dataclasses.replace(base, **FAST_TIER),
                                  dataclasses.replace(
                                      high, bwd_precision="default")),
    }
    report = {}
    for name, (cfg_a, cfg_b) in cases.items():
        cos = {}
        for path, use_kernels in (("kernel", True), ("plain", False)):
            ga, _ = tier_grad(cfg_a, batch, use_kernels)
            gb, _ = tier_grad(cfg_b, batch, use_kernels)
            cos[path] = cosine(ga, gb)
            del ga, gb
        report[name] = cos
        check(cos["kernel"] >= GRAD_COS_FLOOR,
              f"loop: {name} gradient cosine {cos} below {GRAD_COS_FLOOR}")

    # remat: peak memory of one gradient pass, and its gradient against
    # the plain path's own spread under a 1e-6 input nudge
    g_kernel, peak = tier_grad(base, batch)
    g_remat, peak_remat = tier_grad(dataclasses.replace(base, remat=True),
                                    batch)
    g_plain, _ = tier_grad(base, batch, use_kernels=False)
    gen = torch.Generator().manual_seed(3)
    nudged = dict(batch)
    for k in ("src_img", "tar_img"):
        nudged[k] = batch[k] * (1 + INPUT_NUDGE * torch.randn(
            batch[k].shape, generator=gen).to(batch[k].device))
    g_nudged, _ = tier_grad(base, nudged, use_kernels=False)
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    report["remat"] = {
        "peak_gb": peak, "peak_gb_remat": peak_remat,
        "grad_rel_l2_remat_vs_kernel": rel(g_remat, g_kernel),
        "grad_rel_l2_kernel_vs_plain": rel(g_kernel, g_plain),
        "grad_rel_l2_nudged_plain_vs_plain": rel(g_nudged, g_plain)}
    del g_kernel, g_remat, g_plain, g_nudged
    r = report["remat"]
    check(r["peak_gb_remat"] < r["peak_gb"],
          f"loop: remat does not lower peak memory: {r}")
    check(r["grad_rel_l2_remat_vs_kernel"] <= max(
        STEP_GRAD_RTOL, NUDGE_MARGIN * r["grad_rel_l2_nudged_plain_vs_plain"]),
          f"loop: remat gradients beyond the nudged plain path's spread: {r}")

    # TIER_STEPS train steps of each tier on the fixed batch, in turns
    ms = {}
    for tier, cfg in (("fast", dataclasses.replace(base, **FAST_TIER)),
                      ("bit-parity", base)):
        state = create_train_state(cfg, device="cuda", seed=0)
        step = make_train_step(state)
        step(state, batch, TRAIN_LR)                 # warm-up (cuDNN plans)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        for _ in range(TIER_STEPS):
            _, metrics, _ = step(state, batch, TRAIN_LR)
        vals = [v.item() for v in metrics.values()]
        torch.cuda.synchronize()
        ms[tier] = 1e3 * (time.perf_counter() - t0) / TIER_STEPS
        ms[f"{tier}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        per_step = {k: v / TIER_STEPS for k, v in cuda_build.LAUNCHES.items()
                    if v}
        check(all(np.isfinite(vals)), f"loop: {tier} tier metrics {vals}")
        check(per_step == {k: 1 for k in TRAIN_KERNELS},
              f"loop: {tier} tier launches per step {per_step}")
        del state, step
        torch.cuda.empty_cache()
    report["ms_per_step"] = ms
    print(f"[loop] train tiers at batch {TRAIN_BATCH}: {json.dumps(report)} "
          f"| {line}", flush=True)
    return report


def clip_inference_check(line: str, gen_tree: dict, lbl_root: str,
                         img_root: str) -> dict:
    """`ClipInference` on a 64-frame clip cut from the dataset, in the
    bit-parity and bench tiers: bit for bit against `tsnet_forward_clip`
    over the same 32-frame chunks, `run_renormalized` against its plain
    path, launches per chunk, and the metrics on the card against the
    same calls on the CPU."""
    base = face_config()
    ds = FaceDatasetTrain(lbl_root, img_root, mean=base.img_mean_array(),
                          n_frame_total=LOOP_FRAMES, is_jitter=False,
                          is_mirror=False, rng=random.Random(0))
    samples = [ds[i] for i in range(CLIP_FRAMES // LOOP_FRAMES + 1)]
    imgs = np.concatenate([x["img"] for x in samples])[:CLIP_FRAMES + 3]
    lbls = np.concatenate([x["lbl"] for x in samples])[:CLIP_FRAMES + 3]
    boxes = np.concatenate([x["bbox"] for x in samples])[:CLIP_FRAMES + 3]
    src = (imgs[:3], lbls[:3], boxes[:3].astype(np.float32))
    tar_lbl, tar_bbox = lbls[3:], boxes[3:].astype(np.float32)
    bench = dataclasses.replace(base, precision="high", fast_tail=True,
                                fast_trunk=True)
    report = {}
    for tier, cfg, warp_kernel in (
            ("bit-parity", base, "transform_warp_pairs_nf"),
            ("bench", bench, "transform_warp_pairs_mean")):
        clip = ClipInference(cfg, gen_tree, chunk=CHUNK)
        plain = ClipInference(cfg, gen_tree, chunk=CHUNK, use_kernels=False)
        clip.run(*src, tar_lbl[:CHUNK], tar_bbox[:CHUNK])   # warm-up
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        got = clip.run(*src, tar_lbl, tar_bbox)
        run_ms = 1e3 * (time.perf_counter() - t0)
        launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
        chunks = CLIP_FRAMES // CHUNK
        check(launches == {warp_kernel: chunks, "instance_norm_mean": chunks},
              f"loop: ClipInference {tier} launches {launches}")
        src_dev = clip.prepare_sources(*src)
        onehot = F.one_hot(torch.as_tensor(tar_lbl, device="cuda").long(),
                           cfg.label_nc).float()
        bbox = torch.as_tensor(tar_bbox, device="cuda")
        with torch.inference_mode():
            want = torch.cat([tsnet_forward_clip(
                clip.mods, *src_dev, onehot[lo:lo + CHUNK],
                bbox[lo:lo + CHUNK]) for lo in range(0, CLIP_FRAMES, CHUNK)])
        want = want.permute(0, 3, 1, 2).cpu().numpy()
        check(np.array_equal(got, want),
              f"loop: ClipInference {tier} differs from tsnet_forward_clip")
        renorm = clip.run_renormalized(*src, tar_lbl, tar_bbox)
        renorm_plain = plain.run_renormalized(*src, tar_lbl, tar_bbox)
        err = np.abs(renorm - renorm_plain)
        res = {"run_ms_64_frames": run_ms,
               "launches_per_chunk": {k: v / chunks
                                      for k, v in launches.items()},
               "renorm_vs_plain_max_abs": float(err.max()),
               "renorm_vs_plain_mean_abs": float(err.mean())}
        if tier == "bit-parity":
            check(res["renorm_vs_plain_max_abs"] <= 1e-3,
                  f"loop: run_renormalized kernel vs plain path {res}")
        else:
            check(res["renorm_vs_plain_mean_abs"] <= 0.01,
                  f"loop: run_renormalized kernel vs plain path {res}")
        # the metrics on the card against the same calls on the CPU, on
        # display-range images: the reconstructions against the targets;
        # relative to max(1, |value|), as the train metrics are held
        # (with random weights SSIM sits near 0, where fp32 rounding of
        # the window sums is all its relative error)
        mean = torch.as_tensor(base.img_mean_array() / 255.0)
        a = torch.clamp(torch.as_tensor(got).permute(0, 2, 3, 1) + mean, 0, 1)
        b = torch.clamp(torch.as_tensor(imgs[3:] / 255.0).permute(
            0, 2, 3, 1).float() + mean, 0, 1)
        for fn in (im.l1, im.psnr, im.ssim):
            cpu = float(fn(a, b))
            dev = float(fn(a.cuda(), b.cuda()))
            res[fn.__name__] = dev
            res[f"{fn.__name__}_rel_vs_cpu"] = abs(dev - cpu) / max(
                1.0, abs(cpu))
            check(res[f"{fn.__name__}_rel_vs_cpu"] <= 1e-5,
                  f"loop: {fn.__name__} on the card vs the CPU: {res}")
        report[tier] = res
        del clip, plain
        torch.cuda.empty_cache()
    print(f"[loop] ClipInference on a {CLIP_FRAMES}-frame dataset clip: "
          f"{json.dumps(report)} | {line}", flush=True)
    return report


def loop_phase(line: str, tmp: str) -> dict:
    """Training from files on disk through `cli.train_face.main` at the
    full width of face_config(), bit-parity tier, batch 15: a synthetic
    dataset written with the port's PNG writer, LOOP_STEPS steps (launch
    counts zeroed just before and read just after: one K3-flow, one K4
    and one K2 a step, nothing else), ms/step over steps 2-LOOP_STEPS
    (host clock, synchronized at step 1's end and the last step's), the
    loader's data wait as a share of the loop's wall, peak memory; then a
    resume from the final snapshot (`--restore-from --set-start`),
    checked equal to the saved state and stepped once under the profiler;
    the fast train tier (`train_tiers`) and `ClipInference`
    (`clip_inference_check`). Its files go to `tmp`: the dataset to
    `data/`, the run and its snapshots to `run/`."""
    report = {}
    t0 = time.perf_counter()
    lbl_root, img_root = write_face_dataset(os.path.join(tmp, "data"))
    report["dataset_write_s"] = time.perf_counter() - t0
    run_root = os.path.join(tmp, "run")
    args = ["--label-path", lbl_root, "--image-path", img_root,
            "--root-dir", run_root, "--batch-size", str(TRAIN_BATCH),
            "--n-frame-total", str(LOOP_FRAMES), "--n-source", "3",
            "--num-videos", str(LOOP_VIDEOS),
            "--print-freq", str(LOOP_PRINT_FREQ)]

    # steps 2..LOOP_STEPS timed between two synchronized stamps
    stamps = {}
    inner = TSNet.optimize_parameters_on

    def stamped(self, batch):
        inner(self, batch)
        if self.state.step in (1, LOOP_STEPS):
            torch.cuda.synchronize()
            stamps[self.state.step] = time.perf_counter()

    TSNet.optimize_parameters_on = stamped
    try:
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        model, timer = train_face.main(
            args + ["--final-step", str(LOOP_STEPS)])
        torch.cuda.synchronize()
        report["main_s"] = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
    finally:
        TSNet.optimize_parameters_on = inner
    per_step = {k: v / LOOP_STEPS for k, v in launches.items() if v}
    check(model.state.step == LOOP_STEPS,
          f"loop: trained to step {model.state.step}")
    check(per_step == {k: 1 for k in TRAIN_KERNELS},
          f"loop: launches per step {per_step}")
    losses = model.get_current_losses()
    check(all(np.isfinite(v) for v in losses.values()),
          f"loop: non-finite loss {losses}")
    report.update({
        "ms_per_step_2_to_last": 1e3 * (stamps[LOOP_STEPS] - stamps[1])
        / (LOOP_STEPS - 1),
        "data_wait_s": timer.data.sum, "clip_batches_s": timer.batch.sum,
        "data_wait_share": timer.data.sum / timer.batch.sum,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches_per_step": per_step, "last_losses": losses})
    snaps = os.path.join(run_root, "snapshots")
    snap = find_latest_checkpoint(snaps)
    check(os.path.basename(snap) == f"TSNet_S{LOOP_STEPS:06d}.msgpack",
          f"loop: snapshot {snap}")
    history = open(os.path.join(run_root, "history.csv")).read()
    check(len(history.splitlines()) == 1 + LOOP_STEPS // LOOP_PRINT_FREQ,
          f"loop: history.csv {history!r}")
    print(f"[loop] {LOOP_STEPS} steps through cli.train_face at batch "
          f"{TRAIN_BATCH}: {json.dumps(report)} | {line}", flush=True)

    # resume: the snapshot restores to the exact state, then one step
    fresh = create_train_state(face_config(), device="cuda", seed=7)
    restore_checkpoint(snap, fresh)
    bad = _train_state_equal(model.state, fresh)
    check(not bad, f"loop: restored state differs: {bad[:8]}")
    gen_tree = export_flax_params(model.mods)
    del fresh, model
    torch.cuda.empty_cache()
    cuda_build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]):
        resumed, _ = train_face.main(
            args + ["--final-step", str(LOOP_STEPS + 1), "--set-start",
                    "--restore-from", snap])
        torch.cuda.synchronize()
    launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    check(resumed.state.step == LOOP_STEPS + 1,
          f"loop: resumed to step {resumed.state.step}")
    check(launches == {k: 1 for k in TRAIN_KERNELS},
          f"loop: the resumed step's launches (profiled) {launches}")
    report["resume"] = {"step": resumed.state.step,
                        "launches_profiled_step": launches}
    del resumed
    torch.cuda.empty_cache()
    print(f"[loop] resume from {os.path.basename(snap)}: "
          f"{json.dumps(report['resume'])} | {line}", flush=True)
    report["tiers"] = train_tiers(line)
    report["clip_inference"] = clip_inference_check(
        line, gen_tree, lbl_root, img_root)
    return report


def write_face_pair(root: str, seed: int = 1) -> None:
    """A subject and a driving clip under root/{images,labels}/<clip>/:
    DEMO_FRAMES PNG frames at LOOP_HW^2 each (a colour ramp with seeded
    noise, written by the port's PNG writer) and a landmark file each,
    the two faces of different sizes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:LOOP_HW, :LOOP_HW]
    for clip, r in DEMO_FACE_R.items():
        os.makedirs(os.path.join(root, "labels", clip))
        os.makedirs(os.path.join(root, "images", clip))
        for f in range(DEMO_FRAMES):
            kp = _face_landmarks(rng, 160 + f % 7, 170 - f % 5, r + f % 3)
            np.savetxt(os.path.join(root, "labels", clip, f"{f:05d}.txt"),
                       kp, delimiter=",")
            ramp = np.stack([xx // 2 + 3 * f, yy // 2 + r, (xx + yy) // 3],
                            axis=-1)
            img = (ramp + rng.integers(0, 32, ramp.shape)) % 256
            write_png(os.path.join(root, "images", clip, f"{f:05d}.png"),
                      img.astype(np.uint8))


def gif_frames(data: bytes) -> tuple[tuple[int, int], list[int]]:
    """The (width, height) of a GIF and each frame's delay (centiseconds),
    walking its blocks (Pillow is not on every machine this runs on)."""
    check(data[:6] == b"GIF89a", f"demo: GIF header {data[:6]!r}")
    size = (data[6] | data[7] << 8, data[8] | data[9] << 8)
    flags = data[10]
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
    delays, pending = [], None

    def skip_sub_blocks(pos):
        while data[pos]:
            pos += data[pos] + 1
        return pos + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x21:                         # extension
            if data[pos + 1] == 0xF9:
                pending = data[pos + 4] | data[pos + 5] << 8
            pos = skip_sub_blocks(pos + 2)
        elif data[pos] == 0x2C:                       # image
            packed = data[pos + 9]
            pos += 10 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)
            pos = skip_sub_blocks(pos + 1)            # after the code size
            delays.append(pending)
            pending = None
        else:
            raise RuntimeError(f"chip_smoke: demo: GIF block {data[pos]:#x}")
    return size, delays


def demo_tier(line: str, tier: str, root: str, base_args: list,
              sample: dict) -> dict:
    """One tier of `cli.demo_face.main` (see `demo_phase`)."""
    extra, warp_kernel = DEMO_TIERS[tier]
    out_dir = os.path.join(root, f"out_{tier}")
    cuda_build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = demo_face.main(base_args + extra + ["--out-dir", out_dir])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    chunks = -(-DEMO_FRAMES // CHUNK)
    check(launches == {warp_kernel: chunks, "instance_norm_mean": chunks},
          f"demo {tier}: launches {launches}")

    # the reconstruction against the plain path on the same sample and
    # weights (the CLI's random init, seed 0)
    rec = res["rec"]
    cfg = dataclasses.replace(face_config(), precision="high",
                              fast_tail=bool(extra))
    hw = cfg.image_size
    check(rec.shape == (DEMO_FRAMES, 3, hw, hw) and np.isfinite(rec).all(),
          f"demo {tier}: reconstruction")
    src, tar, idx = sample["src"], sample["tar"], res["ref_idx"]
    plain = ClipInference(cfg, TSNetModules(cfg, seed=0), use_kernels=False)
    want = plain.run_renormalized(src["img"][idx], src["lbl"][idx],
                                  src["bbox"][idx], tar["lbl"], tar["bbox"])
    del plain
    err = np.abs(rec - want)
    report = {"launches": launches, "main_s": main_s,
              "frames_per_s": res["frames_per_s"],
              "montage_pngs_s": res["montage_s"],
              "gif_encode_ms": 1e3 * res["gif_s"],
              "vs_plain_mean_abs": float(err.mean()),
              "vs_plain_max_abs": float(err.max()),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    check(report["vs_plain_mean_abs"] <= DEMO_TOL,
          f"demo {tier}: kernel path vs plain path {report}")

    # each montage PNG, decoded by the port, against the frames it holds
    mean = face_config().img_mean_array()
    for i, name in enumerate(res["names"]):
        want_row = np.concatenate([
            to_display_rgb(src["img"][i] / 255.0, mean),
            to_display_rgb(tar["img"][i] / 255.0, mean),
            to_display_rgb(rec[i], mean)], axis=1)
        check(np.array_equal(read_png(os.path.join(out_dir, name)),
                             want_row), f"demo {tier}: montage {name}")
    with open(res["gif"], "rb") as f:
        data = f.read()
    size, delays = gif_frames(data)
    check(size == (3 * hw, hw) and delays == [10] * DEMO_FRAMES,
          f"demo {tier}: GIF of {size} with delays {delays}")
    report["gif_bytes"] = len(data)
    print(f"[demo] {tier}: {json.dumps(report)} | {line}", flush=True)
    return report


def demo_phase(line: str, root: str, snapshot_dir: str,
               fps: dict) -> dict:
    """The face test-time workflow at the full width of face_config():
    `cli.demo_face.main` on a synthetic subject/driving pair
    (`write_face_pair`) in its default tier (K3-nf) and with
    `--fast-tail` (K1), launch counts zeroed just before each and read
    just after (one warp kernel and one K2 a chunk, nothing else), its
    reconstruction against the plain path, each montage PNG against its
    frames, the GIF's size, frame count and delays; `cli.eval_snapshots`
    over [loop]'s snapshots; one `cli.quick_start` step at batch 4 under
    torch.profiler (one K3-flow, K4 and K2); `cli.profile_stages` on a
    64-frame clip in the bit-parity tier (its SUM of stages held within
    STAGE_SUM_TOL of [fps]'s clip) and its default tier, and the train
    stages at batch 15. Files go to `root`."""
    report = {}
    data_root = os.path.join(root, "data")
    t0 = time.perf_counter()
    write_face_pair(data_root)
    report["dataset_write_s"] = time.perf_counter() - t0
    base_args = ["--data-root", data_root, "--subject", "subject",
                 "--driving", "driving", "--max-frames", str(DEMO_FRAMES),
                 "--chunk", str(CHUNK)]
    paths = [os.path.join(data_root, kind, clip)
             for clip in DEMO_FACE_R for kind in ("images", "labels")]
    t0 = time.perf_counter()
    hw = face_config().image_size
    sample = FaceDatasetTest(*paths, img_size=(hw, hw),
                             max_frame_num=DEMO_FRAMES)[0]
    report["test_set_load_s"] = time.perf_counter() - t0
    for tier in DEMO_TIERS:
        report[tier] = demo_tier(line, tier, root, base_args, sample)
        torch.cuda.empty_cache()

    # eval_snapshots over the loop's snapshots, the subject clip as data
    snaps = sorted(f for f in os.listdir(snapshot_dir)
                   if f.endswith(".msgpack"))
    t0 = time.perf_counter()
    rows = eval_snapshots.main(["--snapshot-dir", snapshot_dir,
                                "--data-root", data_root, "--subject",
                                "subject", "--out-dir",
                                os.path.join(root, "eval")])
    report["eval"] = {"snapshots": snaps, "rows": rows,
                      "main_s": time.perf_counter() - t0}
    check(len(rows) == len(snaps) >= 1
          and all(np.isfinite([r[k] for k in ("l1", "psnr", "ssim")]).all()
                  for r in rows), f"demo: eval_snapshots rows {rows}")
    csv = open(os.path.join(root, "eval", "eval_metrics.csv")).read()
    check(len(csv.splitlines()) == 1 + len(snaps),
          f"demo: eval_metrics.csv {csv!r}")
    print(f"[demo] eval_snapshots: {json.dumps(report['eval'])} | {line}",
          flush=True)
    torch.cuda.empty_cache()

    # quick_start: one step at batch 4, 256^2, under the profiler
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        model = quick_start.main([])
        torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    losses = model.get_current_losses()
    check(launches == {k: 1 for k in TRAIN_KERNELS},
          f"demo: quick_start launches {launches}")
    check(all(np.isfinite(v) for v in losses.values()),
          f"demo: quick_start losses {losses}")
    model.optimize_parameters()                    # one more, timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.optimize_parameters()
    torch.cuda.synchronize()
    report["quick_start"] = {
        "launches_profiled": launches, "main_s": main_s,
        "ms_per_step": 1e3 * (time.perf_counter() - t0),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": losses}
    del model
    torch.cuda.empty_cache()
    print(f"[demo] quick_start: {json.dumps(report['quick_start'])} | "
          f"{line}", flush=True)

    # profile_stages: the clip in the bit-parity tier against [fps]'s
    # clip, the CLI's default tier, and the train stages
    stages = {}
    for name, argv in (("bit-parity", ["--precision", "highest",
                                       "--no-fast-tail"]),
                       ("default", [])):
        print(f"[demo] profile_stages {name}:", flush=True)
        stages[name] = profile_stages.main(
            ["--frames", str(CLIP_FRAMES)] + argv)
        torch.cuda.empty_cache()
    ratio = stages["bit-parity"]["sum_ms"] / fps["bit-parity"]["clip_ms"]
    stages["bit-parity"]["sum_over_fps_clip"] = ratio
    stages["default"]["sum_over_bench_fps_clip"] = (
        stages["default"]["sum_ms"] / fps["bench"]["clip_ms"])
    check(abs(ratio - 1.0) <= STAGE_SUM_TOL,
          f"demo: profile_stages SUM {stages['bit-parity']['sum_ms']:.2f} ms "
          f"against [fps]'s bit-parity clip {fps['bit-parity']['clip_ms']:.2f}")
    print("[demo] profile_stages --train:", flush=True)
    stages["train"] = profile_stages.main(["--train", "--batch-size",
                                           str(TRAIN_BATCH)])
    torch.cuda.empty_cache()
    report["profile_stages"] = stages
    print(f"[demo] profile_stages: {json.dumps(stages)} | {line}", flush=True)
    return report


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
    if sys.argv[1:] == ["--pose"]:
        t0 = time.perf_counter()
        pose_phase(line)
        print(f"[pose] phase {time.perf_counter() - t0:.1f} s", flush=True)
        return 0
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
    report["pose"] = pose_phase(line)
    print(f"[pose] phase {time.perf_counter() - t0:.1f} s | {line}",
          flush=True)
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_loop_",
                                     dir=root) as tmp:
        t0 = time.perf_counter()
        report["loop"] = loop_phase(line, tmp)
        print(f"[loop] phase {time.perf_counter() - t0:.1f} s; ms/step "
              f"over steps 2-{LOOP_STEPS} from disk "
              f"{report['loop']['ms_per_step_2_to_last']:.2f} against "
              f"[train]'s fixed batch {report['train']['ms_per_step']:.2f} | "
              f"{line}", flush=True)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_demo_",
                                         dir=root) as demo_root:
            t0 = time.perf_counter()
            report["demo"] = demo_phase(
                line, demo_root, os.path.join(tmp, "run", "snapshots"),
                {tier: report[tier] for tier in ("bit-parity", "bench")})
            print(f"[demo] phase {time.perf_counter() - t0:.1f} s | {line}",
                  flush=True)
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
    # each kernel's check at the pose train shape (G=10; K2 f32 at
    # (3, 10, 32, 32, 1024))
    pose_rows = {"transform_warp_pairs": "transform_warp_pairs",
                 "transform_warp_pairs_bwd": "transform_warp_pairs_bwd",
                 "instance_norm_mean_f32": "instance_norm_mean_pose_f32"}
    for name, k in kernels.items():
        # K2 is one kernel: its row is the f32 form, on the bit-parity
        # clip path (the bf16 form is checked and printed above); K7's row
        # is its relu form (the skip form is checked and printed above)
        if k.get("tier") is None or name == "instance_norm_mean_bf16":
            continue
        launch = ("instance_norm_mean" if name.startswith("instance_norm_mean")
                  else k.get("launch", name))
        row = {
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": report[k["tier"]]["launches"][launch],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k.get("library_ms"),
            "pose_launches": report["pose"]["launches"].get(launch, 0)}
        if name in pose_rows:
            at = report["pose"]["kernels"][pose_rows[name]]
            row["pose"] = {key: at[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
