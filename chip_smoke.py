#!/usr/bin/env python3
"""Correctness run of the PyTorch port (`wacv23_tsnet_tpu_torch`) on one
GPU.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU, nvcc and the repository around it; exits
non-zero, printing no result, where CUDA or the package is missing. It
holds the port at full width on the card and times nothing end to end:
the benchmark (`benchmark/run.py`) measures the cells, and
`cli.profile_stages` prints the port's stage spans. In the order it runs:

1. Prints the card's name and power limit and the torch/CUDA versions.
2. Builds every CUDA kernel from `wacv23_tsnet_tpu_torch/csrc/` (one nvcc
   per source, all started together), prints ptxas's resource lines and
   the sha256 of K6's output bits on two seeded inputs.
3. `[kernel]`: each kernel against its plain PyTorch version at the main
   path's shapes (S=3 sources, T=32x32 pixels, C=512, F=32 frames; K2 at
   (3, 32, 32, 32, 1024) and, past its cluster, (3, 8, 64, 64, 1024); K6
   at S=3, F=32, 32x32, K=1024; K7 with relu and with skip at
   (32, 32, 32, 512), and at the clip's B=64), then K3-flow (warped
   features and flow, temp 100) and K4 (six cotangents at temps 10 and
   100, against the plain version in fp32 and in float64, and given the
   plain version's own flow; two calls the same bits) at the train shape
   (G=15, NS=3, NF=1, T=32x32, C=512). Each prints the kernel's ms and
   its plain version's, by CUDA events: PERF.md's kernel table.
4. `[high]`: `precision="high"` (bf16x3) through `conv2d_dp` at the
   model's conv shapes and the train batch, forward, grad-input and
   grad-weight within 1e-5 relative L2 of a float64 oracle of the same
   three bf16 products; at the 7x7 stem also the folded conv that the
   encoders run under "high", held the same way.
5. `[main]`: `face_config()` with seeded random weights in the bit-parity
   and bench ("high" + fast_tail + fast_trunk) tiers: `tsnet_forward_clip`
   over a 64-frame clip and four 32-frame `RetargetSession.push_labels`
   requests (one with output="display"), the tier's kernels counted,
   against the plain path and the clip over the same chunks; then
   `bench+fused` (K6 in FuseNet under TSNET_FUSE_PAIR_KERNEL=1, set for
   that tier only; K7 in the decoder), a clip and two
   `decode_with_sources` requests on one source pack, launches counted
   per decode call. `[tiers]`: how far the bench tier and "high" +
   fast_tail move the clip from the bit-parity tier (the latter held
   within 0.01 mean L1).
6. `[train]`: the GAN train step, bit-parity, batch 15: the first step
   from one seeded state through the kernels, the plain versions and the
   plain versions on nudged inputs (metrics and per-subnet gradients, at
   temps 10 and 100), then 10 steps (one K3-flow, K4 and K2 a step; the
   metrics finite; G_VGG falls).
7. `[serve]`: that state saved as a trainer snapshot (flax msgpack) and
   restored bit for bit, the generator as a reference `.pth` and loaded
   bit for bit; the keypoint rasterizer on the card against its CPU run;
   per tier (bench, bit-parity) the snapshot served by `cli.serve.Server`
   on 127.0.0.1 from a thread: a 64-frame base64 request (one warp kernel
   and one K2 a chunk) and a 2-frame int-list request within 1 LSB of an
   in-process `push_keypoints`, the model-space kernel path against the
   plain path, 2 frames alone against the same frames in a 32-frame
   chunk, one request through the server's stages in this process.
8. `[determinism]`: the face bit-parity step (batch 15), the pose
   bit-parity step (batch 10) and the face fast train tier, each called
   on two `copy.deepcopy`s of one seeded state: every gradient, updated
   parameter, Adam moment, metric and the reconstruction bit-equal.
9. `[pose]`: `pose_config()` (label_nc=25, netD and netDF) with seeded
   one-hot pose label maps: K3-flow and K4 at G=10 and K2 at
   (3, 10, 32, 32, 1024); a 64-frame clip per tier against the plain path
   (background columns exact) and a 32-frame session request;
   `crop_faces` with no host sync (card against CPU); the first step at
   batch 10 at temps 10 and 100 through the kernels, the plain versions
   and nudged plain versions (the metrics that read the updated
   discriminators held in their two parts); 20 steps; the snapshot bit
   for bit with netDF's Adam moments; the fast train tier's
   generator-gradient cosines.
10. `[pose_data]`: each committed JPEG fixture decoded to its manifest's
   sha256 (Pillow's decode; the card's machine has none), a synthetic
   dance set, `cli.train_pose` 14 steps from step 86 (launches a step,
   the image shot's label colours, the snapshot), `cli.eval_snapshots
   --task pose`, `cli.demo_pose` on a same-build and a cross-build pair
   against the plain path (montage, GIF), `rasterize_pose_clip` on the
   card bit-equal to the CPU, pose `Server` in two tiers.
11. `[parallel]`: a (1, 1) NCCL mesh in this process (the step and both
   clip tiers bit for bit against one process), then two `spawn_ranks`
   ranks on the one card over gloo: the (2, 1) step at batch 16, the
   (1, 2) TP+SP plain clip, TP kernel clip and `bench+fused` under TP,
   launches counted per rank. One card measures no scaling.
12. `[loop]`: `cli.train_face` on a synthetic dataset (15 videos x 10 PNG
   frames at 320^2) for 14 steps (one K3-flow, K4 and K2 a step), the
   snapshot restored equal, a resume stepped once under torch.profiler;
   the fast train tier's two gradient cosines (>= 0.99) and its steps
   beside the bit-parity tier's; `remat`'s peak memory (lower) and
   gradients; `ClipInference` bit for bit against `tsnet_forward_clip`
   per 32-frame chunk in both tiers, the metrics card against CPU.
13. `[demo]`: `cli.demo_face` on a synthetic subject/driving pair in its
   default tier (K3-nf) and with `--fast-tail` (K1), against the plain
   path (0.01 mean L1), its montage PNGs and GIF; `cli.eval_snapshots`
   over `[loop]`'s snapshots; `cli.quick_start` under torch.profiler (one
   K3-flow, K4 and K2); `cli.profile_stages` on a 64-frame clip and on
   the train step at batch 15, in the bit-parity and default tiers, each
   stage span once a call or step. `[tools]`: `cli.plot_history`.
14. K5, which no model path reaches, and K8 through their own entry
   points, each call exactly one launch: K5 through
   `transformation_warp(use_kernels=True)` at B=15, 32x32, C=512 (temps
   100 and 10, the five input gradients), and K8 `instance_norm_fused` at
   (32, 256, 256, 64) and, with `phase_groups=4`, (32, 128, 128, 256),
   bf16 and f32, relu on and off (its forced three-launch path too; the
   phase identity with `space_to_depth`), then bf16 at the phase
   decoder's norms of a 64-frame face chunk (a block's two, the three up
   stages), against the ATen composition the decoder runs without it,
   each with its ms beside the composition's, and its fp32 two-pass form
   at the encoders' norms of that chunk (the label encoder's stem, folded
   stem and stride-2 convs, an image-encoder block) against its plain
   version and the composition, a check. Every instance norm of the
   generator's inference on the card in a bf16 subnet, or an fp32 one at
   "high", runs through K8 (`nn.blocks.norms_on_k8`), so the main paths'
   launch checks count K8 too, from the config (`clip_k8`): 11 a decode
   call for the face config's decoder, 3 with K7's blocks
   (`bench+fused`), one for FuseNet's pair norm without K6, and with
   "high" encoders (not `fast_trunk`) 4 a decode call for the label
   encoder and 22 an encode of the sources; none in training or at
   "highest" (the bit-parity tier).
15. `[sweep]`: `cli.bench_sweep.main([])` at full width (one K1 and one K2
   a clip call), K1 at (S, F) = (1, 64), (5, 64) and (3, 128), the clip
   at S=5, F=128 against its plain path; `[zoo]`: the zoo's generators,
   discriminators and WGAN-GP penalty at 256², card against CPU.
16. `[rewrites]`: the phase-decomposed decoder against the plain `Decoder`
   in the bit-parity, bench and `bench+fused` tiers and in the train
   step, `encoder_apply_fast` against `lbl_enc`, `ring_pad` on against
   off (first-step metrics; the clip at temps 10 and 100), and the native
   `draw_edge` against its numpy tier on one pose clip.
17. Prints one `kernels` JSON line (each kernel's error, ms and plain ms,
   and its launches on each phase's path), the card line again, and last
   `{"ok": true, "device": {...}}`.

Modes that run a part alone:

    python3 chip_smoke.py --high             # step 4, no kernel build
    python3 chip_smoke.py --determinism      # step 8, and two steps with
                                             # cuDNN's default flags
    python3 chip_smoke.py --pose             # steps 9 and 10
    python3 chip_smoke.py --parallel         # step 3's kernel checks,
                                             # steps 11 and 15
    python3 chip_smoke.py --rewrites         # step 16
    python3 chip_smoke.py --norms            # step 14's K8 cases
    python3 chip_smoke.py --pose-first-step  # [pose]'s first step with the
                                             # plain Decoder, then the
                                             # phase-decomposed decoder
"""

from __future__ import annotations

import base64
import collections
import contextlib
import copy
import dataclasses
import hashlib
import io
import json
import math
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
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from wacv23_tsnet_tpu_torch.cli import (bench_sweep, demo_face, demo_pose,
                                        eval_snapshots, plot_history,
                                        profile_stages, quick_start,
                                        smooth_keypoints, train_face,
                                        train_pose)
from wacv23_tsnet_tpu_torch.cli.demo_face import load_params
from wacv23_tsnet_tpu_torch.cli.serve import Server, make_handler
from wacv23_tsnet_tpu_torch.compat import (export_flax_params,
                                           save_reference_checkpoint)
from wacv23_tsnet_tpu_torch.configs import face_config, pose_config
from wacv23_tsnet_tpu_torch.data.codecs import POSE_PALETTE, labels_to_image
from wacv23_tsnet_tpu_torch.data.datasets import (FaceDatasetTest,
                                                  FaceDatasetTrain,
                                                  PoseDatasetTest)
from wacv23_tsnet_tpu_torch.data.image_io import read_png, read_rgb, write_png
from wacv23_tsnet_tpu_torch.data.rasterize import (render_openpose,
                                                  valid_keypoints)
from wacv23_tsnet_tpu_torch.data.rasterize_device import (rasterize_face_clip,
                                                          rasterize_pose_clip)
from wacv23_tsnet_tpu_torch.infer import (ClipInference, RetargetSession,
                                          to_display_rgb)
from wacv23_tsnet_tpu_torch.infer import metrics as im
from wacv23_tsnet_tpu_torch.losses import (feature_matching_loss,
                                           gradient_penalty, lsgan_loss,
                                           vgg_perceptual_loss)
from wacv23_tsnet_tpu_torch.models import (TSNet, TSNetModules,
                                           tsnet_forward, tsnet_forward_clip)
from wacv23_tsnet_tpu_torch.models import tsnet as tsnet_module
from wacv23_tsnet_tpu_torch.models.tsnet import (crop_faces, decode,
                                                 decode_with_sources,
                                                 encode_sources,
                                                 get_face_bbox,
                                                 label_features, propagate)
from wacv23_tsnet_tpu_torch.nn import (VideoDiscriminator, define_D, define_G,
                                       encoder_apply_fast, fuse_clip)
from wacv23_tsnet_tpu_torch.ops import conv_kernels as ck
from wacv23_tsnet_tpu_torch.ops import cuda_build
from wacv23_tsnet_tpu_torch.ops import dpconv as dp
from wacv23_tsnet_tpu_torch.ops import flow_kernels as fl
from wacv23_tsnet_tpu_torch.ops import fuse_kernels as fk
from wacv23_tsnet_tpu_torch.ops import norm_kernels as nk
from wacv23_tsnet_tpu_torch.ops import stemconv as sc
from wacv23_tsnet_tpu_torch.ops import warp_kernels as wk
from wacv23_tsnet_tpu_torch.ops.coords import normalized_grid
from wacv23_tsnet_tpu_torch.ops.norms import (instance_norm,
                                              instance_norm_one_pass,
                                              instance_norm_phase,
                                              l2_normalize)
from wacv23_tsnet_tpu_torch.ops.similarity import transformation_warp
from wacv23_tsnet_tpu_torch.ops.warp import space_to_depth
from wacv23_tsnet_tpu_torch.parallel import (init_distributed, make_mesh,
                                             make_parallel_clip_infer,
                                             make_parallel_train_step,
                                             shard_batch, shard_modules,
                                             spawn_ranks)
from wacv23_tsnet_tpu_torch.train import (GEN_SUBNETS, create_train_state,
                                          find_latest_checkpoint,
                                          make_train_step,
                                          restore_checkpoint,
                                          save_checkpoint)
from wacv23_tsnet_tpu_torch.train import step as train_step_module

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
# BWD_RTOL * max(1, max |reference|) (sums over target rows, sources and,
# for da, each source pixel's bucket in another order). At temp 10,
# K4 on K3-flow's flow against the plain version in fp32 and in float64.
# At temp 100 the flow of random features sits near pixel centres, where
# the bilinear warp's gradient jumps, and an fp32 flow (K3-flow's or the
# plain version's) crosses a cell edge that the exact flow does not on a
# row or two; each such row moves a cotangent by a few 1e-2 of its
# largest. So at temp 100 K4 is held given the plain version's own flow
# and lse, and the rest is printed with the count of such rows.
BWD_RTOL = 2e-4
TRAIN_BATCH = 15
TRAIN_STEPS = 10
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
# K5: no model path reaches it, in either package; it is driven through
# its own entry point (flow_phase), and K8 through its own as well
# (norm_phase) besides the phase decoder's norms
STANDALONE_KERNELS = ("masked_attention_flow_fused",)
STANDALONE = "standalone"
# K5's five input gradients, kernel path against plain path: the backward
# recomputes the plain composition, so they differ by rounding at most
FLOW_GRAD_RTOL = 1e-6
# K8 at the decoder's last up stage for one 32-frame request, and its 2x2
# phase layout (phase_groups=4)
K8_SHAPES = {1: (32, 256, 256, 64), 4: (32, 128, 128, 256)}
# K8 at the phase decoder's norms of a 64-frame face chunk: name -> (shape,
# phase_groups, relu); a ResNet block's two norms, the three up stages
DECODER_NORM_SHAPES = {
    "block_relu": ((64, 32, 32, 512), 1, True),
    "block": ((64, 32, 32, 512), 1, False),
    "up0": ((64, 32, 32, 1024), 4, True),
    "up1": ((64, 64, 64, 512), 4, True),
    "up2": ((64, 128, 128, 256), 4, True),
}
# K8's two-pass form at the fp32 trunk norms of a 64-frame face chunk:
# name -> (shape, phase_groups); the label encoder's stem, its folded stem
# ("high"), its stride-2 convs, the image encoder's block norm
TRUNK_NORM_SHAPES = {
    "stem": ((64, 256, 256, 64), 1),
    "folded_stem": ((64, 64, 64, 1024), 16),
    "down0": ((64, 128, 128, 128), 1),
    "down1": ((64, 64, 64, 256), 1),
    "down2": ((64, 32, 32, 512), 1),
    "image_block": ((3, 32, 32, 512), 1),
}
FORWARD_KEYS = ("src_img", "src_lbl", "src_bbox", "tar_lbl", "tar_bbox")
# the serve phase: a 64-frame base64 request in two 32-frame chunks and a
# 2-frame int-list request
SERVE_FRAMES = 64
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
TIER_STEPS = 5
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
# the JAX package compared its fast tier with "high", three bf16 passes
# on the TPU and in the port on the card (ops.dpconv.conv_bf16x3). The
# floor holds the fast tier against "high" at the config's temp, as the
# JAX package measured it, and against the bit-parity tier at temps 10
# and 100; "high" alone against bit-parity at 100 is printed
POSE_COS_CASES = (("fast_vs_high", 100.0, True),
                  ("fast_vs_bit_parity", 10.0, True),
                  ("fast_vs_bit_parity", 100.0, True),
                  ("high_vs_bit_parity", 100.0, False))
POSE_SUBNETS = GEN_SUBNETS + ("netD", "netDF")
# the G-phase metrics read through the discriminators after their first
# Adam step, which moves each weight by about its lr whatever the size
# of its gradient: where the kernel path's netDF gradient has the other
# sign from the plain path's (their relative L2 differs by ~1e-3 on the
# 64^2 crops), the weight lands 2 lr away. Some 800 of netDF's 2.76M
# weights flip so, fewer than under a 1e-6 input nudge, and which ones
# decides these metrics: one step's reading is a draw, which a decoder
# of the same function but other rounding moved from 1.5e-4 to 2.7e-4
# (GF_GAN at temp 10; the nudged paths read 4e-5 - 1.6e-4). So each is
# held in its two parts: the generator's, read through the plain path's
# updated discriminators, within STEP_METRIC_RTOL; the discriminators',
# every updated weight within D_STEP_LR_MARGIN lr of the plain path's
# (the rule of tests/test_torch_train_step.py) and their gradients'
# sign flips within NUDGE_MARGIN times the nudged paths' larger count.
# The gradients are held within STEP_GRAD_RTOL or NUDGE_MARGIN times the
# plain path's own difference under the input nudges, POSE_NUDGES, as
# the CPU train-step tests hold them
POSE_D_READ_METRICS = ("G_GAN", "G_FML", "G", "GF_GAN", "GF_FML", "GF")
POSE_NUDGES = (1e-6, 1e-5)
D_STEP_LR_MARGIN = 2.5
# crop_faces on the card against its CPU run: the card's `arange / 63`
# differs from the CPU's in the last bit of 30 of 64 values, so a sample
# position below 256 may move by its ulp, 2^-16, which the bilinear
# weights multiply by the difference of two neighbouring pixels (below 1
# for these unit-uniform images)
CROP_TOL = 1e-4
POSE_CASES = ("face", "head", "neither", "border")
# the pose data phase: a synthetic dance set of POSE_DATA_VIDEOS videos
# (ids on both sides of the datasets' female rule, id <= 91) of
# POSE_DATA_FRAMES JPEG frames (copies of the committed fixtures, which
# hold Pillow's decode in their manifest), trained through cli.train_pose
# for POSE_DATA_STEPS steps (two clip batches of 7) from step
# POSE_DATA_START, so that the loop's image shot (every 100 steps) fires;
# cli.demo_pose on a pair of one build and a pair of two (driving
# POSE_DATA_UNSEEN, smoothed by cli.smooth_keypoints), POSE_DEMO_FRAMES
# frames in one chunk, in the tiers of POSE_DEMO_TIERS
JPEG_FIXTURES = os.path.join("tests", "torch_fixtures", "jpeg")
POSE_DATA_VIDEOS = (10, 20, 30, 40, 50, 100, 110, 120, 130, 140)
POSE_DATA_FRAMES = 40
POSE_DATA_TWO_PEOPLE = 30
POSE_DATA_LOW_CONF = 120
POSE_DATA_UNSEEN = (50, 140)
POSE_DATA_PAIRS = {"same-build": "10 50", "cross-build": "110 50"}
POSE_DATA_SEX = {"same-build": "", "cross-build": "mf"}
POSE_DATA_STEPS = 14
POSE_DATA_START = 86
POSE_DEMO_FRAMES = 30
POSE_DEMO_TIERS = {"same-build": tuple(DEMO_TIERS),
                   "cross-build": ("default",)}


def decoder_k8(cfg, fused_blocks: bool = False) -> int:
    """K8's launches in one phase-decoder call of `cfg`'s decoder at
    inference: one for each instance norm (two a ResNet block, one an up
    stage; K7's blocks, bf16 only, norm inside their convs) of a bf16
    decoder (`fast_tail`) or an fp32 one at "high"; none at "highest"
    (the bit-parity tier keeps the composition)."""
    if not (cfg.fast_tail or cfg.precision == "high"):
        return 0
    fused = fused_blocks and cfg.fast_tail
    return cfg.n_downsampling + (0 if fused else 2 * cfg.dec_n_blocks)


def clip_k8(cfg, decodes: int, encodes: int, fused_blocks: bool = False,
            pair_kernel: bool = False) -> int:
    """K8's launches at inference in `decodes` decode calls (a chunk of
    driving frames) and `encodes` encodes of the sources of `cfg`: one a
    norm of the encoders where their fp32 convs run at "high" (not under
    `fast_trunk` or at "highest"), a decode call's label encoder stem and
    stride-2 convs, an encode's image encoder stem, stride-2 convs and
    two a ResNet block; FuseNet's pair norm (none where K6 takes the pair
    block, `pair_kernel`) where the decoder launches any; the decoder's
    norms (`decoder_k8`)."""
    trunk = not cfg.fast_trunk and cfg.precision == "high"
    tail = decoder_k8(cfg, fused_blocks)
    per_decode = ((1 + cfg.n_downsampling) * trunk + tail
                  + int(bool(tail) and not pair_kernel))
    per_encode = (1 + cfg.n_downsampling + 2 * cfg.enc_n_blocks) * trunk
    return decodes * per_decode + encodes * per_encode


def with_k8(want: dict, cfg, decodes: int, encodes: int,
            fused_blocks: bool = False, pair_kernel: bool = False) -> dict:
    """`want` with K8's launches in `decodes` decode calls and `encodes`
    encodes of the sources of `cfg` (`clip_k8`), where it launches any."""
    n = clip_k8(cfg, decodes, encodes, fused_blocks, pair_kernel)
    return dict(want, instance_norm_fused=n) if n else dict(want)


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
    x32 = (torch.randn(s, f, h, w, 2 * c, generator=g) * 2 + 1).to(dev)

    cases = {
        "transform_warp_pairs_mean": dict(
            kernel=lambda: wk.transform_warp_pairs_mean(
                *args, h, w, out_dtype=torch.bfloat16),
            plain=lambda: wk.transform_warp_mean_plain(
                *args, h, w, out_dtype=torch.float32),
            tol=TOL["bf16"], tier="bench",
            replaces="wacv23_tsnet_tpu/ops/pallas_similarity.py:495",
            source="wacv23_tsnet_tpu_torch/csrc/transform_warp.cu"),
        "transform_warp_pairs_mean_f32out": dict(
            kernel=lambda: wk.transform_warp_pairs_mean(*args, h, w),
            plain=lambda: wk.transform_warp_mean_plain(*args, h, w),
            tol=TOL["f32"], tier=None),
        "transform_warp_pairs_nf": dict(
            kernel=lambda: wk.transform_warp_pairs_nf(*args, h, w),
            plain=lambda: wk.transform_warp_pairs_nf_plain(*args, h, w),
            tol=TOL["f32"], tier="bit-parity",
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
    """Each case's kernel against its plain version, and the ms of each
    alone (CUDA events); prints a `[kernel]` line each."""
    results = {}
    for name, case in cases.items():
        got = case["kernel"]()
        torch.cuda.synchronize()
        res = compare(got, case["plain"](), case["tol"])
        check(res["worst_err_over_tol"] <= 1.0,
              f"{name} disagrees with its plain version: {res}")
        res["ms"] = time_ms(case["kernel"])
        res["plain_ms"] = time_ms(case["plain"], iters=3)
        res.update({k: case[k] for k in ("tier", "replaces", "source",
                                         "launch") if k in case})
        path = f" path={case['cluster']}" if "cluster" in case else ""
        results[name] = res
        print(f"[kernel] {name}: max_abs_err={res['max_abs_err']:.3e} "
              f"mean_abs_err={res['mean_abs_err']:.3e} "
              f"(atol, rtol)={case['tol']} "
              f"worst_err_over_tol={res['worst_err_over_tol']:.3f} "
              f"kernel_ms={res['ms']:.4f} "
              f"plain_ms={res['plain_ms']:.4f}{path} | {line}", flush=True)
    torch.cuda.synchronize()
    return results


def k2_case(x, tol) -> dict:
    """K2 on x (S, F, H, W, C), against its plain version in fp32."""
    h, w = x.shape[2:4]
    return dict(
        kernel=lambda: nk.instance_norm_mean(x),
        plain=lambda: nk.instance_norm_mean_plain(x, out_dtype=torch.float32),
        tol=tol, launch="instance_norm_mean", tier=None,
        cluster=(f"{nk.mean_tiles(h, w)} blocks"
                 if nk.mean_tiles(h, w) <= nk.MAX_CLUSTER else "none (two-pass)"),
        replaces="wacv23_tsnet_tpu/ops/pallas_norms.py:135",
        source="wacv23_tsnet_tpu_torch/csrc/in_mean.cu")


def k7_case(x, wc, skip, relu) -> dict:
    """K7 on x (B, H, W, C) with weight wc (relu, or + skip), against its
    plain version."""
    h, w = x.shape[1:3]
    co = wc.shape[0]
    return dict(
        kernel=lambda: ck.conv3x3_in(x, wc, skip=skip, relu=relu),
        plain=lambda: ck.conv3x3_in_plain(x, wc, skip=skip, relu=relu),
        tol=TC_TOL, launch="conv3x3_in", tier=None,
        cluster=(f"{ck.tiles(h, w)} blocks, "
                 f"{ck.max_active_clusters(h, w, co)} clusters at once"),
        replaces="wacv23_tsnet_tpu/ops/pallas_conv.py:122",
        source="wacv23_tsnet_tpu_torch/csrc/conv3x3_in.cu")


def fused_tail_cases(g) -> dict:
    """K6 at S=3, F=32, 32x32, K=Co=1024 and K7 (relu; skip) at
    (32, 32, 32, 512), bf16: the fused tier's shapes per 32-frame call."""
    dev = torch.device("cuda")
    s, f, h, w, k = 3, 32, 32, 32, 1024
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
            plain=lambda: fk.fuse_pair_conv2_plain(c1a, c1t, w2),
            tol=K6_TOL, tier=FUSED_TIER, launch="fuse_pair_conv2",
            replaces="wacv23_tsnet_tpu/ops/pallas_fuse.py:124",
            source="wacv23_tsnet_tpu_torch/csrc/fuse_pair_conv2.cu"),
        "conv3x3_in": dict(k7_case(x, wc, None, True), tier=FUSED_TIER),
        "conv3x3_in_skip": k7_case(x, wc, skip, False),
        # a 64-frame clip's decoder blocks
        "conv3x3_in_b64": k7_case(x64, wc, None, True),
    }


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


HIGH = "high"
HIGH_RTOL = 1e-5          # relative L2 against the float64 bf16x3 oracle
# the model's conv shapes at the full width of face_config() and the
# train step's batch (15 samples; FuseNet's pair block 45 = 15 x 3
# sources): x NHWC as the conv reads it (after its reflect pad), weight
# OIHW, stride, (row, column) zero padding, groups
HIGH_SHAPES = {
    "stem7x7_256": ((15, 262, 262, 5), (64, 5, 7, 7), 1, (0, 0), 1),
    "down_s2_256": ((15, 256, 256, 64), (128, 64, 3, 3), 2, (1, 1), 1),
    "resblock_512_32": ((15, 34, 34, 512), (512, 512, 3, 3), 1, (0, 0), 1),
    "fusenet_1024_32": ((45, 34, 34, 1024), (1024, 1024, 3, 3), 1, (0, 0),
                        1),
    # the phase decoder's first up stage (512 -> 256 channels at 32^2):
    # its top and bottom ring rows side by side, two groups
    "ring_rows_512": ((15, 2, 32, 1024), (2048, 512, 2, 3), 1, (0, 0), 2),
}


def folded_stem(xc, w, gc):
    """Forward, grad-input and grad-weight of the 7x7 stem's NCHW conv of
    xc and w for gc as the encoders take it under "high" on the card
    (`ops.stemconv.conv_fold`: the three bf16x3 products as a 3x3 conv
    over 16x the channels, the backward the unfolded conv's)."""
    xq = xc.permute(0, 2, 3, 1).detach().requires_grad_()
    wq = w.detach().requires_grad_()
    with torch.enable_grad():
        yq = sc.conv_fold(xq, wq, None, "high")
    gx, gw = torch.autograd.grad(yq, (xq, wq),
                                 sc.space_to_depth(gc.permute(0, 2, 3, 1), 4))
    return (sc.depth_to_space(yq.detach(), 4).permute(0, 3, 1, 2),
            gx.permute(0, 3, 1, 2), gw)


def high_oracle(x, w, g, stride, padding, groups):
    """float64 on the card: forward, grad-input and grad-weight of the
    NCHW conv as the exact sum of the three bf16x3 products of the fp32
    splits, and as the full product."""
    args = ([stride] * 2, list(padding), [1, 1], False, [0, 0], groups)
    x64, w64, g64 = (t.double().contiguous() for t in (x, w, g))

    def conv(a, b):
        return F.conv2d(a, b, None, stride, padding, 1, groups)

    def grad_input(gg, b):
        return torch.ops.aten.convolution_backward(
            gg, x64, b, None, *args, [True, False, False])[0]

    def grad_weight(a, gg):
        return torch.ops.aten.convolution_backward(
            gg, a, w64, None, *args, [False, True, False])[1]

    def three(f, a, b):
        return f(a[0], b[0]) + f(a[0], b[1]) + f(a[1], b[0])

    xs, ws, gs = ([v.double().contiguous() for v in dp.split_bf16(t)]
                  for t in (x, w, g))
    return ((three(conv, xs, ws), three(grad_input, gs, ws),
             three(grad_weight, xs, gs)),
            (conv(x64, w64), grad_input(g64, w64), grad_weight(x64, g64)))


def high_phase(line: str) -> dict:
    """`[high]`: `precision="high"` as the port computes it on the card,
    bf16x3 (three bf16 products, TF32 on over bf16-valued operands), at
    the model's conv shapes: forward, grad-input and grad-weight through
    `conv2d_dp` held within HIGH_RTOL relative L2 of the float64 oracle
    of the same three products (the full product's error beside it); at
    the 7x7 stem's shape also the folded route the encoders take
    (`folded_stem`), held the same way."""
    rel = lambda a, b: float((a.double() - b).norm() / b.norm())  # noqa: E731
    parts = ("forward", "grad_input", "grad_weight")
    report = {}
    for name, (xs, ws, stride, padding, groups) in HIGH_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(len(report))
        x = torch.randn(*xs, generator=gen, device="cuda")
        w = torch.randn(*ws, generator=gen, device="cuda") / math.sqrt(
            ws[1] * ws[2] * ws[3])
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = dp.conv2d_dp(xg, wg, None, stride, padding, "high",
                         groups=groups)
        g = torch.randn(*y.shape, generator=gen, device="cuda")
        y.backward(g)
        xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        routes = {"conv2d_dp_high": (y.detach().permute(0, 3, 1, 2),
                                     xg.grad.permute(0, 3, 1, 2), wg.grad)}
        del xg, wg, y
        if ws[2:] == (7, 7) and (stride, tuple(padding), groups) == (
                1, (0, 0), 1):
            routes["folded"] = folded_stem(xc, w, gc)
        three, full = high_oracle(xc, w, gc, stride, padding, groups)
        res = {"x": list(xs), "w": list(ws), "stride": stride,
               "padding": list(padding), "groups": groups}
        for route, out in routes.items():
            res[route] = {p: {"vs_bf16x3": rel(out[i], three[i]),
                              "vs_full": rel(out[i], full[i])}
                          for i, p in enumerate(parts)}
        del routes
        report[name] = res
        print(f"[{HIGH}] {name}: {json.dumps(res)} | {line}", flush=True)
        for route in ("conv2d_dp_high", "folded"):
            for p in parts if route in res else ():
                check(res[route][p]["vs_bf16x3"] <= HIGH_RTOL,
                      f"{HIGH}: {name} {route} {p} {res[route][p]} beyond "
                      f"{HIGH_RTOL} of the bf16x3 oracle")
        del x, w, g, xc, gc, three, full
        torch.cuda.empty_cache()
    return report


def main_path() -> dict:
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
            out = forward()
            sess = RetargetSession(mods, *src, chunk=CHUNK)
            pushed = [sess.push_labels(tar_lbl[lo:lo + CHUNK],
                                       tar_bbox[lo:lo + CHUNK])
                      for lo in (0, CHUNK, 0)]
            disp = RetargetSession(mods, *src, chunk=CHUNK, output="display")
            shown = disp.push_labels(tar_lbl[CHUNK:], tar_bbox[CHUNK:])
            torch.cuda.synchronize()
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
            # K8 in the 5 decode calls (one warp kernel each) and the 3
            # encodes of the sources (the forward's and each session's)
            want_k8 = clip_k8(cfg, launches[warp_kernel], 3)
            check(launches["instance_norm_fused"] == want_k8,
                  f"{tier}: K8 launches {launches}, expected {want_k8}")

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
            res = {"launches": launches,
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
        report[tier] = res
        outputs[tier] = out.cpu()
        features[tier] = encode_sources(mods, *src)["fea"].float().cpu()
        del mods, out, plain
        torch.cuda.empty_cache()
    report[FUSED_TIER] = fused_tier(bench, src, tar_lbl, tar_bbox,
                                    outputs["bench"])
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
        report.setdefault("tier_drift", {})[name] = drift.mean().item()
    # "high" + fast_tail against bit-parity within the 0.01 mean-L1 budget
    # of the JAX package's fast tiers (QUIRKS.md: 5.1e-3 with fast_tail);
    # the bench tier's fast_trunk (one bf16 pass into the temp-100
    # attention) drifts past it on random weights in both packages
    # (ROADMAP.md queue 3), and is printed
    check(report["tier_drift"]["high+fast_tail"] <= 0.01,
          f"tiers: high+fast_tail vs bit-parity {report['tier_drift']}")
    return report


def fused_tier(cfg, src, tar_lbl, tar_bbox, unfused_out) -> dict:
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
        out = forward()
        pack = encode_sources(mods, *src)
        answered = [request(pack, lo) for lo in (0, CHUNK)]
        torch.cuda.synchronize()
        launches = dict(cuda_build.LAUNCHES)

        calls = 1 + len(answered)                    # decode calls
        want = with_k8({"transform_warp_pairs_mean": calls,
                        "instance_norm_mean": calls, "fuse_pair_conv2": calls,
                        "conv3x3_in": 2 * cfg.dec_n_blocks * calls},
                       cfg, calls, 2, fused_blocks=True, pair_kernel=True)
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
        res = {"launches": launches,
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
    t = h * w
    gen = torch.Generator().manual_seed(1)
    src = torch.randn(g, ns, t, c, generator=gen)
    args = tuple(x.to(dev).contiguous() for x in (
        src, l2_normalize(torch.randn(g, nf, t, c, generator=gen)),
        l2_normalize(src), (torch.rand(g, nf, t, generator=gen) > 0.5).float(),
        (torch.rand(g, ns, t, generator=gen) > 0.5).float(),
        normalized_grid(h, w).reshape(t, 2)))
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
    res.update(replaces="wacv23_tsnet_tpu/ops/pallas_similarity.py:262",
               source="wacv23_tsnet_tpu_torch/csrc/transform_warp.cu")
    results["transform_warp_pairs"] = res
    print(f"[kernel] transform_warp_pairs (K3-flow, warped + flow, temp 100, "
          f"G={g}):"
          f" max_abs_err={res['max_abs_err']:.3e} "
          f"mean_abs_err={res['mean_abs_err']:.3e} (atol, rtol)="
          f"{TOL['f32']} kernel_ms={res['ms']:.4f} "
          f"plain_ms={res['plain_ms']:.4f} | {line}", flush=True)

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
    # two calls give the same bits in all six cotangents: every sum, da's
    # too, runs in a fixed order
    again = bwd()
    differ = [n for n, a, b in zip(names, got, again) if not torch.equal(a, b)]
    print(f"[kernel] transform_warp_pairs_bwd (K4) G={g}: two calls, "
          f"cotangents that differ in bits: {differ} | {line}", flush=True)
    check(not differ,
          f"transform_warp_pairs_bwd: two calls differ in {differ}")
    del again
    # timed at the config's temp 100
    res["ms"] = time_ms(bwd)
    res["plain_ms"] = time_ms(lambda: wk.transform_warp_pairs_bwd_plain(
        *args, gw, gf, h, w, temp), iters=3)
    res.update(replaces="wacv23_tsnet_tpu/ops/pallas_similarity.py:824",
               source="wacv23_tsnet_tpu_torch/csrc/transform_warp_bwd.cu")
    results["transform_warp_pairs_bwd"] = res
    print(f"[kernel] transform_warp_pairs_bwd (K4, six cotangents, G={g}): "
          f"max_abs_err={res['max_abs_err']:.3e} (temp 10, rtol "
          f"{BWD_RTOL} of max(1, max|plain|)) kernel_ms={res['ms']:.4f} "
          f"plain_ms={res['plain_ms']:.4f} | {line}", flush=True)
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
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    history = []
    for _ in range(TRAIN_STEPS):
        _, metrics, rec = step(state, batch, TRAIN_LR)
        history.append({k: v.item() for k, v in metrics.items()})
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    check(all(per_step[k] == 1 for k in TRAIN_KERNELS),
          f"train: launches per step {per_step}")
    check(all(per_step[k] == 0 for k in (
        "transform_warp_pairs_mean", "transform_warp_pairs_nf",
        "fuse_pair_conv2", "conv3x3_in", "instance_norm_fused")
        + STANDALONE_KERNELS),
          f"train: launched an inference kernel: {per_step}")
    check(all(np.isfinite(v) for h in history for v in h.values()),
          "train: non-finite metric")
    check(tuple(rec.shape) == (TRAIN_BATCH, cfg.image_size, cfg.image_size, 3),
          "train: reconstruction shape")
    vgg = [h["G_VGG"] for h in history]
    check(np.mean(vgg[-5:]) < np.mean(vgg[:5]),
          f"train: G_VGG did not fall: {vgg}")
    print(f"[train] {TRAIN_STEPS} steps at batch {TRAIN_BATCH}: G_VGG "
          f"first5 {np.mean(vgg[:5]):.4f} last5 {np.mean(vgg[-5:]):.4f}; D "
          f"first5 {np.mean([h['D'] for h in history[:5]]):.4f} last5 "
          f"{np.mean([h['D'] for h in history[-5:]]):.4f}; launches per step "
          f"{json.dumps(per_step)} | {line}", flush=True)
    print(f"[train] metrics of the last step: {json.dumps(history[-1])}",
          flush=True)
    return {"launches": launches}, state


DETERMINISM = "determinism"


def step_bits(state, metrics, rec) -> dict:
    """Everything a train step leaves, on the card: each parameter, its
    gradient and its Adam moments by (param group, index), the metrics
    and the reconstruction."""
    out = {f"metric/{k}": v for k, v in metrics.items()}
    out["rec"] = rec
    for opt in (state.gen_opt, state.disc_opt):
        for group in opt.param_groups:
            for i, p in enumerate(group["params"]):
                name = f"{group['name']}/{i}"
                out[f"param/{name}"] = p.detach().clone()
                out[f"grad/{name}"] = p.grad.clone()
                for k in ("exp_avg", "exp_avg_sq"):
                    out[f"{k}/{name}"] = opt.state[p][k].clone()
    return out


def cudnn_flags(mode: str):
    """The step as it runs ("deterministic") or, for a measurement, with
    cuDNN's default flags ("default": its context manager a no-op)."""
    if mode == "deterministic":
        return contextlib.nullcontext()
    return patched(train_step_module, "deterministic_cudnn",
                   contextlib.nullcontext)


def same_bits(name: str, mode: str, states: list, batch: dict) -> dict:
    """One step on each of two equal states: what differs in bits."""
    runs = []
    for state in states:
        step = make_train_step(state)
        with cudnn_flags(mode):
            (_, metrics, rec), launches = counted(
                lambda: step(state, batch, TRAIN_LR))
        check(launches == TRAIN_KERNEL_LAUNCHES,
              f"{DETERMINISM}: {name} launched {launches}")
        runs.append(step_bits(state, metrics, rec))
    differ = [k for k in runs[0] if not torch.equal(runs[0][k], runs[1][k])]
    res = {"compared": len(runs[0]), "differ": len(differ)}
    if differ:
        a, b = runs[0][differ[0]], runs[1][differ[0]]
        res["first_differing"] = differ[0]
        res["its_max_abs_diff"] = (a - b).abs().max().item()
        res["differing_kinds"] = sorted({k.split("/")[0] for k in differ})
    return res


def determinism_phase(line: str, diagnose: bool = False) -> dict:
    """`[determinism]`: the face bit-parity step (batch 15), the pose
    bit-parity step (batch 10) and the face fast train tier, each called
    on two equal copies of one seeded state with one batch, held bit for
    bit. With `diagnose` (`--determinism`), also two steps with cuDNN's
    default flags: what the step would give without
    `deterministic_cudnn`, printed."""
    face, pose = face_config(), pose_config()
    cases = {"face_bit_parity": (face, train_batch(face, TRAIN_BATCH)),
             "pose_bit_parity": (pose, pose_batch(pose, POSE_BATCH, seed=8)),
             "face_fast": (dataclasses.replace(face, **FAST_TIER),
                           train_batch(face, TRAIN_BATCH))}
    modes = ("deterministic", "default") if diagnose else ("deterministic",)
    report = {}
    for name, (cfg, batch) in cases.items():
        first = create_train_state(cfg, device="cuda", seed=0)
        states = [first] + [copy.deepcopy(first)
                            for _ in range(2 * len(modes) - 1)]
        res = {mode: same_bits(name, mode, states[2 * i:2 * i + 2], batch)
               for i, mode in enumerate(modes)}
        del first, states
        torch.cuda.empty_cache()
        report[name] = res
        print(f"[{DETERMINISM}] {name}: one step on each of two equal "
              f"states, {json.dumps(res)} | {line}", flush=True)
        check(res["deterministic"]["differ"] == 0,
              f"{DETERMINISM}: {name} differs in bits over two calls: {res}")
    return report


@contextlib.contextmanager
def patched(module, name: str, value):
    """module.name set to value for the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


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
    warp kernel and one K2 a chunk, nothing else) and a 2-frame int-list
    request, held against an in-process `push_keypoints` (1 LSB), the
    model-space kernel path against the plain path (PERF.md §2's limits),
    and one 32-frame request through the server's stages in this
    process (`request_round_trip`). The rasterizer on the card is held
    against its CPU run on a 32-frame chunk."""
    cfg = face_config()
    hw = cfg.image_size
    report = {}
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_",
                                     dir=root) as tmp:
        snap = os.path.join(tmp, f"TSNet_S{state.step:06d}.msgpack")
        save_checkpoint(snap, state)
        report["snapshot_bytes"] = os.path.getsize(snap)
        check(find_latest_checkpoint(tmp) == snap, "serve: latest snapshot")
        fresh = create_train_state(cfg, device="cuda", seed=1)
        restore_checkpoint(snap, fresh)
        bad = _train_state_equal(state, fresh)
        check(not bad, f"serve: restored state differs: {bad[:8]}")
        del fresh

        tree = export_flax_params(state.mods)
        pth = os.path.join(tmp, "TSNet_generator.pth")
        save_reference_checkpoint(pth, {k: tree[k] for k in GEN_SUBNETS},
                                  cfg, example=state.step)
        report["pth_bytes"] = os.path.getsize(pth)
        from_pth = load_params(pth, cfg, device="cuda")
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

        # the rasterizer on the card against its CPU run
        kp_dev = torch.as_tensor(kp[:CHUNK], device="cuda")
        ones = torch.ones(CHUNK, device="cuda")
        lbl_dev = rasterize_face_clip(kp_dev, ones, hw, hw).cpu()
        lbl_cpu = rasterize_face_clip(torch.as_tensor(kp[:CHUNK]),
                                      torch.ones(CHUNK), hw, hw)
        differing = int((lbl_dev != lbl_cpu).sum())
        report["rasterizer"] = {
            "pixels_differing_from_cpu": differing,
            "agreement": 1.0 - differing / lbl_cpu.numel()}
        print(f"[serve] rasterizer, {CHUNK} frames at {hw}^2: "
              f"{json.dumps(report['rasterizer'])} | {line}", flush=True)
        check(report["rasterizer"]["agreement"] >= 0.9999,
              "serve: rasterizer on the card vs its CPU run")

        for tier in ("bench", "bit-parity"):
            report[tier] = serve_tier(line, tier, snap, payload, kp)
    return report


def request_round_trip(server: Server, sid: str, kp: np.ndarray) -> None:
    """One base64 request of the frames `kp` (one chunk) through the
    stages that `Server.run_frames` and `push_keypoints` run, one after
    the other in this process: the client's JSON of the request, the
    server's parse and keypoint array, the upload, the rasterizer, the
    extent bbox, the decode (one-hot, `decode_with_sources`, display
    uint8), the copy back, the RGB copy, base64, the reply's JSON, and the
    client's JSON parse and base64 decode, which must give back the RGB
    frames."""
    sess = server.sessions[sid]
    hw = sess.mods.cfg.image_size
    request = {"session": sid, "keypoints": kp.tolist(),
               "encoding": "base64"}
    got = json.loads(json.dumps(request).encode())
    arr = np.asarray(got["keypoints"], np.float32)
    with torch.inference_mode():
        k = torch.as_tensor(arr).to(sess.device)
        ones = torch.ones(len(arr), device=sess.device)
        lbl = rasterize_face_clip(k, ones, hw, hw)
        bbox = sess._extent_bbox(k[..., 0], k[..., 1], hw)
        rec = sess._decode(lbl, bbox).cpu().numpy()
    rgb = np.ascontiguousarray(rec[..., ::-1])
    b64 = base64.b64encode(rgb.tobytes()).decode()
    reply = json.dumps({"frames_b64": b64, "shape": list(rgb.shape),
                        "dtype": "uint8", "ms": 0.0}).encode()
    check(np.array_equal(_frames(json.loads(reply)), rgb),
          "serve: stage split's frames")


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
        sid = _http(url + "/session", payload)["session"]

        request = {"session": sid, "keypoints": kp.tolist(),
                   "encoding": "base64"}
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        body = _http(url + "/frames", request)
        torch.cuda.synchronize()
        launches = dict(cuda_build.LAUNCHES)
        frames = _frames(body)
        res["launches"] = launches
        chunks = -(-SERVE_FRAMES // CHUNK)
        want = with_k8({SERVE_KERNELS[tier]: chunks,
                        "instance_norm_mean": chunks}, cfg, chunks, 0)
        check(all(launches[k] == want.get(k, 0) for k in launches),
              f"serve {tier}: launches {launches}, want {want}")
        check(frames.shape == (SERVE_FRAMES, base.image_size,
                               base.image_size, 3),
              f"serve {tier}: frames shape {frames.shape}")

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
        request_round_trip(server, sid, kp[:CHUNK])
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
    want = with_k8({warp_kernel: 2, "instance_norm_mean": 2}, mods.cfg, 2, 2)
    check(all(launches[k] == v for k, v in want.items())
          and sum(launches.values()) == sum(want.values()),
          f"pose {tier}: launches of a clip and a session request "
          f"(one {warp_kernel} and one K2 each, K8 a decoder norm): "
          f"{launches}")
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
    print(f"[pose] clip {tier}: {json.dumps(res)} | {line}", flush=True)
    del plain, diff, sess, pushed, want, mods, out
    torch.cuda.empty_cache()
    return res


def through_discriminators(mods, cfg, rec: torch.Tensor, batch: dict,
                           metrics: dict) -> dict:
    """POSE_D_READ_METRICS of the reconstruction `rec` read through the
    netD and netDF of `mods`, as the train step's G phase computes them
    (the VGG terms, which read no discriminator, from `metrics`)."""
    lbl, tar = batch["tar_lbl"], batch["tar_img"]
    with torch.no_grad():
        fake = mods.netD(torch.cat([lbl, rec], dim=-1))
        real = mods.netD(torch.cat([lbl, tar], dim=-1))
        face = mods.netDF(crop_faces(rec, lbl))
        face_real = mods.netDF(crop_faces(tar, lbl))
        out = {"G_GAN": lsgan_loss(fake[-1], True),
               "G_FML": feature_matching_loss(fake, real, cfg.lambda_fml),
               "GF_GAN": lsgan_loss(face[-1], True),
               "GF_FML": feature_matching_loss(face, face_real,
                                               cfg.lambda_fml)}
    out = {k: v.item() for k, v in out.items()}
    out["G"] = out["G_GAN"] + out["G_FML"] + metrics["G_VGG"]
    out["GF"] = out["GF_GAN"] + out["GF_FML"] + metrics["GF_VGG"]
    return out


def pose_first_step(cfg, batch: dict, launched: collections.Counter):
    """The first pose train step from one seeded state through the
    kernels, the plain versions and the plain versions on input images
    moved by each of POSE_NUDGES, at temp 10 and at the config's 100,
    held by [train]'s rules, with netDF beside netD; returns the
    temp-100 kernel path's state and step.

    The G-phase metrics that read the updated discriminators
    (POSE_D_READ_METRICS) are also read for each path through the plain
    path's updated discriminators (`same_d`), which parts the
    generator's difference from the discriminators'; each path's updated
    discriminator parameters are compared with the plain path's in units
    of their lr (`d_params_over_lr`), and its netD and netDF gradients
    by the elements whose sign differs from the plain path's (`flips`:
    Adam's first step moves each such weight 2 lr the other way)."""
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
            _, metrics, rec = step(state, data, TRAIN_LR)
            torch.cuda.synchronize()
            launches = dict(cuda_build.LAUNCHES)
            check(all(launches[k] == int(use_kernels) for k in TRAIN_KERNELS)
                  and sum(launches.values()) == 3 * int(use_kernels),
                  f"pose: first step's launches on the {name} path: "
                  f"{launches}")
            if use_kernels:
                launched.update(launches)
            if name == "plain":
                plain_state = state
            m = {k: v.item() for k, v in metrics.items()}
            runs[name] = {
                "metrics": m, "grads": grads_of(state, POSE_SUBNETS),
                "same_d": through_discriminators(plain_state.mods, tcfg, rec,
                                                 data, m),
                "disc": {d: torch.cat([p.detach().flatten() for p in
                                       getattr(state.mods, d).parameters()])
                         for d in ("netD", "netDF")},
                "d_lr": state.disc_opt.param_groups[0]["lr"]}
            del rec
            if not (use_kernels and temp == cfg.softmax_temp) and \
                    name != "plain":
                del state, step
                torch.cuda.empty_cache()
        del plain_state
        torch.cuda.empty_cache()
        mp, gp = runs["plain"]["metrics"], runs["plain"]["grads"]
        sp, dp = runs["plain"]["same_d"], runs["plain"]["disc"]
        err = {}
        for name in ["kernel"] + nudges:
            run = runs[name]
            err[f"{name}_metrics"] = {
                k: abs(v - mp[k]) / max(1.0, abs(mp[k]))
                for k, v in run["metrics"].items()}
            err[f"{name}_grads"] = {
                k: ((v - gp[k]).norm() / gp[k].norm()).item()
                for k, v in run["grads"].items()}
            err[f"{name}_same_d"] = {
                k: abs(v - sp[k]) / max(1.0, abs(sp[k]))
                for k, v in run["same_d"].items()}
            err[f"{name}_d_params_over_lr"] = {
                d: (v - dp[d]).abs().max().item() / run["d_lr"]
                for d, v in run["disc"].items()}
            err[f"{name}_flips"] = {
                d: int((torch.sign(run["grads"][d])
                        != torch.sign(gp[d])).sum())
                for d in ("netD", "netDF")}
        err["elements"] = {d: gp[d].numel() for d in ("netD", "netDF")}
        for kind in ("metrics", "grads"):
            err[f"nudged_{kind}"] = {k: max(err[f"{n}_{kind}"][k]
                                            for n in nudges)
                                     for k in err[f"kernel_{kind}"]}
        print(f"[pose] first step at temp {temp}, batch {POSE_BATCH}, kernel "
              f"path and nudged plain path vs plain path (gradients "
              f"relative L2): {json.dumps(err)}", flush=True)
        bad = {k: v for k, v in err["kernel_metrics"].items()
               if k not in POSE_D_READ_METRICS and v > STEP_METRIC_RTOL}
        bad.update({f"{k} (same discriminators)": v
                    for k, v in err["kernel_same_d"].items()
                    if v > STEP_METRIC_RTOL})
        check(len(err["kernel_metrics"]) == 16 and not bad,
              f"pose: first-step metrics at temp {temp}: {bad}")
        check(max(err["kernel_d_params_over_lr"].values())
              <= D_STEP_LR_MARGIN,
              f"pose: updated discriminators at temp {temp}, in lr: "
              f"{err['kernel_d_params_over_lr']}")
        flip_bar = {d: NUDGE_MARGIN * max(err[f"{n}_flips"][d]
                                          for n in nudges)
                    for d in err["elements"]}
        check(all(err["kernel_flips"][d] <= flip_bar[d] for d in flip_bar),
              f"pose: discriminator gradient sign flips at temp {temp}: "
              f"{err['kernel_flips']} against {flip_bar}")
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


def pose_first_step_forms(line: str) -> int:
    """[pose]'s first-step comparison alone, with the plain `Decoder` and
    then the phase-decomposed decoder decoding: which of the two moves
    the metrics read through the updated discriminators. Both forms run
    even where the first fails its checks; returns 1 if either did."""
    cfg = pose_config()
    batch = pose_batch(cfg, POSE_BATCH, seed=8)
    failed = []
    for form, ctx in (("plain", plain_decoder()),
                      ("phase", contextlib.nullcontext())):
        print(f"[pose] first step with the {form} decoder | {line}",
              flush=True)
        try:
            with ctx:
                state, step = pose_first_step(cfg, batch,
                                              collections.Counter())
            del state, step
        except RuntimeError as exc:
            print(f"[pose] first step with the {form} decoder failed: {exc}",
                  flush=True)
            failed.append(form)
        torch.cuda.empty_cache()
    return int(bool(failed))


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

    torch.cuda.synchronize()
    cuda_build.reset_launches()
    history = []
    for _ in range(POSE_STEPS):
        _, metrics, rec = step(state, batch, TRAIN_LR)
        history.append({k: v.item() for k, v in metrics.items()})
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
    train = {"launches_per_step": per_step,
             "g_vgg_first5": float(np.mean(vgg[:5])),
             "g_vgg_last5": float(np.mean(vgg[-5:])),
             "gf_vgg_first5": float(np.mean([h["GF_VGG"]
                                             for h in history[:5]])),
             "gf_vgg_last5": float(np.mean([h["GF_VGG"]
                                            for h in history[-5:]]))}
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
        save_checkpoint(snap, state)
        snapshot = {"bytes": os.path.getsize(snap)}
        del step
        torch.cuda.empty_cache()
        fresh = create_train_state(cfg, device="cuda", seed=1)
        restore_checkpoint(snap, fresh)
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
    launched.update(launches)
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
    report["fast_train"] = {"grad_cosines": cos,
                            "jax_package_fast_vs_high": POSE_JAX_COSINE}
    print(f"[pose] fast train tier (precision high, bwd_precision default, "
          f"fast_tail) at batch {POSE_BATCH}: "
          f"{json.dumps(report['fast_train'])} | {line}", flush=True)
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
    plain path's beside it), TIER_STEPS steps of it and of the bit-parity
    tier (launches and metrics), and remat's peak memory and
    gradients."""
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
    for tier, cfg in (("fast", dataclasses.replace(base, **FAST_TIER)),
                      ("bit-parity", base)):
        state = create_train_state(cfg, device="cuda", seed=0)
        step = make_train_step(state)
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        for _ in range(TIER_STEPS):
            _, metrics, _ = step(state, batch, TRAIN_LR)
        vals = [v.item() for v in metrics.values()]
        torch.cuda.synchronize()
        per_step = {k: v / TIER_STEPS for k, v in cuda_build.LAUNCHES.items()
                    if v}
        check(all(np.isfinite(vals)), f"loop: {tier} tier metrics {vals}")
        check(per_step == {k: 1 for k in TRAIN_KERNELS},
              f"loop: {tier} tier launches per step {per_step}")
        del state, step
        torch.cuda.empty_cache()
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
        got = clip.run(*src, tar_lbl, tar_bbox)
        launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
        chunks = CLIP_FRAMES // CHUNK
        check(launches == with_k8({warp_kernel: chunks,
                                   "instance_norm_mean": chunks},
                                  cfg, chunks, 1),
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
        res = {"launches_per_chunk": {k: v / chunks
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
    and one K2 a step, nothing else); then a
    resume from the final snapshot (`--restore-from --set-start`),
    checked equal to the saved state and stepped once under the profiler;
    the fast train tier (`train_tiers`) and `ClipInference`
    (`clip_inference_check`). Its files go to `tmp`: the dataset to
    `data/`, the run and its snapshots to `run/`."""
    report = {}
    lbl_root, img_root = write_face_dataset(os.path.join(tmp, "data"))
    run_root = os.path.join(tmp, "run")
    args = ["--label-path", lbl_root, "--image-path", img_root,
            "--root-dir", run_root, "--batch-size", str(TRAIN_BATCH),
            "--n-frame-total", str(LOOP_FRAMES), "--n-source", "3",
            "--num-videos", str(LOOP_VIDEOS),
            "--print-freq", str(LOOP_PRINT_FREQ)]

    cuda_build.reset_launches()
    model, _ = train_face.main(args + ["--final-step", str(LOOP_STEPS)])
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    per_step = {k: v / LOOP_STEPS for k, v in launches.items() if v}
    check(model.state.step == LOOP_STEPS,
          f"loop: trained to step {model.state.step}")
    check(per_step == {k: 1 for k in TRAIN_KERNELS},
          f"loop: launches per step {per_step}")
    losses = model.get_current_losses()
    check(all(np.isfinite(v) for v in losses.values()),
          f"loop: non-finite loss {losses}")
    report.update({"launches_per_step": per_step, "last_losses": losses})
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
    res = demo_face.main(base_args + extra + ["--out-dir", out_dir])
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    chunks = -(-DEMO_FRAMES // CHUNK)
    cfg = dataclasses.replace(face_config(), precision="high",
                              fast_tail=bool(extra))
    check(launches == with_k8({warp_kernel: chunks,
                               "instance_norm_mean": chunks}, cfg, chunks, 1),
          f"demo {tier}: launches {launches}")

    # the reconstruction against the plain path on the same sample and
    # weights (the CLI's random init, seed 0)
    rec = res["rec"]
    hw = cfg.image_size
    check(rec.shape == (DEMO_FRAMES, 3, hw, hw) and np.isfinite(rec).all(),
          f"demo {tier}: reconstruction")
    src, tar, idx = sample["src"], sample["tar"], res["ref_idx"]
    plain = ClipInference(cfg, TSNetModules(cfg, seed=0), use_kernels=False)
    want = plain.run_renormalized(src["img"][idx], src["lbl"][idx],
                                  src["bbox"][idx], tar["lbl"], tar["bbox"])
    del plain
    err = np.abs(rec - want)
    report = {"launches": launches, "vs_plain_mean_abs": float(err.mean()),
              "vs_plain_max_abs": float(err.max())}
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


def demo_phase(line: str, root: str, snapshot_dir: str) -> dict:
    """The face test-time workflow at the full width of face_config():
    `cli.demo_face.main` on a synthetic subject/driving pair
    (`write_face_pair`) in its default tier (K3-nf) and with
    `--fast-tail` (K1), launch counts zeroed just before each and read
    just after (one warp kernel and one K2 a chunk, nothing else), its
    reconstruction against the plain path, each montage PNG against its
    frames, the GIF's size, frame count and delays; `cli.eval_snapshots`
    over [loop]'s snapshots; one `cli.quick_start` step at batch 4 under
    torch.profiler (one K3-flow, K4 and K2); `cli.profile_stages` on a
    64-frame clip and on the train step at batch 15, in the bit-parity
    tier and its default tier (every stage span once a call or step).
    Files go to `root`."""
    report = {}
    data_root = os.path.join(root, "data")
    write_face_pair(data_root)
    base_args = ["--data-root", data_root, "--subject", "subject",
                 "--driving", "driving", "--max-frames", str(DEMO_FRAMES),
                 "--chunk", str(CHUNK)]
    paths = [os.path.join(data_root, kind, clip)
             for clip in DEMO_FACE_R for kind in ("images", "labels")]
    hw = face_config().image_size
    sample = FaceDatasetTest(*paths, img_size=(hw, hw),
                             max_frame_num=DEMO_FRAMES)[0]
    for tier in DEMO_TIERS:
        report[tier] = demo_tier(line, tier, root, base_args, sample)
        torch.cuda.empty_cache()

    # eval_snapshots over the loop's snapshots, the subject clip as data
    snaps = sorted(f for f in os.listdir(snapshot_dir)
                   if f.endswith(".msgpack"))
    rows = eval_snapshots.main(["--snapshot-dir", snapshot_dir,
                                "--data-root", data_root, "--subject",
                                "subject", "--out-dir",
                                os.path.join(root, "eval")])
    report["eval"] = {"snapshots": snaps, "rows": rows}
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
    cuda_build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        model = quick_start.main([])
        torch.cuda.synchronize()
    launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    losses = model.get_current_losses()
    check(launches == {k: 1 for k in TRAIN_KERNELS},
          f"demo: quick_start launches {launches}")
    check(all(np.isfinite(v) for v in losses.values()),
          f"demo: quick_start losses {losses}")
    report["quick_start"] = {"launches_profiled": launches, "losses": losses}
    del model
    torch.cuda.empty_cache()
    print(f"[demo] quick_start: {json.dumps(report['quick_start'])} | "
          f"{line}", flush=True)

    # profile_stages: every clip span once a call and every train span
    # once a step, in the bit-parity tier and the CLI's default tier (its
    # trace goes to `root`)
    stages = {}
    kinds = {"clip": (["--frames", str(CLIP_FRAMES)],
                      profile_stages.CLIP_SPANS),
             "train": (["--train", "--batch-size", str(TRAIN_BATCH)],
                       profile_stages.TRAIN_SPANS
                       + (profile_stages.STEP_SPAN,))}
    with contextlib.chdir(root):
        for tier, argv in (("bit-parity", ["--precision", "highest",
                                           "--no-fast-tail"]),
                           ("default", [])):
            for kind, (extra, names) in kinds.items():
                print(f"[demo] profile_stages {kind} {tier}:", flush=True)
                res = profile_stages.main(extra + argv)
                torch.cuda.empty_cache()
                stages[f"{kind} {tier}"] = res
                check(all(res["count"][name] == 1 for name in names),
                      f"demo: profile_stages {kind} {tier} spans a unit "
                      f"{res['count']}")
    report["profile_stages"] = stages
    print(f"[demo] profile_stages: {json.dumps(stages)} | {line}", flush=True)
    return report


def dance_person(cx: float, cy: float, scale: float, t: float,
                 conf: float = 0.9) -> dict:
    """OpenPose keypoint lists of a standing figure, arms and legs swung
    by phase t, with a 70-point face ring and two 21-point hands
    (tests/test_pose_train_data.py's layout)."""
    sw = 0.15 * np.sin(t)
    layout = [(0, -1.6), (0, -1.2), (-0.4, -1.2), (-0.5 - sw, -0.6),
              (-0.55 - 2 * sw, 0.0), (0.4, -1.2), (0.5 + sw, -0.6),
              (0.55 + 2 * sw, 0.0), (0, 0.0), (-0.2, 0.0),
              (-0.25 + sw, 0.8), (-0.25 + sw, 1.6), (0.2, 0.0),
              (0.25 - sw, 0.8), (0.25 - sw, 1.6), (-0.1, -1.7), (0.1, -1.7),
              (-0.2, -1.65), (0.2, -1.65), (0.3 - sw, 1.7),
              (0.35 - sw, 1.7), (0.2 - sw, 1.72), (-0.3 + sw, 1.7),
              (-0.35 + sw, 1.7), (-0.2 + sw, 1.72)]

    def pts(offsets):
        return [v for dx, dy in offsets
                for v in (cx + dx * scale, cy + dy * scale, conf)]

    ring = np.linspace(0, 2 * np.pi, 70, endpoint=False)
    face = [(0.12 * np.cos(a), -1.6 + 0.14 * np.sin(a) + 0.01 * (i % 3))
            for i, a in enumerate(ring)]

    def hand(wx, wy, side):
        return [(wx, wy)] + [(wx + side * (0.02 * f - 0.04 + 0.01 * j),
                              wy + 0.03 * j + 0.005 * f)
                             for f in range(5) for j in range(1, 5)]

    return {"pose_keypoints_2d": pts(layout), "face_keypoints_2d": pts(face),
            "hand_left_keypoints_2d": pts(hand(*layout[7], 1)),
            "hand_right_keypoints_2d": pts(hand(*layout[4], -1))}


def write_dance_set(root: str) -> dict:
    """POSE_DATA_VIDEOS dance videos of POSE_DATA_FRAMES frames under
    root/{images,labels}/<%05d id>/: each frame a copy of one of the
    committed JPEG fixtures (the script writes no JPEG itself), each
    OpenPose JSON a moving figure with face and hands; video
    POSE_DATA_TWO_PEOPLE holds a second, smaller person, video
    POSE_DATA_LOW_CONF points below the detection thresholds. The video
    dicts: clean_video_dict.json (every video: the train set and the
    subjects), clean_unseen_video_dict.json (the driving videos), and
    smooth_openpose/ by `cli.smooth_keypoints`. Returns the fixtures'
    manifest."""
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            JPEG_FIXTURES)
    with open(os.path.join(fixtures, "manifest.json")) as f:
        manifest = json.load(f)
    names = sorted(manifest["files"])
    for v, vid in enumerate(POSE_DATA_VIDEOS):
        fixture = names[v % len(names)]
        with open(os.path.join(fixtures, fixture), "rb") as f:
            jpeg = f.read()
        w, h = manifest["files"][fixture]["size"]
        scale = 0.18 * h if vid <= 91 else 0.2 * h
        for kind in ("images", "labels"):
            os.makedirs(os.path.join(root, kind, "%05d" % vid))
        for f in range(POSE_DATA_FRAMES):
            name = f"frame{f:06d}"
            with open(os.path.join(root, "images", "%05d" % vid,
                                   name + ".jpg"), "wb") as fh:
                fh.write(jpeg)
            people = [dance_person(w / 2 + 8 * np.sin(0.2 * f + v),
                                   h / 2 + 4, scale, 0.5 * f + v)]
            if vid == POSE_DATA_TWO_PEOPLE:
                people.append(dance_person(w / 4, 0.6 * h, 0.08 * h, f))
            if vid == POSE_DATA_LOW_CONF:
                p = people[0]
                p["hand_left_keypoints_2d"][3 * 6 + 2] = 0.005   # a finger
                p["face_keypoints_2d"][3 * 40 + 2] = 0.05        # a segment
                p["pose_keypoints_2d"][3 * 13 + 2] = 0.0         # a knee
            with open(os.path.join(root, "labels", "%05d" % vid,
                                   name + "_keypoints.json"), "w") as fh:
                json.dump({"version": 1.3, "people": people}, fh)
    frames = [f"frame{f:06d}.jpg" for f in range(POSE_DATA_FRAMES)]
    for name, vids in (("clean_video_dict.json", POSE_DATA_VIDEOS),
                       ("clean_unseen_video_dict.json", POSE_DATA_UNSEEN)):
        with open(os.path.join(root, name), "w") as fh:
            json.dump({str(v): frames for v in vids}, fh)
    smooth_keypoints.main([
        "--video-dict", os.path.join(root, "clean_unseen_video_dict.json"),
        "--label-dir", os.path.join(root, "labels"),
        "--out-dir", os.path.join(root, "smooth_openpose")])
    return manifest


def jpeg_fixture_check(line: str, manifest: dict) -> dict:
    """Each committed JPEG fixture decoded by the port, its RGB bytes
    held to the sha256 of Pillow's decode in the manifest."""
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            JPEG_FIXTURES)
    report = {}
    for name, entry in manifest["files"].items():
        path = os.path.join(fixtures, name)
        img = read_rgb(path)
        digest = hashlib.sha256(img.tobytes()).hexdigest()
        check(digest == entry["sha256_rgb"],
              f"pose_data: {name} decodes to {digest}, Pillow "
              f"{manifest['pillow']} to {entry['sha256_rgb']}")
        report[name] = {"bytes": entry["bytes"], "shape": list(img.shape)}
    print(f"[pose_data] JPEG fixtures bit-equal to Pillow {manifest['pillow']}"
          f" (libjpeg-turbo {manifest['libjpeg_turbo']}): "
          f"{json.dumps(report)} | {line}", flush=True)
    return report


def pose_train_from_disk(line: str, data: str, run_root: str,
                         launched: collections.Counter) -> dict:
    """`cli.train_pose.main` at the full width of pose_config(),
    bit-parity, batch 10, frames 4 apart, 8 workers, POSE_DATA_STEPS
    steps from step POSE_DATA_START (so that the loop's image shot fires
    at its last step): the launches over the steps (zeroed just before,
    read at the last step's end: one K3-flow, K4 and K2 a step, nothing
    else), the image shot's label column in the pose palette, and the
    final snapshot restored equal to the trained state."""
    report = {}
    final = POSE_DATA_START + POSE_DATA_STEPS
    args = ["--json-path", os.path.join(data, "clean_video_dict.json"),
            "--label-path", os.path.join(data, "labels"),
            "--image-path", os.path.join(data, "images"),
            "--root-dir", run_root, "--batch-size", str(POSE_BATCH),
            "--num-videos", str(len(POSE_DATA_VIDEOS)),
            "--print-freq", str(LOOP_PRINT_FREQ),
            "--start-step", str(POSE_DATA_START), "--final-step", str(final)]
    at_last = {}
    inner = TSNet.optimize_parameters_on

    def read_at_last(self, batch):
        inner(self, batch)
        if self.state.step == POSE_DATA_STEPS:
            at_last.update(cuda_build.LAUNCHES)

    TSNet.optimize_parameters_on = read_at_last
    try:
        cuda_build.reset_launches()
        model, _ = train_pose.main(args)
        torch.cuda.synchronize()
        after = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    finally:
        TSNet.optimize_parameters_on = inner
    launched.update(at_last)
    per_step = {k: v / POSE_DATA_STEPS for k, v in at_last.items() if v}
    check(model.state.step == POSE_DATA_STEPS,
          f"pose_data: trained to step {model.state.step}")
    check(per_step == {k: 1 for k in TRAIN_KERNELS},
          f"pose_data: launches per step {per_step}")
    losses = model.get_current_losses()
    check(all(np.isfinite(v) for v in losses.values()),
          f"pose_data: non-finite loss {losses}")
    report.update({
        "launches_per_step": per_step,
        "image_shot_launches": {k: v - at_last.get(k, 0)
                                for k, v in after.items()},
        "last_losses": losses})

    # the image shot, read back: its label column in the pose palette
    shot = read_png(os.path.join(run_root, "imgshots",
                                 f"step_{final:06d}.png"))
    hw = shot.shape[0]
    colors = {tuple(c) for c in np.unique(
        shot[:, hw:2 * hw].reshape(-1, 3), axis=0)}
    palette = {tuple(c) for c in POSE_PALETTE.tolist()} | {(0, 0, 0)}
    report["image_shot"] = {"shape": list(shot.shape),
                            "label_colours": len(colors)}
    check(shot.shape == (hw, 5 * hw, 3) and colors <= palette
          and len(colors) > 5,
          f"pose_data: image shot {shot.shape}, label colours {colors}")

    snaps = os.path.join(run_root, "snapshots")
    snap = find_latest_checkpoint(snaps)
    check(os.path.basename(snap) == f"TSNet_S{final:06d}.msgpack",
          f"pose_data: snapshot {snap}")
    fresh = create_train_state(model.mods.cfg, device="cuda", seed=7)
    restore_checkpoint(snap, fresh)
    bad = _train_state_equal(model.state, fresh)
    check(not bad, f"pose_data: restored state differs: {bad[:8]}")
    report["snapshot"] = os.path.basename(snap)
    del fresh, model
    torch.cuda.empty_cache()
    print(f"[pose_data] {POSE_DATA_STEPS} steps through cli.train_pose at "
          f"batch {POSE_BATCH}: {json.dumps(report)} | {line}", flush=True)
    return report


def pose_demo_tier(line: str, pair: str, tier: str, data: str, out: str,
                   sample: dict, launched: collections.Counter) -> dict:
    """One `cli.demo_pose.main` run (see `pose_data_phase`)."""
    extra, warp_kernel = DEMO_TIERS[tier]
    args = ["--data-root", data, "--json-root", data, "--pair", pair,
            "--max-frames", str(POSE_DEMO_FRAMES), "--chunk", str(CHUNK),
            "--out-dir", out] + extra
    cuda_build.reset_launches()
    res = demo_pose.main(args)
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    launched.update(launches)
    chunks = -(-POSE_DEMO_FRAMES // CHUNK)
    cfg = dataclasses.replace(pose_config(), precision="high",
                              fast_tail=bool(extra))
    check(launches == with_k8({warp_kernel: chunks,
                               "instance_norm_mean": chunks}, cfg, chunks, 1),
          f"pose_data demo {pair} {tier}: launches {launches}")

    hw = cfg.image_size
    rec = res["rec"]
    check(rec.shape == (POSE_DEMO_FRAMES, 3, hw, hw)
          and np.isfinite(rec).all(), f"pose_data demo {tier}: output")
    src, tar, idx = sample["src"], sample["tar"], res["ref_idx"]
    plain = ClipInference(cfg, TSNetModules(cfg, seed=0), use_kernels=False)
    want = plain.run_renormalized(src["img"][idx], src["lbl"][idx],
                                  src["bbox"][idx], tar["lbl"], tar["bbox"])
    del plain
    err = np.abs(rec - want)
    report = {"diff_sex": res["diff_sex"], "launches": launches,
              "vs_plain_mean_abs": float(err.mean()),
              "vs_plain_max_abs": float(err.max())}
    check(report["vs_plain_mean_abs"] <= DEMO_TOL,
          f"pose_data demo {pair} {tier}: kernel path vs plain {report}")
    mean = cfg.img_mean_array()
    check(len(res["names"]) == POSE_DEMO_FRAMES, "pose_data: montages")
    last = POSE_DEMO_FRAMES - 1
    want_row = np.concatenate([
        to_display_rgb(src["img"][min(last, len(src["img"]) - 1)] / 255.0,
                       mean),
        labels_to_image(tar["lbl"][last], "pose"),
        to_display_rgb(tar["img"][last] / 255.0, mean),
        to_display_rgb(rec[last], mean)], axis=1)
    check(np.array_equal(read_png(os.path.join(out, res["names"][-1])),
                         want_row), f"pose_data demo {tier}: last montage")
    with open(res["gif"], "rb") as f:
        gif = f.read()
    size, delays = gif_frames(gif)
    check(size == (4 * hw, hw) and delays == [10] * POSE_DEMO_FRAMES,
          f"pose_data demo {tier}: GIF of {size} with delays {delays}")
    report["gif_bytes"] = len(gif)
    print(f"[pose_data] demo_pose {pair!r} {tier}: {json.dumps(report)} | "
          f"{line}", flush=True)
    return report


def dance_keypoints(n: int, hw: int) -> np.ndarray:
    """n frames of crop-local validated keypoints (n, 137, 2) of the
    dancing figure in an hw^2 crop, every fifth frame's left hand and
    face ring undetected."""
    frames = []
    for f in range(n):
        p = dance_person(hw / 2, hw / 2, hw / 4, 0.4 * f)
        parts = [np.asarray(p[k], np.float64).reshape(-1, 3) for k in (
            "pose_keypoints_2d", "face_keypoints_2d",
            "hand_left_keypoints_2d", "hand_right_keypoints_2d")]
        if f % 5 == 0:
            parts[1][:, 2] = parts[2][:, 2] = 0.0
        frames.append(np.concatenate([valid_keypoints(x) for x in parts]))
    return np.stack(frames).astype(np.float32)


def pose_serve(line: str, snap: str, launched: collections.Counter) -> dict:
    """Pose serving: `rasterize_pose_clip` on the card against its CPU run
    (a 32-frame chunk: bit-equal), then per tier (bench, bit-parity)
    `cli.serve.Server` on pose_config() with the trained snapshot, on
    127.0.0.1 from a thread: a 64-frame (F, 137, 2) base64 request
    (launches zeroed just before and read just after: one warp kernel and
    one K2 a chunk), frames within 1 LSB of an in-process
    `push_keypoints`."""
    base = pose_config()
    hw = base.image_size
    kp = dance_keypoints(SERVE_FRAMES, hw)
    report = {}

    def parts(k, device):
        bw = torch.ones(len(k), device=device)
        return (k[:, :25], k[:, 25:95], k[:, 95:116], k[:, 116:137], bw,
                torch.clamp(bw / 3.0, min=1.0))

    k_dev = torch.as_tensor(kp[:CHUNK], device="cuda")
    lbl_dev = rasterize_pose_clip(*parts(k_dev, "cuda"), hw, hw).cpu()
    lbl_cpu = rasterize_pose_clip(*parts(torch.as_tensor(kp[:CHUNK]), "cpu"),
                                  hw, hw)
    rast = {"pixels_differing_from_cpu": int((lbl_dev != lbl_cpu).sum()),
            "classes": len(torch.unique(lbl_cpu))}
    report["rasterizer"] = rast
    print(f"[pose_data] rasterize_pose_clip, {CHUNK} frames at {hw}^2: "
          f"{json.dumps(rast)} | {line}", flush=True)
    check(rast["pixels_differing_from_cpu"] == 0 and rast["classes"] > 10,
          "pose_data: pose rasterizer on the card vs its CPU run")

    rng = np.random.default_rng(4)
    s = base.n_source
    payload = {"src_img": rng.integers(0, 256, (s, hw, hw, 3)).tolist(),
               "src_lbl": rng.integers(0, base.label_nc, (s, hw, hw)).tolist(),
               "src_bbox": rng.integers(0, 2, (s, hw, hw)).tolist()}
    for tier in ("bench", "bit-parity"):
        cfg = (dataclasses.replace(base, precision="high", fast_tail=True,
                                   fast_trunk=True)
               if tier == "bench" else base)
        mods = load_params(snap, cfg, device="cuda")
        server = Server(cfg, mods, chunk=CHUNK)
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        res = {}
        try:
            sid = _http(url + "/session", payload)["session"]
            torch.cuda.synchronize()
            cuda_build.reset_launches()
            body = _http(url + "/frames", {"session": sid,
                                           "keypoints": kp.tolist(),
                                           "encoding": "base64"})
            torch.cuda.synchronize()
            launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
            launched.update(launches)
            frames = _frames(body)
            chunks = -(-SERVE_FRAMES // CHUNK)
            res["launches"] = launches
            check(launches == with_k8({SERVE_KERNELS[tier]: chunks,
                                       "instance_norm_mean": chunks},
                                      cfg, chunks, 0),
                  f"pose_data serve {tier}: launches {launches}")
            check(frames.shape == (SERVE_FRAMES, hw, hw, 3),
                  f"pose_data serve {tier}: frames {frames.shape}")
            inproc = server.sessions[sid].push_keypoints(kp)[..., ::-1]
            res["http_vs_inprocess_max_levels"] = int(np.abs(
                frames.astype(np.int16) - inproc).max())
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=60)
        check(not thread.is_alive(),
              f"pose_data serve {tier}: server thread still alive")
        check(res["http_vs_inprocess_max_levels"] <= 1,
              f"pose_data serve {tier}: served vs in-process frames")
        print(f"[pose_data] serve {tier}: {json.dumps(res)} | {line}",
              flush=True)
        report[tier] = res
        del mods, server
        torch.cuda.empty_cache()
    return report


def pose_data_phase(line: str) -> dict:
    """The pose variant from files on disk at the full width of
    pose_config() (see the module docstring, step 12): the JPEG fixtures
    against their manifest, a synthetic dance set, `cli.train_pose`,
    `cli.eval_snapshots --task pose`, `cli.demo_pose` on a same-build
    pair in two tiers and a cross-build pair in the default tier, and pose
    serving. Its files go to a
    git-ignored `chip_smoke_pose_data_*` directory of the checkout.
    Returns its report, with the launches of its counted runs by kernel
    under "launches"."""
    launched = collections.Counter()
    report = {}
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pose_data_",
                                     dir=root) as tmp:
        data = os.path.join(tmp, "data")
        manifest = write_dance_set(data)
        report["jpeg"] = jpeg_fixture_check(line, manifest)

        run_root = os.path.join(tmp, "run")
        report["train"] = pose_train_from_disk(line, data, run_root, launched)
        snaps = os.path.join(run_root, "snapshots")

        cuda_build.reset_launches()
        rows = eval_snapshots.main([
            "--snapshot-dir", snaps, "--task", "pose", "--data-root", data,
            "--subject", "%05d" % POSE_DATA_VIDEOS[0],
            "--out-dir", os.path.join(tmp, "eval")])
        torch.cuda.synchronize()
        launched.update(cuda_build.LAUNCHES)
        n_snaps = len([f for f in os.listdir(snaps) if f.endswith(".msgpack")])
        report["eval"] = {"rows": rows,
                          "launches": {k: v for k, v in
                                       cuda_build.LAUNCHES.items() if v}}
        check(len(rows) == n_snaps >= 1 and all(np.isfinite(
            [r[k] for k in ("l1", "psnr", "ssim")]).all() for r in rows),
              f"pose_data: eval_snapshots rows {rows}")
        print(f"[pose_data] eval_snapshots --task pose: "
              f"{json.dumps(report['eval'])} | {line}", flush=True)
        torch.cuda.empty_cache()

        for name, pair in POSE_DATA_PAIRS.items():
            sample = PoseDatasetTest(
                [pair], os.path.join(data, "clean_video_dict.json"),
                os.path.join(data, "clean_unseen_video_dict.json"),
                os.path.join(data, "labels"),
                os.path.join(data, "smooth_openpose"),
                os.path.join(data, "images"),
                n_frame_total=POSE_DEMO_FRAMES)[0]
            check(sample["diff_sex"] == POSE_DATA_SEX[name],
                  f"pose_data: pair {pair} is {sample['diff_sex']!r}")
            for tier in POSE_DEMO_TIERS[name]:
                report[f"demo {name} {tier}"] = pose_demo_tier(
                    line, pair, tier, data, os.path.join(
                        tmp, f"demo_{name}_{tier}"), sample, launched)
                torch.cuda.empty_cache()
        report["serve"] = pose_serve(line, find_latest_checkpoint(snaps),
                                     launched)
    report["launches"] = dict(launched)
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


def flow_phase(line: str) -> dict:
    """K5 through `transformation_warp(use_kernels=True)`, one source of
    the train batch (B=15, 32x32, C=512): flow and warped output at temps
    100 and 10 against the plain path, the five input gradients under a
    fixed cotangent of the flow, and the kernel's ms beside the plain
    version's."""
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

    # times at temp 100
    res["ms"] = time_ms(lambda: fl.masked_attention_flow_fused(*flat))
    res["plain_ms"] = time_ms(lambda: fl.masked_attention_flow(*flat),
                              iters=3)
    res.update(launches=launches, tier=STANDALONE,
               replaces="wacv23_tsnet_tpu/ops/pallas_similarity.py:74",
               source="wacv23_tsnet_tpu_torch/csrc/attention_flow.cu")
    print(f"[kernel] {name} (K5, B={b}, T=S={t}, C={c}, temp 100): "
          f"max_abs_err={res['max_abs_err']:.3e} kernel_ms={res['ms']:.4f} "
          f"plain_ms={res['plain_ms']:.4f} | {line}", flush=True)
    return res


def norm_phase(line: str) -> tuple[dict, dict]:
    """K8 `instance_norm_fused` at the decoder's last up stage of one
    32-frame request, (32, 256, 256, 64), and its phase layout
    (32, 128, 128, 256) with phase_groups=4; bf16 and f32, relu on and
    off; the path the planner chose (its cluster, and how many such
    clusters run at once) against the plain version in fp32 (before its
    one rounding), the forced three-launch path the same way, the phase
    identity, and the kernel's ms beside the plain version's. Returns the
    kernels line's rows: the bf16 case of each shape."""
    name = "instance_norm_fused"
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases, launches = {}, 0
    for groups, shape in K8_SHAPES.items():
        _, h, w, c = shape
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
                del launch3
                res["ms"] = time_ms(kernel)
                res["plain_ms"] = time_ms(lambda: nk.instance_norm_fused_plain(
                    x, relu=relu, phase_groups=groups), iters=3)
                cases[key] = res
                print(f"[kernel] {key} (K8, {shape}, {where}): max_abs_err="
                      f"{res['max_abs_err']:.3e} mean_abs_err="
                      f"{res['mean_abs_err']:.3e} (atol, rtol)="
                      f"{IN_TOL[dtype]} kernel_ms={res['ms']:.4f} plain_ms="
                      f"{res['plain_ms']:.4f} | {line}", flush=True)
                print(f"[kernel] {key} three-launch path (forced): "
                      f"max_abs_err={three['max_abs_err']:.3e} | {line}",
                      flush=True)
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
        del x32, x
        torch.cuda.empty_cache()
    launches += decoder_norm_shapes(line)
    launches += trunk_norm_shapes(line)
    # the kernels line's rows: the bf16 case of each shape, with K8's
    # launches on the bench tier's main path (the phase decoder's norms)
    rows = tuple(dict(cases[f"{name}_g{g}_bf16"], tier="bench",
                      launch=name,
                      replaces="wacv23_tsnet_tpu/ops/pallas_norms.py:206",
                      source="wacv23_tsnet_tpu_torch/csrc/in_fused.cu")
                 for g in K8_SHAPES)
    rows[0]["launches"] = launches
    return rows


def decoder_norm_shapes(line: str) -> int:
    """K8 at the phase decoder's norms of a 64-frame face chunk
    (DECODER_NORM_SHAPES), bf16: the planner's path, one launch a call,
    against its plain version in fp32 (before its one rounding) and
    against the ATen composition the decoder runs without it (a block's
    `instance_norm` and ReLU, an up stage's `instance_norm_one_pass`), and
    the kernel's ms beside the composition's. Returns its launches."""
    name = "instance_norm_fused"
    gen = torch.Generator(device="cuda").manual_seed(8)
    launches = 0
    for key, (shape, groups, relu) in DECODER_NORM_SHAPES.items():
        _, h, w, c = shape
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 1).to(
            torch.bfloat16)
        plan = nk.fused_plan(h * w, c, groups, x.element_size(),
                             x.data_ptr() % 16 == 0)

        def kernel():
            return nk.instance_norm_fused(x, relu=relu, phase_groups=groups)

        if groups == 4:
            def composition():
                return instance_norm_one_pass(x, groups=4, relu=True)
        else:
            def composition():
                y = instance_norm(x)
                return torch.relu(y) if relu else y

        out = one_launch(name, kernel)
        launches += 1
        want = nk.instance_norm_fused_plain(x, relu=relu, phase_groups=groups,
                                            out_dtype=torch.float32)
        res = compare(out, want, IN_TOL["bf16"])
        gap = (out.float() - composition().float()).abs()
        res["vs_composition_max_abs"] = gap.max().item()
        res["vs_composition_mean_abs"] = gap.mean().item()
        del out, want, gap
        check(res["worst_err_over_tol"] <= 1.0,
              f"{name} decoder {key} {shape} disagrees with its plain "
              f"version: {res}")
        res["ms"] = time_ms(kernel)
        res["composition_ms"] = time_ms(composition)
        print(f"[kernel] {name} decoder {key} (K8, {shape}, g={groups}, "
              f"relu={relu}, {plan.path} of {plan.cluster} blocks x "
              f"{plan.rows_per_block} pixels, {plan.smem_bytes} B shared): "
              f"max_abs_err={res['max_abs_err']:.3e} vs composition max "
              f"{res['vs_composition_max_abs']:.3e} mean "
              f"{res['vs_composition_mean_abs']:.3e} kernel_ms="
              f"{res['ms']:.4f} composition_ms={res['composition_ms']:.4f}"
              f" | {line}", flush=True)
        del x
        torch.cuda.empty_cache()
    return launches


def trunk_norm_shapes(line: str) -> int:
    """K8's two-pass form at the fp32 trunk norms of a 64-frame face chunk
    (TRUNK_NORM_SHAPES), relu on: the cluster path, one launch a call,
    against its plain version and against the composition the encoders
    run without it (`instance_norm` or `instance_norm_phase`, then the
    ReLU), on channels far from 0. A check; nothing is timed. Returns its
    launches."""
    name = "instance_norm_fused"
    gen = torch.Generator(device="cuda").manual_seed(12)
    launches = 0
    for key, (shape, groups) in TRUNK_NORM_SHAPES.items():
        _, h, w, c = shape
        x = torch.randn(shape, generator=gen, device="cuda") * 2 + 21
        plan = nk.fused_plan(h * w, c, groups, 4, x.data_ptr() % 16 == 0)
        check(plan.path == "cluster", f"{name} trunk {key}: {plan}")
        out = one_launch(name, lambda: nk.instance_norm_fused(
            x, relu=True, phase_groups=groups, two_pass=True))
        launches += 1
        res = compare(out, nk.instance_norm_two_pass_plain(
            x, relu=True, phase_groups=groups), IN_TOL["f32"])
        comp = torch.relu(instance_norm(x) if groups == 1
                          else instance_norm_phase(x, groups=groups))
        gap = compare(out, comp, IN_TOL["f32"])
        del out, comp
        check(res["worst_err_over_tol"] <= 1.0
              and gap["worst_err_over_tol"] <= 1.0,
              f"{name} trunk {key} {shape} two-pass disagrees: {res} "
              f"(composition: {gap})")
        print(f"[kernel] {name} trunk {key} (K8 two-pass, {shape}, "
              f"g={groups}, cluster of {plan.cluster}): max_abs_err="
              f"{res['max_abs_err']:.3e} vs composition max "
              f"{gap['max_abs_err']:.3e} | {line}", flush=True)
        del x
        torch.cuda.empty_cache()
    return launches


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


def clip_src(cfg, s: int, frames: int, seed: int = 0) -> tuple:
    """Seeded clip inputs on the card: s sources and `frames` driving
    frames (label maps and boxes), as main_path makes them."""
    rng = np.random.default_rng(seed)
    hw, nl = cfg.image_size, cfg.label_nc
    arrays = (rng.random((s, hw, hw, 3), np.float32),
              rng.integers(0, 2, (s, hw, hw, nl)).astype(np.float32),
              rng.integers(0, 2, (s, hw, hw)).astype(np.float32),
              rng.integers(0, 2, (frames, hw, hw, nl)).astype(np.float32),
              rng.integers(0, 2, (frames, hw, hw)).astype(np.float32))
    return tuple(torch.as_tensor(a, device="cuda") for a in arrays)


def launched() -> dict:
    """The launch counts that are not 0."""
    return {k: v for k, v in cuda_build.LAUNCHES.items() if v}


def counted(fn):
    """fn() with the launch counts zeroed just before and read just after:
    (its result, the counts that are not 0)."""
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, launched()


def step_once(state, step, batch: dict) -> dict:
    """One train step, counted; metrics, rec and every gradient (flat,
    on the host) of the state after it."""
    (state, metrics, rec), launches = counted(
        lambda: step(state, batch, TRAIN_LR))
    check(state.step == 1, f"{PARALLEL}: step count {state.step}")
    grads = torch.cat([p.grad.flatten() for p in state.mods.parameters()
                       if p.grad is not None]).cpu()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "rec": rec.cpu(), "grads": grads, "launches": launches}


PARALLEL = "parallel"
PAR_TRAIN_BATCH = 16      # the two-rank step: 8 samples a rank
PAR_FRAMES = 64
PAR_SEED = 7
PAR_TIMEOUT = 600.0       # the two ranks' join limit, seconds
PAR_STEP_TOL = 5e-3       # metrics and rec, the CPU tests' bar
PAR_TP_MAX, PAR_TP_MEAN = 5e-3, 2e-4   # TP+SP clip, tests/test_parallel.py
TRAIN_KERNEL_LAUNCHES = {"transform_warp_pairs": 1,
                         "transform_warp_pairs_bwd": 1,
                         "instance_norm_mean": 1}


def parallel_one_rank(line: str, store: str) -> dict:
    """A (1, 1) mesh over NCCL in this process: the bit-parity train step
    at batch 15 through `make_parallel_train_step` against
    `make_train_step` from the same seeded state (the reconstruction, the
    metrics and every gradient bit for bit: the step sums in a fixed
    order), and `make_parallel_clip_infer` in the bit-parity and bench
    tiers bit for bit against `tsnet_forward_clip` over 64 frames.
    Launches counted."""
    cfg = face_config()
    batch = train_batch(cfg, TRAIN_BATCH)
    runs = {}
    init_distributed(0, 1, f"file://{store}")
    try:
        mesh = make_mesh()
        for name in ("single", "parallel"):
            state = create_train_state(cfg, seed=0)
            step = (make_parallel_train_step(state, mesh) if name == "parallel"
                    else make_train_step(state))
            runs[name] = step_once(state, step, batch)
            del state, step
            torch.cuda.empty_cache()
        one, par = runs["single"], runs["parallel"]
        report = {"launches": par["launches"],
                  "rec_bit_equal": bool(torch.equal(par["rec"], one["rec"])),
                  "metrics_bit_equal": par["metrics"] == one["metrics"],
                  "grads_bit_equal": bool(torch.equal(par["grads"],
                                                      one["grads"]))}
        if not report["grads_bit_equal"]:
            report["grads_rel_l2"] = ((par["grads"] - one["grads"]).norm()
                                      / one["grads"].norm()).item()
        print(f"[{PARALLEL}] (1, 1) NCCL train step, batch {TRAIN_BATCH}, "
              f"bit-parity: {json.dumps(report)} | {line}", flush=True)
        for key in ("rec", "metrics", "grads"):
            check(report[f"{key}_bit_equal"],
                  f"{PARALLEL}: (1, 1) step {key} differ from one process")
        check(par["launches"] == TRAIN_KERNEL_LAUNCHES
              and one["launches"] == TRAIN_KERNEL_LAUNCHES,
              f"{PARALLEL}: (1, 1) step launched {par['launches']}")
        del runs, one, par
        src = clip_src(cfg, cfg.n_source, PAR_FRAMES)
        bench = dataclasses.replace(cfg, precision="high", fast_tail=True,
                                    fast_trunk=True)
        for tier, tcfg, warp in (
                ("bit-parity", cfg, "transform_warp_pairs_nf"),
                ("bench", bench, "transform_warp_pairs_mean")):
            mods = TSNetModules(tcfg, seed=0)
            want = tsnet_forward_clip(mods, *src)
            run = make_parallel_clip_infer(mods, mesh, use_kernels=True)
            got, launches = counted(lambda: run(*src))
            res = {"bit_equal": bool(torch.equal(got, want)),
                   "launches": launches}
            print(f"[{PARALLEL}] (1, 1) NCCL clip, {tier}, {PAR_FRAMES} "
                  f"frames: {json.dumps(res)} | {line}", flush=True)
            check(res["bit_equal"], f"{PARALLEL}: (1, 1) {tier} clip differs")
            check(launches == with_k8({warp: 1, "instance_norm_mean": 1},
                                      tcfg, 1, 1),
                  f"{PARALLEL}: (1, 1) {tier} clip launched {launches}")
            report[f"clip_{tier}"] = res
            del mods, want, got
            torch.cuda.empty_cache()
        report["collectives"] = {"/".join(k): v
                                 for k, v in mesh.calls.items()}
    finally:
        dist.destroy_process_group()
    return report


TAIL_FUSED = "high+fast_tail+fused"


def par_clip_cases(cfg) -> dict:
    """The (1, 2) clips of the two-rank run: name -> (config, arguments of
    `make_parallel_clip_infer`, TSNET_FUSE_PAIR_KERNEL on, the subnets
    split over `model`). The single-process reference runs
    `tsnet_forward_clip` with the same `use_kernels` and `fused_blocks`.
    `high+fast_tail+fused` splits only FuseNet and the decoder, the two
    subnets whose blocks K6 and K7 compute (each gathering its block's
    weights), so that the encoders' TP rounding, which the temp-100
    attention amplifies, stays out of that comparison."""
    bench = dataclasses.replace(cfg, precision="high", fast_tail=True,
                                fast_trunk=True)
    fused = dict(use_kernels=True, fused_blocks=True)
    return {
        "tp_sp_plain": (cfg, dict(use_kernels=False, spatial_parallel=True),
                        False, GEN_SUBNETS),
        "tp_kernels": (cfg, dict(use_kernels=True), False, GEN_SUBNETS),
        FUSED_TIER: (bench, fused, True, GEN_SUBNETS),
        TAIL_FUSED: (dataclasses.replace(bench, fast_trunk=False), fused,
                     True, ("fuse_net", "dec")),
    }


def parallel_rank(rank: int, world: int, store: str) -> dict:
    """One of two ranks on the one card over gloo (NCCL refuses two ranks
    on one device; the mesh stages each collective through host memory):
    the (2, 1) bit-parity train step at batch 16, then on a (1, 2) mesh
    each clip of `par_clip_cases`, 64 frames, and the source features of
    `bench+fused` under TP. Rank 0 returns the outputs; both return their
    launch counts and collectives."""
    torch.cuda.set_device(0)
    init_distributed(rank, world, f"file://{store}", backend="gloo")
    cfg = face_config()
    out = {}
    dp = make_mesh(model_parallel=1)
    state = create_train_state(cfg, seed=0)
    step = make_parallel_train_step(state, dp)
    batch = shard_batch(train_batch(cfg, PAR_TRAIN_BATCH, PAR_SEED), dp)
    res = step_once(state, step, batch)
    del res["grads"]
    if rank:
        del res["rec"]
    out["train"] = res
    del state, step, batch
    torch.cuda.empty_cache()
    tp = make_mesh(model_parallel=2)
    src = clip_src(cfg, cfg.n_source, PAR_FRAMES)
    for name, (tcfg, kw, fused, split) in par_clip_cases(cfg).items():
        mods = TSNetModules(tcfg, seed=0)
        for sub in split:
            shard_modules(getattr(mods, sub), tp)
        run = make_parallel_clip_infer(mods, tp, **kw)
        with fuse_pair_kernel(fused):
            frames, launches = counted(lambda: run(*src))
        out[name] = {"launches": launches}
        # every rank runs the TP encoder: its blocks' collectives
        fea = (encode_sources(mods, *src[:3])["fea"].float().cpu()
               if name == FUSED_TIER else None)
        if rank == 0:
            out[name]["frames"] = frames.cpu()
            if fea is not None:
                out[name]["fea"] = fea
        del mods, run, frames, fea
        torch.cuda.empty_cache()
    out["collectives"] = {
        mesh: {"/".join(k): v for k, v in m.calls.items()}
        for mesh, m in (("(2, 1)", dp), ("(1, 2)", tp))}
    return out


def parallel_two_ranks(line: str, store: str) -> dict:
    """Two ranks on the one card over gloo (`parallel_rank`), against one
    process: the (2, 1) step at batch 16 against the single-process step
    at batch 16 (metrics and rec within the CPU bar, 5e-3); on (1, 2), the
    TP+SP clip (plain path, bit-parity) and the TP clip on the kernel path
    against one process (<=5e-3 max, <=2e-4 mean); the clip with the fused
    opt-ins (K6, K7: each gathers its block's weights) in "high" +
    `fast_tail`, FuseNet and the decoder split, against one process
    (<=0.01 mean L1); and `bench+fused` with every subnet split, printed
    with its source features' error, which is held at bf16 resolution:
    with random weights the temp-100 attention turns the encoders' TP
    rounding into a drift past the 0.01 budget (ROADMAP queue 3).
    Launches read per rank; every result printed before any check."""
    cfg = face_config()
    state = create_train_state(cfg, seed=0)
    single = step_once(state, make_train_step(state),
                       train_batch(cfg, PAR_TRAIN_BATCH, PAR_SEED))
    del state
    torch.cuda.empty_cache()
    src = clip_src(cfg, cfg.n_source, PAR_FRAMES)
    cases = par_clip_cases(cfg)
    want = {}
    for name, (tcfg, kw, fused, _) in cases.items():
        mods = TSNetModules(tcfg, seed=0)
        with fuse_pair_kernel(fused):
            want[name] = tsnet_forward_clip(
                mods, *src, use_kernels=kw["use_kernels"],
                fused_blocks=kw.get("fused_blocks", False)).cpu()
        if name == FUSED_TIER:
            want_fea = encode_sources(mods, *src[:3])["fea"].float().cpu()
        del mods
        torch.cuda.empty_cache()
    del src
    torch.cuda.empty_cache()
    ranks = spawn_ranks(parallel_rank, 2, (store,), timeout=PAR_TIMEOUT)
    got = ranks[0]          # its tensors come back as numpy arrays
    m_err = max(abs(got["train"]["metrics"][k] - v)
                for k, v in single["metrics"].items())
    rec_err = (torch.from_numpy(got["train"]["rec"])
               - single["rec"]).abs().max().item()
    report = {"train": {"metrics_max_abs": m_err, "rec_max_abs": rec_err,
                        "launches_per_rank": [r["train"]["launches"]
                                              for r in ranks]}}
    checks = [(set(got["train"]["metrics"]) == set(single["metrics"])
               and m_err <= PAR_STEP_TOL and rec_err <= PAR_STEP_TOL,
               f"(2, 1) step against one process: {report['train']}"),
              (all(r["train"]["launches"] == TRAIN_KERNEL_LAUNCHES
                   for r in ranks),
               f"(2, 1) step launches {report['train']}")]
    # K8: the decoder's up stages; with "high" encoders (not the bench
    # tier's `fast_trunk`) also each encoder's stem and stride-2 convs
    # and the image encoder's blocks, which are not split over `model`
    # there
    stems = 2 * (1 + cfg.n_downsampling)
    fused = {"transform_warp_pairs_mean": 1, "instance_norm_mean": 1,
             "fuse_pair_conv2": 1, "conv3x3_in": 2 * cfg.dec_n_blocks,
             "instance_norm_fused": cfg.n_downsampling}
    expect = {"tp_sp_plain": {},
              "tp_kernels": {"transform_warp_pairs_nf": 1,
                             "instance_norm_mean": 1},
              FUSED_TIER: fused,
              TAIL_FUSED: dict(fused, instance_norm_fused=cfg.n_downsampling
                               + stems + 2 * cfg.enc_n_blocks)}
    for name in cases:
        diff = (torch.from_numpy(got[name]["frames"]) - want[name]).abs()
        res = {"max_abs": diff.max().item(), "mean_abs": diff.mean().item(),
               "launches_per_rank": [r[name]["launches"] for r in ranks]}
        if name == FUSED_TIER:
            fea = torch.from_numpy(got[name]["fea"])
            res["source_fea_rel_l2"] = ((fea - want_fea).norm()
                                        / want_fea.norm()).item()
            ok = res["source_fea_rel_l2"] <= 2.0 ** -7
        elif name == TAIL_FUSED:
            ok = res["mean_abs"] <= 0.01
        else:
            ok = res["max_abs"] <= PAR_TP_MAX and res["mean_abs"] <= PAR_TP_MEAN
        report[name] = res
        checks += [(ok, f"(1, 2) {name} clip against one process: {res}"),
                   (all(r[name]["launches"] == expect[name] for r in ranks),
                    f"(1, 2) {name} launches {res}")]
    report["collectives"] = got["collectives"]
    print(f"[{PARALLEL}] two ranks on one card over gloo (collectives staged "
          f"through host memory): {json.dumps(report)} | {line}", flush=True)
    for ok, what in checks:
        check(ok, f"{PARALLEL}: {what}")
    return report


def parallel_phase(line: str, root: str) -> dict:
    """`[parallel]`: the (1, 1) NCCL mesh in this process, then two gloo
    ranks on the one card. One card measures no scaling: these are
    correctness runs."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_",
                                     dir=root) as tmp:
        report = parallel_one_rank(line, os.path.join(tmp, "store_nccl"))
        torch.cuda.empty_cache()
        report["two_ranks"] = parallel_two_ranks(
            line, os.path.join(tmp, "store_gloo"))
    # launches on the path, for the kernels line: one rank's (1, 1) step
    # and clips, and rank 0 of the two-rank runs
    total = collections.Counter(report["launches"])
    for tier in ("bit-parity", "bench"):
        total.update(report[f"clip_{tier}"]["launches"])
    two = report["two_ranks"]
    total.update(two["train"]["launches_per_rank"][0])
    for name in par_clip_cases(face_config()):
        total.update(two[name]["launches_per_rank"][0])
    report["launches"] = dict(total)
    return report


SWEEP = "sweep"
SWEEP_CALLS = 6 * 8       # a warm-up and five timed calls, eight configs
K1_SWEEP_SHAPES = ((1, 64), (5, 64), (3, 128))   # (S, F)


def k1_case(s: int, f: int, g) -> dict:
    """K1 (bf16 out, as the bench tier runs it) at S sources and F frames
    of T = 32 x 32, C = 512, against its plain version. At S=5 the JAX
    package would take the streamed K1b (past its 10-MiB resident
    budget)."""
    h = w = 32
    t, c = h * w, 512
    src = torch.randn(s, t, c, generator=g)
    args = tuple(x.to("cuda").contiguous() for x in (
        src, l2_normalize(torch.randn(f, t, c, generator=g)),
        l2_normalize(src), (torch.rand(f, t, generator=g) > 0.5).float(),
        (torch.rand(s, t, generator=g) > 0.5).float(),
        normalized_grid(h, w).reshape(t, 2)))
    return dict(
        kernel=lambda: wk.transform_warp_pairs_mean(
            *args, h, w, out_dtype=torch.bfloat16),
        plain=lambda: wk.transform_warp_mean_plain(
            *args, h, w, out_dtype=torch.float32),
        tol=TOL["bf16"])


def sweep_phase(line: str) -> dict:
    """`[sweep]`: `cli.bench_sweep.main([])` at full width (its 8 lines,
    one K1 and one K2 a clip call, nothing else), K1 at (S, F) = (1, 64),
    (5, 64) and (3, 128) against its plain version, and the
    bench_sweep tier's clip at S=5, F=128 against its plain path (<=0.01
    mean L1)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lines, launches = counted(lambda: bench_sweep.main([]))
    for text in buf.getvalue().splitlines():
        print(f"[{SWEEP}] {text} | {line}", flush=True)
    check(len(lines) == 8 and all(x["value"] > 0 for x in lines),
          f"{SWEEP}: {len(lines)} lines")
    # the sweep's tier: "high" with fast_tail, the face decoder's depth;
    # each clip call encodes its sources once
    sweep_cfg = dataclasses.replace(face_config(), precision="high",
                                    fast_tail=True)
    check(launches == with_k8({"transform_warp_pairs_mean": SWEEP_CALLS,
                               "instance_norm_mean": SWEEP_CALLS},
                              sweep_cfg, SWEEP_CALLS, SWEEP_CALLS),
          f"{SWEEP}: launched {launches} in {SWEEP_CALLS} clip calls")
    g = torch.Generator().manual_seed(11)
    kernels = check_cases({f"transform_warp_pairs_mean_s{s}_f{f}":
                           k1_case(s, f, g) for s, f in K1_SWEEP_SHAPES},
                          line)
    cfg = dataclasses.replace(face_config(), precision="high",
                              fast_tail=True)
    mods = TSNetModules(cfg, seed=0)
    src = clip_src(cfg, 5, 128, seed=3)
    out = tsnet_forward_clip(mods, *src)
    plain = tsnet_forward_clip(mods, *src, use_kernels=False)
    mean_l1 = (out - plain).abs().mean().item()
    print(f"[{SWEEP}] clip S=5, F=128, the sweep's tier: kernel path vs "
          f"plain path mean_abs={mean_l1:.4e} | {line}", flush=True)
    check(mean_l1 <= 0.01, f"{SWEEP}: S=5, F=128 clip vs plain {mean_l1}")
    del mods, src, out, plain
    torch.cuda.empty_cache()
    return {"lines": lines, "launches": launches, "kernels": kernels,
            "clip_s5_f128_mean_abs": mean_l1}


ZOO_TOL = 1e-3            # card vs CPU, max abs (fp32, TF32 off)


def zoo_phase(line: str) -> dict:
    """`[zoo]`: the zoo's networks at 256² from one seed on the card
    against the CPU (outputs, max abs), and the WGAN-GP penalty (mixed,
    fixed alpha) on PixelGAN and PatchGAN."""
    x = torch.from_numpy(np.random.default_rng(5).random(
        (2, 256, 256, 3), np.float32))

    def video(device):
        net = VideoDiscriminator(3)
        net.reset_parameters(torch.Generator().manual_seed(0))
        return net.to(device)

    nets = {
        "resnet_9blocks": lambda d: define_G(3, 3, 64, "resnet_9blocks",
                                             device=d),
        "unet_256": lambda d: define_G(3, 3, 64, "unet_256", device=d),
        "basic": lambda d: define_D(3, 64, "basic", device=d),
        "pixel": lambda d: define_D(3, 64, "pixel", device=d),
        "video": video,
    }
    report = {}
    for name, make in nets.items():
        cpu = make("cpu")
        card = make("cuda")
        card.load_state_dict(cpu.state_dict())
        with torch.no_grad():
            want, got = cpu(x), card(x.cuda())
        wants = want if isinstance(want, list) else [want]
        gots = got if isinstance(got, list) else [got]
        err = max((a.cpu() - b).abs().max().item()
                  for a, b in zip(gots, wants))
        report[name] = {"max_abs": err}
        check(err <= ZOO_TOL, f"zoo: {name} card vs CPU {err}")
        del cpu, card
    alpha = torch.tensor([0.3, 0.8])
    for name in ("pixel", "basic"):
        cpu, card = nets[name]("cpu"), nets[name]("cuda")
        card.load_state_dict(cpu.state_dict())

        def logits(net):
            def fn(z):
                out = net(z)
                return out[-1] if isinstance(out, list) else out
            return fn

        want = gradient_penalty(logits(cpu), x, x * 0.5, alpha=alpha)
        got = gradient_penalty(logits(card), x.cuda(), x.cuda() * 0.5,
                               alpha=alpha)
        rel = abs(got.item() - want.item()) / abs(want.item())
        report[f"gradient_penalty_{name}"] = {"value": got.item(), "rel": rel}
        check(rel <= ZOO_TOL, f"zoo: gradient_penalty {name} rel {rel}")
    torch.cuda.empty_cache()
    print(f"[zoo] card vs CPU at 256², batch 2: {json.dumps(report)} | "
          f"{line}", flush=True)
    return report


def tools_phase(line: str, history: str, out_dir: str) -> dict:
    """`[tools]`: `cli.plot_history` on `[loop]`'s history.csv, the PNG
    decoded by the port's reader: its size (352 x 264 pixels a panel, up
    to four a row) and the curve's colour present."""
    out = os.path.join(out_dir, "loss_curves.png")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        plot_history.main(["--csv", history, "--out", out])
    said = buf.getvalue().strip()
    with open(history) as fh:
        n = len(fh.readline().strip().split(",")) - 2   # step, seconds
    img = read_png(out)
    cols = min(4, n)
    # matplotlib's size: the figure's inches times the dpi, truncated
    want = tuple(int(inch * k * plot_history.DPI) for inch, k in zip(
        plot_history.PANEL_IN[::-1], (-(-n // cols), cols)))
    line_px = int((np.abs(img.astype(int) - np.array(plot_history.LINE))
                   .max(-1) <= 40).sum())
    report = {"said": said, "panels": n, "shape": list(img.shape),
              "curve_pixels": line_px}
    print(f"[tools] plot_history on [loop]'s history.csv: "
          f"{json.dumps(report)} | {line}", flush=True)
    check(said.endswith(f"({n} panels)") and img.shape[:2] == want
          and line_px > 0, f"tools: plot_history {report}")
    return report


REWRITES = "rewrites"
REWRITE_TIERS = ("bit-parity", "bench", FUSED_TIER)
RING_CLIP_RTOL = 5e-4     # ring_pad clip vs pad clip, max rel (test_ring_pad)
POSE_RENDER_FRAMES = 32


@contextlib.contextmanager
def plain_decoder():
    """`models.tsnet.decode` swapped for the plain `Decoder` module while
    the block runs, so that both entry points decode through it: the form
    the phase-decomposed decoder is measured against."""
    inner = tsnet_module.decode

    def plain(mods, prop_fea, syn_fea, use_kernels=True, fused_blocks=False):
        return mods.dec(prop_fea, syn_fea, fused_blocks=fused_blocks,
                        use_kernels=use_kernels)

    tsnet_module.decode = plain
    try:
        yield
    finally:
        tsnet_module.decode = inner


def rewrite_cfg(tier: str):
    base = face_config()
    if tier == "bit-parity":
        return base
    return dataclasses.replace(base, precision="high", fast_tail=True,
                               fast_trunk=True)


def decoder_forms(line: str, tier: str) -> dict:
    """One tier of `[rewrites]`: the phase-decomposed decoder against the
    plain `Decoder` on the same prop/syn features of a 64-frame clip
    (bit-parity <=1e-3 max abs, the fast tiers <=0.01 mean L1); K7's
    launches inside the phase decoder in `bench+fused`; and
    `encoder_apply_fast` against `lbl_enc` at the clip's shape."""
    cfg = rewrite_cfg(tier)
    fused = tier == FUSED_TIER
    mods = TSNetModules(cfg, device="cuda", seed=0)
    src = clip_src(cfg, cfg.n_source, CLIP_FRAMES)
    res = {}
    with fuse_pair_kernel(fused), torch.inference_mode():
        pack = encode_sources(mods, *src[:3])
        tar_fea, tar_fea_n, tar_mask = label_features(mods, *src[3:])
        prop = propagate(mods, pack, tar_fea_n, tar_mask)
        syn = fuse_clip(mods.fuse_net, pack["fea"].float(), tar_fea.float())
        forms = {"phase": lambda: decode(mods, prop, syn,
                                         fused_blocks=fused),
                 "plain": lambda: mods.dec(prop, syn, fused_blocks=fused)}
        phase, launches = counted(forms["phase"])
        plain = forms["plain"]()
        diff = (phase.float() - plain.float()).abs()
        res["phase_vs_plain_max_abs"] = diff.max().item()
        res["phase_vs_plain_mean_abs"] = diff.mean().item()
        want = {"conv3x3_in": 2 * cfg.dec_n_blocks} if fused else {}
        if decoder_k8(cfg, fused):
            want["instance_norm_fused"] = decoder_k8(cfg, fused)
        check(launches == want, f"{REWRITES} {tier}: the phase decoder "
              f"launched {launches}, expected {want}")
        res["phase_decoder_launches"] = launches
        del phase, plain, diff
        # encoder_apply_fast against the module at the clip's shape
        if not fused:
            enc_fast = encoder_apply_fast(mods.lbl_enc, src[3])
            enc_diff = (enc_fast.float() - tar_fea.float()).abs()
            res["lbl_enc_fast_vs_module_max_abs"] = enc_diff.max().item()
            res["lbl_enc_fast_vs_module_mean_abs"] = enc_diff.mean().item()
            del enc_fast, enc_diff
        del pack, tar_fea, tar_fea_n, tar_mask, prop, syn
    key, tol = (("max_abs", 1e-3) if tier == "bit-parity"
                else ("mean_abs", 0.01))
    print(f"[{REWRITES}] decoder forms, {tier}, 64-frame clip: "
          f"{json.dumps(res)} | {line}", flush=True)
    check(res[f"phase_vs_plain_{key}"] <= tol,
          f"{REWRITES} {tier}: phase decoder vs plain Decoder {res}")
    if not fused:
        check(res[f"lbl_enc_fast_vs_module_{key}"] <= tol,
              f"{REWRITES} {tier}: encoder_apply_fast vs lbl_enc {res}")
    del mods, src
    torch.cuda.empty_cache()
    return res


def first_step_metrics(cfg, batch: dict) -> dict:
    """The metrics of the first train step of `cfg` from seed 0."""
    state = create_train_state(cfg, device="cuda", seed=0)
    _, metrics, _ = make_train_step(state)(state, batch, TRAIN_LR)
    out = {k: v.item() for k, v in metrics.items()}
    del state
    torch.cuda.empty_cache()
    return out


def train_forms(line: str) -> dict:
    """The bit-parity train step at batch 15 with each decoder form (the
    reconstruction of one forward from one state, phase vs plain, <=1e-3
    max abs), then `ring_pad` on against off: the first step's metrics
    (within STEP_METRIC_RTOL), and the 64-frame bit-parity clip
    (`ring_clip`): at softmax temp 10 within RING_CLIP_RTOL relative, at
    the config's 100 within that or twice the pad path's own spread under
    a 1e-6 input nudge."""
    cfg = face_config()
    batch = train_batch(cfg, TRAIN_BATCH)
    mods = TSNetModules(cfg, device="cuda", seed=0)
    recs = {}
    with torch.no_grad():
        for form, ctx in (("phase", contextlib.nullcontext()),
                          ("plain", plain_decoder())):
            with ctx:
                recs[form] = tsnet_forward(
                    mods, *(batch[k] for k in FORWARD_KEYS),
                    tar_img=batch["tar_img"], train=True)["rec_img"]
    rec_err = (recs["phase"] - recs["plain"]).abs().max().item()
    del mods, recs
    torch.cuda.empty_cache()
    pad = first_step_metrics(cfg, batch)
    ring = first_step_metrics(dataclasses.replace(cfg, ring_pad=True), batch)
    metric_err = {k: abs(v - pad[k]) / max(1.0, abs(pad[k]))
                  for k, v in ring.items()}
    res = {"train_rec_phase_vs_plain_max_abs": rec_err,
           "first_step_metrics": {"pad": pad, "ring_pad": ring},
           "ring_vs_pad_first_step_metrics_rel": metric_err}
    del batch
    torch.cuda.empty_cache()

    res.update(ring_clip(cfg))
    print(f"[{REWRITES}] train step (bit-parity, batch {TRAIN_BATCH}) by "
          f"decoder form, and ring_pad: {json.dumps(res)} | {line}",
          flush=True)
    check(rec_err <= 1e-3, f"{REWRITES}: train forward, phase vs plain "
          f"decoder {rec_err}")
    check(max(metric_err.values()) <= STEP_METRIC_RTOL,
          f"{REWRITES}: ring_pad first-step metrics vs pad {metric_err}")
    clip = res["ring_clip"]
    check(clip["temp10"]["ring_vs_pad_max_rel"] <= RING_CLIP_RTOL,
          f"{REWRITES}: ring_pad clip vs pad at temp 10 {clip}")
    top = clip[f"temp{cfg.softmax_temp:g}"]
    check(top["ring_vs_pad_max_rel"] <= max(
        RING_CLIP_RTOL, NUDGE_MARGIN * top["pad_nudged_vs_pad_max_rel"]),
          f"{REWRITES}: ring_pad clip vs pad at temp {cfg.softmax_temp:g}, "
          f"beyond the pad path's own spread {clip}")
    return res


def ring_clip(cfg) -> dict:
    """The 64-frame bit-parity clip with `ring_pad` on and off from one
    seed, at softmax temp 10 and at the config's 100: the largest
    difference over the largest value, the mean, the source features'
    relative L2, and the pad path's own spread under a 1e-6 relative
    nudge of the source images (the temp-100 attention of random weights
    turns rounding-level changes into flips, as the train checks find)."""
    src = clip_src(cfg, cfg.n_source, CLIP_FRAMES)
    gen = torch.Generator().manual_seed(4)
    nudged = (src[0] * (1 + INPUT_NUDGE * torch.randn(
        src[0].shape, generator=gen).to(src[0].device)),) + src[1:]
    out = {}
    for temp in (10.0, cfg.softmax_temp):
        clips, fea = {}, {}
        for name in ("pad", "ring_pad"):
            mods = TSNetModules(dataclasses.replace(
                cfg, ring_pad=name == "ring_pad", softmax_temp=temp), seed=0)
            clips[name] = tsnet_forward_clip(mods, *src)
            fea[name] = encode_sources(mods, *src[:3])["fea"].float()
            if name == "pad":
                clips["nudged"] = tsnet_forward_clip(mods, *nudged)
            del mods
        scale = clips["pad"].abs().max()
        out[f"temp{temp:g}"] = {
            "ring_vs_pad_max_rel": ((clips["ring_pad"] - clips["pad"]).abs()
                                    .max() / scale).item(),
            "ring_vs_pad_mean_abs": (clips["ring_pad"] - clips["pad"]).abs()
            .mean().item(),
            "pad_nudged_vs_pad_max_rel": ((clips["nudged"] - clips["pad"])
                                          .abs().max() / scale).item(),
            "source_features_rel_l2": ((fea["ring_pad"] - fea["pad"]).norm()
                                       / fea["pad"].norm()).item()}
        del clips, fea
        torch.cuda.empty_cache()
    return {"ring_clip": out}


def native_render(line: str) -> dict:
    """One pose clip's host rendering: POSE_RENDER_FRAMES OpenPose frames
    of `[pose_data]`'s dancing figure (video 10's placement, at the
    fixtures' 288x512) through the native `draw_edge` and through its
    numpy tier (TSNET_NATIVE=0): the share of pixels that agree. The two
    differ where a fit lands on an integer: numpy's float fit truncates a
    hair below it, the native fit does not (the
    JAX package's tests/test_native.py bounds that at 0.9999 on a real
    OpenPose frame; this figure's hips and shoulders lie on whole rows,
    so it is held at 0.999)."""
    w, h, v = 288, 512, 10
    sources = [json.dumps({"people": [dance_person(
        w / 2 + 8 * np.sin(0.2 * f + v), h / 2 + 4, 0.18 * h, 0.5 * f + v)]})
        for f in range(POSE_RENDER_FRAMES)]

    def render():
        return [render_openpose(src, (w, h))[0] for src in sources]

    native = render()
    old = os.environ.get("TSNET_NATIVE")
    os.environ["TSNET_NATIVE"] = "0"
    try:
        numpy_imgs = render()
    finally:
        os.environ.pop("TSNET_NATIVE")
        if old is not None:
            os.environ["TSNET_NATIVE"] = old
    differ = [(a != b).any(-1) for a, b in zip(native, numpy_imgs)]
    res = {"frames": POSE_RENDER_FRAMES,
           "pixel_agreement": 1.0 - float(np.mean(differ)),
           "pixels_differing": int(sum(d.sum() for d in differ)),
           "drawn_pixels": int(sum((a != 0).any(-1).sum() for a in native))}
    print(f"[{REWRITES}] native vs numpy draw_edge, one pose clip's host "
          f"rendering: {json.dumps(res)}", flush=True)
    check(res["pixel_agreement"] >= 0.999 and res["drawn_pixels"] > 0,
          f"{REWRITES}: native rendering vs numpy {res}")
    return res


def rewrites_phase(line: str) -> dict:
    """`[rewrites]`: the JAX package's layout rewrites as the port runs
    them: the phase-decomposed decoder against the plain `Decoder` in each
    clip tier and in the train step, `ring_pad` on against off,
    `encoder_apply_fast` against `lbl_enc`, the native rasterizer against
    its numpy tier."""
    report = {tier: decoder_forms(line, tier) for tier in REWRITE_TIERS}
    report["train"] = train_forms(line)
    report["native"] = native_render(line)
    return report


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
    if sys.argv[1:] == ["--high"]:
        high_phase(line)
        return 0

    t0 = time.perf_counter()
    per_source = cuda_build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s wall, per source "
          f"{json.dumps(per_source)}", flush=True)
    root = os.path.dirname(os.path.abspath(__file__))
    if sys.argv[1:] == ["--parallel"]:
        kernel_checks(line)
        train_kernel_checks(line)
        parallel_phase(line, root)
        torch.cuda.empty_cache()
        sweep_phase(line)
        torch.cuda.empty_cache()
        zoo_phase(line)
        return 0
    if sys.argv[1:] == ["--rewrites"]:
        rewrites_phase(line)
        return 0
    if sys.argv[1:] == ["--norms"]:
        norm_phase(line)
        return 0
    if sys.argv[1:] == ["--pose-first-step"]:
        return pose_first_step_forms(line)
    if sys.argv[1:] == ["--determinism"]:
        determinism_phase(line, diagnose=True)
        return 0
    if sys.argv[1:] == ["--pose"]:
        pose_phase(line)
        torch.cuda.empty_cache()
        pose_data_phase(line)
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
    print(f"[bits] fuse_pair_conv2 sha256: (2, 3, 12, 64 -> 72, seed 20) "
          f"{k6_bits(2, 3, 12, 64, 72, 20)}; (3, 8, 32, 1024 -> 1024, seed "
          f"21) {k6_bits(3, 8, 32, 1024, 1024, 21)}", flush=True)

    kernels = kernel_checks(line)
    train_kernels = train_kernel_checks(line)
    high = high_phase(line)
    torch.cuda.empty_cache()
    report = main_path()
    report[HIGH] = high
    report["train"], state = train_phase(line)
    report["serve"] = serve_phase(line, state)
    del state
    torch.cuda.empty_cache()
    report[DETERMINISM] = determinism_phase(line)
    torch.cuda.empty_cache()
    report["pose"] = pose_phase(line)
    torch.cuda.empty_cache()
    report["pose_data"] = pose_data_phase(line)
    torch.cuda.empty_cache()
    report[PARALLEL] = parallel_phase(line, root)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_loop_",
                                     dir=root) as tmp:
        report["loop"] = loop_phase(line, tmp)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_demo_",
                                         dir=root) as demo_root:
            report["demo"] = demo_phase(
                line, demo_root, os.path.join(tmp, "run", "snapshots"))
            report["tools"] = tools_phase(
                line, os.path.join(tmp, "run", "history.csv"), demo_root)
    torch.cuda.empty_cache()
    flow = flow_phase(line)
    norm, norm_g4 = norm_phase(line)
    standalone = {"masked_attention_flow_fused": flow,
                  "instance_norm_fused": norm}
    report[STANDALONE] = {"launches": {n: k.pop("launches")
                                       for n, k in standalone.items()}}
    torch.cuda.empty_cache()
    report[SWEEP] = sweep_phase(line)
    report["zoo"] = zoo_phase(line)
    torch.cuda.empty_cache()
    report[REWRITES] = rewrites_phase(line)

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
            "plain_ms": k["plain_ms"],
            "pose_launches": report["pose"]["launches"].get(launch, 0),
            "pose_data_launches": report["pose_data"]["launches"].get(
                launch, 0),
            "parallel_launches": report[PARALLEL]["launches"].get(launch, 0),
            "sweep_launches": report[SWEEP]["launches"].get(launch, 0)}
        if name == "transform_warp_pairs_mean":
            # K1 at the sweep's shapes (S=5: the JAX package's K1b)
            row[SWEEP] = {key: {k: at[k] for k in (
                "max_abs_err", "ms", "plain_ms")}
                for key, at in report[SWEEP]["kernels"].items()}
        if name in pose_rows:
            at = report["pose"]["kernels"][pose_rows[name]]
            row["pose"] = {key: at[key] for key in (
                "max_abs_err", "ms", "plain_ms")}
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
