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
   K2 at (3, 32, 32, 32, 1024)), and times both with CUDA events.
4. Drives the main path at the full width of `face_config()` with seeded
   random weights, in both tiers (bit-parity; bench = "high" + fast_tail
   + fast_trunk): `tsnet_forward_clip` over a 64-frame clip and four
   32-frame `RetargetSession.push_labels` requests (one with
   output="display"). Launch counts are zeroed just before each tier's
   run and read just after; each tier must launch its kernels. The
   kernel path is compared with the same model run through the plain
   versions, and frames/s, stage times and a profile are printed; last,
   how far the bench tier (and the bf16 tail alone) moves the output
   from the bit-parity tier.
5. Prints one `kernels` JSON line, the card line again, and last
   `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from wacv23_tsnet_tpu_torch.configs import face_config
from wacv23_tsnet_tpu_torch.infer import RetargetSession
from wacv23_tsnet_tpu_torch.models import TSNetModules, tsnet_forward_clip
from wacv23_tsnet_tpu_torch.models.tsnet import encode_sources
from wacv23_tsnet_tpu_torch.nn import fuse_clip
from wacv23_tsnet_tpu_torch.ops import cuda_build
from wacv23_tsnet_tpu_torch.ops import norm_kernels as nk
from wacv23_tsnet_tpu_torch.ops import warp_kernels as wk
from wacv23_tsnet_tpu_torch.ops.coords import normalized_grid
from wacv23_tsnet_tpu_torch.ops.norms import l2_normalize
from wacv23_tsnet_tpu_torch.ops.resize import resize_nearest
from wacv23_tsnet_tpu_torch.ops.similarity import (
    transformation_warp_clip, transformation_warp_clip_mean)

# Published peaks of one H100 SXM (NVIDIA data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12      # CUDA cores, outside the tensor cores

# kernel-vs-plain tolerances on the card, elementwise |err| <= atol +
# rtol * |plain|. f32 out: both sides are fp32, but 512-term dot products
# summed in another order, times the temp-100 softmax, move the flow by
# ~1e-5 pixels and the warped features by that times their gradient;
# 1e-3 is the bit-parity tier's end-to-end bound. bf16 out: one bf16
# step (2^-8 relative) on top.
TOL = {"f32": (1e-3, 0.0), "bf16": (1e-3, 2.0 ** -8)}
IN_TOL = {"f32": (1e-4, 0.0), "bf16": (1e-4, 2.0 ** -8)}

CLIP_FRAMES = 64
CHUNK = 32


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
            plain=lambda: wk.transform_warp_pairs_plain(*args, h, w),
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

    results = {}
    for name, case in cases.items():
        got = case["kernel"]()
        torch.cuda.synchronize()
        res = compare(got, case["plain"](), case["tol"])
        check(res["worst_err_over_tol"] <= 1.0,
              f"{name} disagrees with its plain version: {res}")
        res["ms"] = time_ms(case["kernel"])
        res["plain_ms"] = time_ms(case["plain"], iters=3)
        by_bytes = case["bytes"] / HBM_BYTES_PER_S
        by_ops = case["flops"] / FP32_FLOP_PER_S
        res["bound_ms"] = 1e3 * max(by_bytes, by_ops)
        res["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
        res.update({k: case[k] for k in ("tier", "replaces", "source")
                    if k in case})
        results[name] = res
        print(f"[kernel] {name}: max_abs_err={res['max_abs_err']:.3e} "
              f"mean_abs_err={res['mean_abs_err']:.3e} "
              f"(atol, rtol)={case['tol']} kernel_ms={res['ms']:.4f} "
              f"plain_ms={res['plain_ms']:.4f} library_ms=none "
              f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}) | {line}",
              flush=True)
    torch.cuda.synchronize()
    return results


def device_breakdown(forward, tier: str, top: int = 12) -> dict:
    """Device time of one clip forward by kernel (torch.profiler/CUPTI),
    summed over kernels (one stream, so they do not overlap), its share of
    the same profiled forward's host-clock time, and the kernels that take
    the most."""
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in rows)
    for e in rows[:top]:
        print(f"[profile] {tier}: {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:110]}")
    return {"device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / wall_s}


def stage_ms(mods, src, tar_lbl, tar_bbox) -> dict:
    """CUDA-event ms of each stage of one clip forward, made stage by stage
    with the calls `tsnet_forward_clip` makes (models/tsnet.py)."""
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
        mods.dec(prop, syn).float()
        mark("decoder")
    torch.cuda.synchronize()
    return {name: marks[i - 1][1].elapsed_time(ev)
            for i, (name, ev) in enumerate(marks) if i}


def main_path(line: str) -> dict:
    """Full-width face clip inference and sessions, both tiers."""
    base = face_config()
    tiers = {
        "bit-parity": (base, "transform_warp_pairs_nf",
                       "transform_warp_pairs_mean"),
        "bench": (dataclasses.replace(base, precision="high",
                                      fast_tail=True, fast_trunk=True),
                  "transform_warp_pairs_mean", "transform_warp_pairs_nf"),
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
        forward()                                    # warm-up (cuDNN plans)
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

        check(tuple(out.shape) == (CLIP_FRAMES, hw, hw, 3), f"{tier}: shape")
        check(bool(torch.isfinite(out).all()), f"{tier}: non-finite output")
        check(launches[warp_kernel] > 0 and launches["instance_norm_mean"] > 0,
              f"{tier}: kernels not launched on the main path: {launches}")
        check(launches[other_kernel] == 0,
              f"{tier}: launched the other tier's kernel: {launches}")

        plain = tsnet_forward_clip(mods, *src, tar_lbl, tar_bbox,
                                   use_kernels=False)
        diff = (out - plain).abs()
        # the session chunks frames by 32: compare with the clip forward
        # over the same 32-frame chunks (cuDNN picks its algorithms, and
        # so its rounding, by batch size); the 64-frame batch is compared
        # too, as the batch-size drift of the tier
        chunked = torch.cat([tsnet_forward_clip(mods, *src,
                                                tar_lbl[lo:lo + CHUNK],
                                                tar_bbox[lo:lo + CHUNK])
                             for lo in (0, CHUNK)]).cpu().numpy()
        sess_diff = np.abs(np.concatenate(pushed[:2]) - chunked)
        batch_diff = np.abs(chunked - out.cpu().numpy())
        # the display session answered the same frames, at the same chunk
        # size, as the second model-output request
        want_u8 = np.clip(np.round(pushed[1] * 255.0 + base.img_mean_array()),
                          0, 255)
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
        check(all(p.shape == frame for p in pushed) and shown.shape == frame
              and shown.dtype == np.uint8, f"{tier}: session output shapes")
        check(np.isfinite(np.stack(pushed)).all(),
              f"{tier}: session non-finite")
        check(res["display_vs_model_max_levels"] <= 1.0,
              f"{tier}: display frames vs model-space frames")

        iters = 3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            forward()
        torch.cuda.synchronize()
        res["clip_ms"] = 1e3 * (time.perf_counter() - t0) / iters
        res["fps"] = CLIP_FRAMES / (res["clip_ms"] / 1e3)
        t0 = time.perf_counter()
        sess.push_labels(tar_lbl[:CHUNK], tar_bbox[:CHUNK])
        res["session_request_ms"] = 1e3 * (time.perf_counter() - t0)
        torch.cuda.reset_peak_memory_stats()
        forward()
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        res["stage_ms"] = stage_ms(mods, src, tar_lbl, tar_bbox)
        res.update(device_breakdown(forward, tier))
        report[tier] = res
        print(f"[perf] {tier}: " + json.dumps({k: res[k] for k in (
            "clip_ms", "fps", "session_request_ms", "peak_mem_gb",
            "stage_ms", "device_busy_ms", "device_busy_share")}),
              flush=True)
        print(f"[fps] {tier}: {res['fps']:.2f} frames/s "
              f"({CLIP_FRAMES}-frame clip, {res['clip_ms']:.2f} ms) on {line}",
              flush=True)
        outputs[tier] = out.cpu()
        features[tier] = encode_sources(mods, *src)["fea"].float().cpu()
        del mods, out, plain
        torch.cuda.empty_cache()
    # how far the bench tier's shortcuts move the output (random weights),
    # and how much of that is the bf16 tail alone (no fast_trunk)
    tail = TSNetModules(dataclasses.replace(base, precision="high",
                                            fast_tail=True), seed=0)
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
    report = main_path(line)

    rows = []
    for name, k in kernels.items():
        if k.get("tier") is None:
            continue
        rows.append({
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": report[k["tier"]]["launches"][
                "instance_norm_mean" if name.startswith("instance_norm")
                else name],
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
