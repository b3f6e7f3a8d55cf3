"""Evaluate training snapshots: reconstruction metrics over checkpoints
(counterpart of the JAX package's `cli/eval_snapshots.py`).

For every `*.msgpack` snapshot of `--snapshot-dir` (what `cli.train_face`
or `cli.train_pose` writes) it runs whole-clip self-reconstruction
(sources: the first `n_source` frames of the subject clip; driving
labels: the remaining frames; ground truth: those frames) and reports
L1 / PSNR / SSIM in display space to `eval_metrics.csv`, with one
source|target|reconstruction montage a snapshot. `--task pose` reads one
dance video (`--data-root/{images,labels}/<--subject>/`, JPEG frames and
OpenPose JSONs) through the pose test set's subject pipeline
(`load_pose_self_clip`). Runs on the GPU.

    python -m wacv23_tsnet_tpu_torch.cli.eval_snapshots \\
        --snapshot-dir runs/face/snapshots --out-dir eval_out
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import re
import time

import numpy as np
import torch

from ..configs import TSNetConfig, face_config, pose_config
from ..data.datasets import (FaceDatasetTest, _person_crop_coords,
                             _pose_arrays, _pose_frame)
from ..data.image_io import read_rgb, write_png
from ..data.rasterize import render_openpose
from ..device import resolve_device
from ..infer.metrics import l1, psnr, ssim
from ..infer.pipeline import ClipInference, montage_row, to_display_rgb
from ..models import TSNetModules
from ..train.checkpoint import restore_generator_params


def display_clip(imgs_chw: np.ndarray, mean) -> np.ndarray:
    """(F, 3, H, W) model space -> (F, H, W, 3) float RGB in [0, 1]."""
    out = np.stack([to_display_rgb(f, mean) for f in imgs_chw])
    return out.astype(np.float32) / 255.0


def load_pose_self_clip(data_root: str, vdir: str, max_frames: int, mean):
    """One dance video as a deterministic self-reconstruction clip: the
    pose test set's subject pipeline (test-time labels, the person crop
    of frame 0, 128x256 resize and square pad) on its first `max_frames`
    frames. Returns (imgs (F, 3, H, W) BGR minus the mean, class maps
    (F, H, W) int32, bboxes (F, H, W) uint8)."""
    images = os.path.join(data_root, "images", vdir)
    labels = os.path.join(data_root, "labels", vdir)
    parts = ([], [], [])
    coords = None
    for frame in sorted(os.listdir(images))[:max_frames]:
        img = read_rgb(os.path.join(images, frame))
        size = img.shape[1::-1]
        lbl, pose_pts, _ = render_openpose(
            os.path.join(labels, frame[:-4] + "_keypoints.json"), size,
            train=False)
        if coords is None:
            coords, _ = _person_crop_coords(pose_pts, size, train=False,
                                            rng=None)
        xs, ys, xe, ye = coords
        for acc, v in zip(parts, _pose_frame(img, lbl[ys:ye, xs:xe],
                                             coords)):
            acc.append(v)
    clip = _pose_arrays(*parts, mean, False, False)
    return clip["img"], clip["lbl"].astype(np.int32), clip["bbox"]


def main(argv=None, base_config: TSNetConfig | None = None, device="cuda"):
    """Parse `argv` and evaluate. `base_config` (default `face_config()`,
    or `pose_config()` with `--task pose`) is the model the flags are
    applied to, and `device` where it runs: the command line always
    takes the shipped models on the GPU. Returns one dict a snapshot:
    step, l1, psnr, ssim, and the seconds its restore (`restore_s`) and
    its inference and metrics (`infer_s`) took."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--snapshot-dir", required=True)
    p.add_argument("--task", default="face", choices=["face", "pose"])
    p.add_argument("--data-root", default=None)
    p.add_argument("--subject", default=None)
    p.add_argument("--n-source", type=int, default=3)
    p.add_argument("--max-frames", type=int, default=24)
    p.add_argument("--out-dir", default="eval_out")
    p.add_argument("--precision", default="high",
                   choices=["highest", "high", "default"])
    args = p.parse_args(argv)
    device = resolve_device(device)

    os.makedirs(args.out_dir, exist_ok=True)
    default = face_config if args.task == "face" else pose_config
    cfg = dataclasses.replace(base_config or default(),
                              precision=args.precision)
    mean = cfg.img_mean_array()

    s = args.n_source
    if args.task == "face":
        data_root = args.data_root or "demo/face_examples"
        subject = args.subject or "val024"
        images = os.path.join(data_root, "images", subject)
        labels = os.path.join(data_root, "labels", subject)
        clip = FaceDatasetTest(images, labels, images, labels,
                               img_size=(cfg.image_size, cfg.image_size),
                               max_frame_num=args.max_frames)[0]
        src, tar = clip["src"], clip["tar"]
        src_imgs, src_lbls, src_boxes = (src["img"][:s], src["lbl"][:s],
                                         src["bbox"][:s])
        # held-out driving frames: everything after the sources
        tar_imgs, tar_lbls, tar_boxes = (tar["img"][s:], tar["lbl"][s:],
                                         tar["bbox"][s:])
    else:
        imgs, lbls, boxes = load_pose_self_clip(
            args.data_root or "demo/dance_example", args.subject or "00110",
            args.max_frames, mean)
        src_imgs, src_lbls, src_boxes = imgs[:s], lbls[:s], boxes[:s]
        tar_imgs, tar_lbls, tar_boxes = imgs[s:], lbls[s:], boxes[s:]

    snaps = sorted(glob.glob(os.path.join(args.snapshot_dir, "*.msgpack")))
    if not snaps:
        raise SystemExit(f"no snapshots under {args.snapshot_dir}")
    engine = ClipInference(cfg, TSNetModules(cfg, device=device),
                           device=device)
    gt = torch.as_tensor(display_clip(tar_imgs / 255.0, mean),
                         device=engine.device)
    csv_path = os.path.join(args.out_dir, "eval_metrics.csv")
    rows = []
    with open(csv_path, "w") as fh:
        fh.write("step,l1,psnr,ssim\n")
        for path in snaps:
            m = re.search(r"S(\d+)", os.path.basename(path))
            step = int(m.group(1)) if m else -1
            t0 = time.perf_counter()
            restore_generator_params(path, engine.mods)
            t1 = time.perf_counter()
            rec = engine.run(src_imgs, src_lbls, src_boxes, tar_lbls,
                             tar_boxes)
            rd = display_clip(rec, mean)
            rd_dev = torch.as_tensor(rd, device=engine.device)
            row = (step, float(l1(rd_dev, gt)), float(psnr(rd_dev, gt)),
                   float(ssim(rd_dev, gt)))
            t2 = time.perf_counter()
            fh.write(",".join(f"{v:.5f}" if i else str(v)
                              for i, v in enumerate(row)) + "\n")
            fh.flush()
            print(f"step {row[0]:>7}: L1 {row[1]:.4f}  PSNR {row[2]:.2f}  "
                  f"SSIM {row[3]:.4f}  (restore {t1 - t0:.3f}s, "
                  f"inference {t2 - t1:.3f}s)", flush=True)
            write_png(os.path.join(args.out_dir, f"montage_S{step:06d}.png"),
                      montage_row([
                          to_display_rgb(src_imgs[0] / 255.0, mean),
                          to_display_rgb(tar_imgs[0] / 255.0, mean),
                          (rd[0] * 255).astype(np.uint8)]))
            rows.append(dict(zip(("step", "l1", "psnr", "ssim"), row),
                             restore_s=t1 - t0, infer_s=t2 - t1))
    print(f"wrote {csv_path}")
    return rows


if __name__ == "__main__":
    main()
