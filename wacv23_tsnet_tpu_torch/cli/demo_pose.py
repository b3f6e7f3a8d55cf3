"""Dance retargeting demo with the port (counterpart of the JAX package's
`cli/demo_pose.py`, with the same flags, defaults and seed rules).

Runs the pose variant of TS-Net on a subject/driving pair of dance
videos: the driving keypoints pre-smoothed (`cli.smooth_keypoints`) and,
for a pair of different builds, retargeted onto the subject's
(`data.posenorm`); writes one source|driving label|driving|
reconstruction montage PNG a frame and a GIF of them. The whole driving
clip runs as chunked inference with the sources encoded once
(`infer.ClipInference`). Runs on the GPU.

    python -m wacv23_tsnet_tpu_torch.cli.demo_pose \\
        --data-root demo/dance_example --json-root dataset/json_pose \\
        --pair "110 164" --restore-from ckpt.msgpack

`--data-root/{images,labels}/<%05d id>/` hold each video's frames and
OpenPose JSONs; `--json-root` the video dicts (`clean_video_dict.json`,
`clean_unseen_video_dict.json`) and `smooth_openpose/`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random
import time

from ..configs import TSNetConfig, pose_config
from ..data.codecs import labels_to_image
from ..data.datasets import IMG_MEAN, PoseDatasetTest
from ..data.image_io import write_png
from ..infer import ClipInference, montage_row, save_gif, to_display_rgb
from .demo_face import load_params


def main(argv=None, base_config: TSNetConfig | None = None, device="cuda"):
    """Parse `argv` and run the demo. `base_config` (default
    `pose_config()`) is the model the flags are applied to, and `device`
    where it runs: the command line always takes the pose model on the
    GPU. Returns a dict: `rec` (F, 3, H, W) the renormalized model-space
    reconstructions, `ref_idx`, `diff_sex`, `names` (the montage files),
    `gif`, `frames_per_s`, `montage_s` and `gif_s`."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-root", default="demo/dance_example")
    p.add_argument("--json-root", default="dataset/json_pose")
    p.add_argument("--pair", default="110 164")
    p.add_argument("--restore-from", default="")
    p.add_argument("--out-dir", default="demo_pose_out")
    p.add_argument("--n-source", type=int, default=3)
    p.add_argument("--max-frames", type=int, default=30)
    p.add_argument("--chunk", type=int, default=32)
    p.add_argument("--precision", default="high",
                   choices=["highest", "high", "default"],
                   help="conv precision (high = three bf16 passes)")
    p.add_argument("--fast-trunk", action="store_true",
                   help="encoders in one bf16 pass")
    p.add_argument("--fast-tail", action="store_true",
                   help="bf16 fuse+decoder tail (extra speed, small drift)")
    p.add_argument("--seed", type=int, default=1234)
    args = p.parse_args(argv)

    random.seed(args.seed)
    cfg = dataclasses.replace(base_config or pose_config(),
                              precision=args.precision,
                              fast_tail=args.fast_tail,
                              fast_trunk=args.fast_trunk)
    mods = load_params(args.restore_from, cfg, device=device)

    dataset = PoseDatasetTest(
        test_pairs=[args.pair],
        sub_json_path=os.path.join(args.json_root, "clean_video_dict.json"),
        msk_json_path=os.path.join(args.json_root,
                                   "clean_unseen_video_dict.json"),
        label_path=os.path.join(args.data_root, "labels"),
        smooth_label_path=os.path.join(args.json_root, "smooth_openpose"),
        image_path=os.path.join(args.data_root, "images"),
        n_frame_total=args.max_frames,
    )
    sample = dataset[0]
    src, tar = sample["src"], sample["tar"]
    print(f"gender pair: '{sample['diff_sex'] or 'same'}'")
    ref_idx = random.sample(range(src["img"].shape[0]), args.n_source)

    engine = ClipInference(cfg, mods, chunk=args.chunk, device=device)
    t0 = time.time()
    rec = engine.run_renormalized(
        src["img"][ref_idx], src["lbl"][ref_idx], src["bbox"][ref_idx],
        tar["lbl"], tar["bbox"])
    n_frames = rec.shape[0]
    dt = time.time() - t0
    print(f"The total test time is {dt:.3f}s "
          f"({n_frames / dt:.2f} frames/sec)")

    t0 = time.time()
    os.makedirs(args.out_dir, exist_ok=True)
    frames, names = [], []
    for i in range(n_frames):
        row = montage_row([
            to_display_rgb(src["img"][min(i, src["img"].shape[0] - 1)]
                           / 255.0, IMG_MEAN),
            labels_to_image(tar["lbl"][i], "pose"),
            to_display_rgb(tar["img"][i] / 255.0, IMG_MEAN),
            to_display_rgb(rec[i], IMG_MEAN),
        ])
        names.append(f"{i:06d}_{tar['names'][i]}.png")
        write_png(os.path.join(args.out_dir, names[-1]), row)
        frames.append(row)
    montage_s = time.time() - t0
    t0 = time.time()
    gif = os.path.join(args.out_dir, args.pair.replace(" ", "_") + ".gif")
    save_gif(gif, frames)
    gif_s = time.time() - t0
    print(f"wrote {n_frames} montages ({montage_s:.3f}s) + GIF "
          f"({gif_s * 1e3:.1f} ms) to {args.out_dir}")
    return {"rec": rec, "ref_idx": ref_idx, "diff_sex": sample["diff_sex"],
            "names": names, "gif": gif, "frames_per_s": n_frames / dt,
            "montage_s": montage_s, "gif_s": gif_s}


if __name__ == "__main__":
    main()
