"""Face reenactment demo with the port (counterpart of the JAX package's
`cli/demo_face.py`, with the same flags, defaults and seed rules).

Runs TS-Net over a subject clip and a driving clip, writing one
source|driving|reconstruction montage PNG a frame and a GIF of them. The
whole driving clip runs as chunked inference with the sources encoded
once (`infer.ClipInference`). Runs on the GPU.

    python -m wacv23_tsnet_tpu_torch.cli.demo_face \\
        --data-root demo/face_examples \\
        --subject val024 --driving test114 \\
        --restore-from ckpt.msgpack --out-dir demo_face_out

`--data-root/{images,labels}/<clip>/` hold the PNG frames and the
68-landmark files of each clip. `load_params` also gives `cli.serve` its
weights.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random
import time

import numpy as np

from ..compat import load_flax_params, load_reference_checkpoint
from ..configs import TSNetConfig, face_config
from ..data.datasets import IMG_MEAN, FaceDatasetTest
from ..data.image_io import write_png
from ..infer import ClipInference, montage_row, save_gif, to_display_rgb
from ..models import TSNetModules
from ..train.checkpoint import restore_generator_params


def load_params(path: str, cfg, device="cuda", seed: int = 0
                ) -> TSNetModules:
    """Generator modules of `cfg` on `device`, with the weights of `path`:
    a reference `.pth`, a flax msgpack generator file, or a full trainer
    snapshot (its `gen_params`). With no file, a random init from `seed`.
    Raises where `device` is CUDA and there is none."""
    mods = TSNetModules(cfg, device=device, seed=seed)
    if path and os.path.isfile(path):
        if path.endswith(".pth"):
            params, example = load_reference_checkpoint(path, cfg)
            load_flax_params(mods, params)
            print(f"=> loaded reference checkpoint {path} (example {example})")
            return mods
        restore_generator_params(path, mods)
        print(f"=> loaded checkpoint {path}")
        return mods
    print("=> no checkpoint found, using random init (demo smoke mode)")
    return mods


def main(argv=None, base_config: TSNetConfig | None = None, device="cuda"):
    """Parse `argv` and run the demo. `base_config` (default
    `face_config()`) is the model the flags are applied to, and `device`
    where it runs: the command line always takes the face model on the
    GPU. Returns a dict: `rec` (F, 3, H, W) the renormalized model-space
    reconstructions, `ref_idx`, `names` (the montage files), `gif`,
    `frames_per_s`, `montage_s` and `gif_s`."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-root", default="demo/face_examples")
    p.add_argument("--subject", default="val024")
    p.add_argument("--driving", default="test114")
    p.add_argument("--restore-from", default="")
    p.add_argument("--out-dir", default="demo_face_out")
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
    cfg = dataclasses.replace(base_config or face_config(),
                              precision=args.precision,
                              fast_tail=args.fast_tail,
                              fast_trunk=args.fast_trunk)
    mods = load_params(args.restore_from, cfg, device=device)

    dataset = FaceDatasetTest(
        sub_images_path=os.path.join(args.data_root, "images", args.subject),
        sub_labels_path=os.path.join(args.data_root, "labels", args.subject),
        dri_images_path=os.path.join(args.data_root, "images", args.driving),
        dri_labels_path=os.path.join(args.data_root, "labels", args.driving),
        img_size=(cfg.image_size, cfg.image_size),
        max_frame_num=args.max_frames,
    )
    sample = dataset[0]
    src, tar = sample["src"], sample["tar"]
    n_src_frames = src["img"].shape[0]
    ref_idx = random.sample(range(n_src_frames), args.n_source)
    print(f"reference frames: {ref_idx}")

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
        src_disp = (to_display_rgb(src["img"][i] / 255.0, IMG_MEAN)
                    if i < n_src_frames else
                    np.zeros_like(to_display_rgb(rec[0], IMG_MEAN)))
        row = montage_row([
            src_disp,
            to_display_rgb(tar["img"][i] / 255.0, IMG_MEAN),
            to_display_rgb(rec[i], IMG_MEAN),
        ])
        names.append(f"{i:06d}_{args.subject}_{tar['names'][i]}")
        write_png(os.path.join(args.out_dir, names[-1]), row)
        frames.append(row)
    montage_s = time.time() - t0
    t0 = time.time()
    gif = os.path.join(args.out_dir, f"{args.subject}_{args.driving}.gif")
    save_gif(gif, frames)
    gif_s = time.time() - t0
    print(f"wrote {n_frames} montages ({montage_s:.3f}s) + GIF "
          f"({gif_s * 1e3:.1f} ms) to {args.out_dir}")
    return {"rec": rec, "ref_idx": ref_idx, "names": names, "gif": gif,
            "frames_per_s": n_frames / dt, "montage_s": montage_s,
            "gif_s": gif_s}


if __name__ == "__main__":
    main()
