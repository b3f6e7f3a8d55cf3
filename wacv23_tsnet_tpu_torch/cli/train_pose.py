"""Train the pose variant of TS-Net on Youtube-dance-style data with the
port (counterpart of the JAX package's `cli/train_pose.py`, with the same
flags and defaults): 25 label classes (19 with both `--basic-point-only`
and `--remove-face-labels`), the face-crop discriminator, foreground
compositing, frames 4 apart, batch 10.

    python -m wacv23_tsnet_tpu_torch.cli.train_pose \\
        --json-path video_dict.json --label-path openpose/ \\
        --image-path frames/ --root-dir runs/pose

`--json-path` is the video dict ({video id: [frame files]}),
`--label-path/<%05d id>/` the OpenPose JSON of each frame
(`<frame stem>_keypoints.json`), `--image-path/<%05d id>/` the JPEG (or
PNG) frames. The fast train tier is `--fast-tail --precision high
--bwd-precision default`. Resume with `--restore-from <snapshot>
--set-start`. Runs on the GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import random
import sys

import numpy as np

from ..configs import TrainConfig, TSNetConfig, pose_config
from ..data.datasets import PoseDatasetTrain
from ..data.loader import Loader
from ..models.api import TSNet
from ..train.checkpoint import restore_checkpoint
from ..train.loop import run_training
from ..utils import Logger, StepTimer


def main(argv=None, base_config: TSNetConfig | None = None, device="cuda"):
    """Parse `argv` and train. `base_config` (default `pose_config()`)
    is the model the flags are applied to, and `device` where it trains:
    the command line always takes the pose model on the GPU. Returns the
    trained `TSNet` and the loop's `StepTimer`."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--json-path", required=True)
    p.add_argument("--label-path", required=True)
    p.add_argument("--image-path", required=True)
    p.add_argument("--root-dir", default="runs/pose")
    p.add_argument("--batch-size", type=int, default=10)
    p.add_argument("--learning-rate", type=float, default=2e-4)
    p.add_argument("--n-source", type=int, default=3)
    p.add_argument("--n-frame-total", type=int, default=10)
    p.add_argument("--n-blocks", type=int, default=4)
    p.add_argument("--n-downsampling", type=int, default=3)
    p.add_argument("--interval", type=int, default=4)
    p.add_argument("--initial-epoch", type=int, default=400)
    p.add_argument("--max-epoch", type=int, default=900)
    p.add_argument("--num-videos", type=int, default=100)
    p.add_argument("--lambda-dec", type=float, default=1.0)
    p.add_argument("--basic-point-only", action="store_true")
    p.add_argument("--remove-face-labels", action="store_true")
    p.add_argument("--no-jitter", action="store_true")
    p.add_argument("--no-mirror", action="store_true")
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--precision", default="highest",
                   choices=["highest", "high", "default"],
                   help="conv precision (highest = fp32, TF32 off)")
    p.add_argument("--bwd-precision", default=None,
                   choices=["highest", "high", "default"],
                   help="precision of the backward convs only (default: "
                        "as --precision; 'default' = one bf16 pass, see "
                        "ops/dpconv.py)")
    p.add_argument("--fast-tail", action="store_true",
                   help="run the decoder + FuseNet in bf16; encoders, "
                        "similarity branch, warp supervision and losses "
                        "stay f32 (see configs/base.py)")
    p.add_argument("--random-seed", type=int, default=1234)
    p.add_argument("--restore-from", default="")
    p.add_argument("--set-start", action="store_true")
    p.add_argument("--start-step", type=int, default=0)
    p.add_argument("--final-step", type=int, default=None)
    p.add_argument("--print-freq", type=int, default=100)
    p.add_argument("--save-pred-every", type=int, default=None)
    args = p.parse_args(argv)

    random.seed(args.random_seed)
    np.random.seed(args.random_seed)

    label_nc = (19 if (args.basic_point_only and args.remove_face_labels)
                else 25)
    cfg = dataclasses.replace(base_config or pose_config(),
                              n_source=args.n_source,
                              dec_n_blocks=args.n_blocks,
                              n_downsampling=args.n_downsampling,
                              label_nc=label_nc, precision=args.precision,
                              bwd_precision=args.bwd_precision,
                              fast_tail=args.fast_tail)
    tcfg = TrainConfig(batch_size=args.batch_size, lr=args.learning_rate,
                       lambda_dec=args.lambda_dec,
                       initial_epoch=args.initial_epoch,
                       max_epoch=args.max_epoch,
                       n_frame_total=args.n_frame_total,
                       n_source=args.n_source,
                       num_videos=args.num_videos,
                       frame_interval=args.interval,
                       seed=args.random_seed,
                       print_freq=args.print_freq)

    snapshot_dir = os.path.join(args.root_dir, "snapshots")
    os.makedirs(snapshot_dir, exist_ok=True)
    stdout = sys.stdout
    log = Logger(os.path.join(
        snapshot_dir, f"B{args.batch_size:04d}E{args.max_epoch:04d}.log"),
        stream=stdout)
    sys.stdout = log
    try:
        steps_per_epoch = math.ceil(tcfg.num_examples_per_epoch
                                    / float(args.batch_size))
        final_step = args.final_step or steps_per_epoch * args.max_epoch
        save_every = args.save_pred_every or max(
            1, steps_per_epoch * (args.max_epoch // 10))

        dataset = PoseDatasetTrain(
            json_path=args.json_path, label_path=args.label_path,
            image_path=args.image_path, mean=cfg.img_mean_array(),
            n_frame_total=args.n_frame_total,
            is_jitter=not args.no_jitter, is_mirror=not args.no_mirror,
            basic_point_only=args.basic_point_only,
            remove_face_labels=args.remove_face_labels,
            interval=args.interval, rng=random.Random(args.random_seed))
        with Loader(dataset, batch_size=args.batch_size, shuffle=True,
                    num_workers=args.num_workers,
                    seed=args.random_seed) as loader:
            loader.start()   # the workers start while the model is built
            model = TSNet(cfg, lr=args.learning_rate, is_train=True,
                          lambda_dec=args.lambda_dec, seed=args.random_seed,
                          device=device)
            start_step = args.start_step
            if args.restore_from and os.path.isfile(args.restore_from):
                restore_checkpoint(args.restore_from, model.state)
                if args.set_start:
                    start_step = model.state.step
                print(f"=> restored {args.restore_from} at step "
                      f"{start_step}")
            timer = StepTimer()
            run_training(model, loader, cfg, tcfg, final_step=final_step,
                         start_step=start_step, snapshot_dir=snapshot_dir,
                         imgshot_dir=os.path.join(args.root_dir, "imgshots"),
                         save_every=save_every, n_source=args.n_source,
                         history_path=os.path.join(args.root_dir,
                                                   "history.csv"),
                         timer=timer)
    finally:
        sys.stdout = stdout
        log.close()
    return model, timer


if __name__ == "__main__":
    main()
