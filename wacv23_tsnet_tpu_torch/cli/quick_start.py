"""Quick-start smoke: GAN train steps on random tensors (counterpart of
the JAX package's `cli/quick_start.py`).

The reference README's toy example (quick_start1.py): builds the face
model, stages random sources and targets, and runs full
`optimize_parameters()` steps. `--toy` takes a small fast config. Runs on
the GPU.

    python -m wacv23_tsnet_tpu_torch.cli.quick_start
"""

from __future__ import annotations

import argparse

import numpy as np

from ..configs import TSNetConfig, toy_config
from ..models.api import TSNet


def main(argv=None, device="cuda") -> TSNet:
    """Parse `argv` and train; `device` is where (the command line always
    takes the GPU). Returns the trained `TSNet`."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--toy", action="store_true",
                   help="64x64 thin config instead of the shipped 256x256")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--steps", type=int, default=1)
    args = p.parse_args(argv)

    cfg = toy_config() if args.toy else TSNetConfig(
        task="face", label_nc=2, dec_n_blocks=0, n_downsampling=3)
    bs, size = args.batch_size, cfg.image_size
    rng = np.random.default_rng(0)

    srcs = [rng.random((bs, 3, size, size), dtype=np.float32) * 255
            for _ in range(cfg.n_source)]
    lbls = [rng.integers(0, 2, (bs, cfg.label_nc, size, size))
            .astype(np.float32) for _ in range(cfg.n_source)]
    boxes = [rng.integers(0, 2, (bs, size, size)).astype(np.float32)
             for _ in range(cfg.n_source)]
    tar_img = rng.random((bs, 3, size, size), dtype=np.float32) * 255
    tar_lbl = rng.integers(0, 2, (bs, cfg.label_nc, size, size)) \
        .astype(np.float32)
    tar_bbox = rng.integers(0, 2, (bs, size, size)).astype(np.float32)

    model = TSNet(cfg, is_train=True, device=device)
    model.setup(0, bs, 100, 10000, 1.0)
    model.set_train_input(srcs, lbls, boxes, tar_img, tar_lbl, tar_bbox)
    for step in range(args.steps):
        model.optimize_parameters()
        print(f"step {step}:",
              {k: round(v, 4) for k, v in model.get_current_losses().items()})
    print("quick start OK")
    return model


if __name__ == "__main__":
    main()
