"""Model configuration of the PyTorch port of TS-Net.

An own copy of `TSNetConfig`, `face_config`, `pose_config`, `toy_config`
and `toy_pose_config` from the JAX package's `configs/base.py` (the port
imports nothing of that package).
Field names, defaults and meanings are the same, so one config describes
one model in both packages.

Precision tiers on the GPU (see `nn.blocks.conv2d`):

- `precision="highest"`: fp32 convolutions with TF32 off in cuDNN and
  cuBLAS (torch's cuDNN default is TF32, which keeps ~3 decimal digits).
- `precision="high"`: fp32 convolutions with TF32 on. In the JAX bench
  tier "high" reaches no convolution (`fast_trunk` and `fast_tail` send
  trunk and tail to "default"); the port still maps it to TF32.
- `fast_trunk`: the encoders' convolutions take one bf16 pass (input and
  kernel in bf16, output back to fp32, bias added in fp32).
- `fast_tail`: FuseNet and the decoder run in bf16 with fp32
  instance-norm statistics; the transformation branch writes bf16.

The similarity logits, softmax and flow run in fp32 in every tier.

Training knobs: `bwd_precision` sets the tier of the two backward convs
of every conv (`ops.dpconv.conv2d_dp`), and `remat=True` recomputes the
encoders', the decoder's and the discriminator's activations in the
backward pass (`TSNetModules.run`). `ring_pad` (a TPU layout rewrite)
is refused where the model is built. The pose variant's `use_face_d`
adds the face-crop discriminator netDF to training and `use_fg_mask`
paints the background columns with the mean colour
(`models.tsnet.composite_foreground`).

`TrainConfig` is the optimisation schedule of the JAX package's
`configs/base.py`, field for field.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TSNetConfig:
    """Architecture + numerics configuration of one TS-Net model."""

    task: str = "face"
    label_nc: int = 2
    image_size: int = 256
    n_source: int = 3

    ngf: int = 64
    n_downsampling: int = 3
    enc_n_blocks: int = 9
    dec_n_blocks: int = 4
    addcoords: bool = True

    softmax_temp: float = 100.0

    use_face_d: bool = False
    use_fg_mask: bool = False
    use_align_loss: bool = True

    lambda_fml: float = 10.0
    lambda_vgg: float = 10.0
    lambda_grad: float = 10.0
    lambda_con: float = 10.0

    ndf: int = 64
    d_n_layers: int = 3

    compute_dtype: str = "float32"
    precision: str = "highest"
    fast_tail: bool = False
    fast_trunk: bool = False
    ring_pad: bool = False
    bwd_precision: Optional[str] = None
    remat: bool = False
    img_mean: Tuple[float, float, float] = (
        101.84807705937696, 112.10832843463207, 111.65973036298041,
    )

    @property
    def feat_ch(self) -> int:
        """Channel width of the encoder output (512 at the face config)."""
        return self.ngf * (2 ** self.n_downsampling)

    @property
    def feat_size(self) -> int:
        """Spatial side of the encoder output (32 at the face config)."""
        return self.image_size // (2 ** self.n_downsampling)

    def img_mean_array(self) -> np.ndarray:
        return np.asarray(self.img_mean, dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimisation schedule: poly LR decay per example after
    `initial_iter` examples (reference model/TSNet.py:504-512)."""

    batch_size: int = 15
    lr: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    lambda_dec: float = 1.0     # decoder LR multiplier
    d_lr_factor: float = 0.5    # discriminator LR = 0.5 * lr
    power: float = 1.0
    initial_epoch: int = 400
    max_epoch: int = 900
    n_frame_total: int = 10
    n_source: int = 3           # first n_source frames of each clip
    num_videos: int = 150
    frame_interval: int = 1
    seed: int = 1234
    print_freq: int = 100
    save_img_freq: int = 100
    snapshot_dir: str = "snapshots"
    imgshot_dir: str = "imgshots"

    @property
    def num_examples_per_epoch(self) -> int:
        return self.num_videos * (self.n_frame_total - self.n_source)

    @property
    def initial_iter(self) -> int:
        return self.num_examples_per_epoch * self.initial_epoch

    @property
    def max_iter(self) -> int:
        steps_per_epoch = math.ceil(self.num_examples_per_epoch
                                    / float(self.batch_size))
        return max(self.num_examples_per_epoch * self.max_epoch + 1,
                   steps_per_epoch * self.batch_size * self.max_epoch + 1)


def face_config() -> TSNetConfig:
    """The shipped FaceForensics config: 256², label_nc=2, 3 sources."""
    return TSNetConfig(task="face", label_nc=2, use_align_loss=True)


def pose_config() -> TSNetConfig:
    """The shipped Youtube-dance config: 256², 25 label classes, the
    face-crop discriminator, fixed foreground compositing, no align
    loss."""
    return TSNetConfig(
        task="pose",
        label_nc=25,
        use_face_d=True,
        use_fg_mask=True,
        use_align_loss=False,
    )


def toy_config() -> TSNetConfig:
    """Tiny config for fast unit tests (64², thin trunk)."""
    return TSNetConfig(
        task="face",
        label_nc=2,
        image_size=64,
        ngf=8,
        n_downsampling=2,
        enc_n_blocks=2,
        dec_n_blocks=1,
        n_source=2,
    )


def toy_pose_config() -> TSNetConfig:
    """Tiny pose config for fast unit tests: `toy_config`'s trunk with the
    pose switches on. label_nc=8 is the smallest width with the head
    channels 1..4 and the face channel -1 that `get_face_bbox` reads;
    d_n_layers=2 because a 3-layer PatchGAN on the toy's 16² face crops
    reaches zero-variance instance norms."""
    return TSNetConfig(
        task="pose",
        label_nc=8,
        d_n_layers=2,
        image_size=64,
        ngf=8,
        n_downsampling=2,
        enc_n_blocks=2,
        dec_n_blocks=1,
        n_source=2,
        use_face_d=True,
        use_fg_mask=True,
        use_align_loss=False,
    )
