"""Model configuration of the PyTorch port of TS-Net.

An own copy of `TSNetConfig`, `face_config` and `toy_config` from the JAX
package's `configs/base.py` (the port imports nothing of that package).
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
Training-only knobs (`bwd_precision`, `remat`, `ring_pad`) are carried so
that configs round-trip, but the inference port does not implement them:
`ring_pad=True` is refused where the model is built.
"""

from __future__ import annotations

import dataclasses
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


def face_config() -> TSNetConfig:
    """The shipped FaceForensics config: 256², label_nc=2, 3 sources."""
    return TSNetConfig(task="face", label_nc=2, use_align_loss=True)


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
