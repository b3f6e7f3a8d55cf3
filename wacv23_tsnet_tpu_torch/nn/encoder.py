"""TS-Net encoder trunk (counterpart of the JAX package's `nn/encoder.py`).

CoordConv channels (optional), a 7x7 reflect-pad conv to ngf channels,
`n_downsampling` stride-2 3x3 convs (zero pad 1) doubling the channels,
each followed by IN + ReLU, then `n_blocks` ResNet blocks. This is the
plain module path, not the TPU's folded-stem rewrite.

Used twice in TS-Net: the image encoder (3 + label_nc input channels,
9 blocks) and the label encoder (label_nc input channels, no blocks).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.coords import coord_channels
from ..ops.norms import instance_norm
from .blocks import Conv2d, ResnetBlock, reflect_pad


class Encoder(nn.Module):
    def __init__(self, in_ch: int, ngf: int = 64, n_downsampling: int = 4,
                 n_blocks: int = 9, addcoords: bool = False,
                 dtype=torch.float32, precision: str = "highest",
                 bwd_precision=None):
        super().__init__()
        self.addcoords = addcoords
        self.n_downsampling = n_downsampling
        self.n_blocks = n_blocks
        kw = dict(dtype=dtype, precision=precision,
                  bwd_precision=bwd_precision)
        self.conv_in = Conv2d(in_ch + 3 * addcoords, ngf, 7, **kw)
        for i in range(n_downsampling):
            self.add_module(f"down{i}", Conv2d(
                ngf * 2 ** i, ngf * 2 ** (i + 1), 3, stride=2, padding=1,
                **kw))
        for j in range(n_blocks):
            self.add_module(f"block{j}",
                            ResnetBlock(ngf * 2 ** n_downsampling, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, in_ch) -> (B, H / 2^n, W / 2^n, ngf * 2^n)."""
        if self.addcoords:
            x = coord_channels(x)
        x = torch.relu(instance_norm(self.conv_in(reflect_pad(x, 3))))
        for i in range(self.n_downsampling):
            x = torch.relu(instance_norm(getattr(self, f"down{i}")(x)))
        for j in range(self.n_blocks):
            x = getattr(self, f"block{j}")(x)
        return x
