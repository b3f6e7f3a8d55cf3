"""TS-Net encoder trunk (counterpart of the JAX package's `nn/encoder.py`).

CoordConv channels (optional), a 7x7 reflect-pad conv to ngf channels,
`n_downsampling` stride-2 3x3 convs (zero pad 1) doubling the channels,
each followed by IN + ReLU, then `n_blocks` ResNet blocks. `ring_pad`
runs the stem and the blocks' reflect-pad convs without the padded
tensor (`ops.reflectconv`).

`encoder_apply_fast` is the same module with its stem conv in 4x4-folded
space (`ops.stemconv`); no entry point calls it, in the JAX package too
(its chip measured it slower end to end), and `chip_smoke.py` times it
against the module.

Used twice in TS-Net: the image encoder (3 + label_nc input channels,
9 blocks) and the label encoder (label_nc input channels, no blocks).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.coords import coord_channels
from ..ops.norms import instance_norm
from .blocks import Conv2d, ResnetBlock, reflect_conv


class Encoder(nn.Module):
    def __init__(self, in_ch: int, ngf: int = 64, n_downsampling: int = 4,
                 n_blocks: int = 9, addcoords: bool = False,
                 dtype=torch.float32, precision: str = "highest",
                 bwd_precision=None, ring_pad: bool = False):
        super().__init__()
        self.addcoords = addcoords
        self.ring_pad = ring_pad
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
                            ResnetBlock(ngf * 2 ** n_downsampling,
                                        ring_pad=ring_pad, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, in_ch) -> (B, H / 2^n, W / 2^n, ngf * 2^n)."""
        if self.addcoords:
            x = coord_channels(x)
        c = self.conv_in
        x = reflect_conv(x, c.weight, c.bias, 3, c.precision, c.dtype,
                         c.bwd_precision, self.ring_pad)
        x = torch.relu(instance_norm(x))
        for i in range(self.n_downsampling):
            x = torch.relu(instance_norm(getattr(self, f"down{i}")(x)))
        for j in range(self.n_blocks):
            x = getattr(self, f"block{j}")(x)
        return x


def encoder_apply_fast(enc: Encoder, x: torch.Tensor) -> torch.Tensor:
    """`enc(x)` with the stem conv computed in 4x4-folded space.

    The same parameters and math (the JAX package's
    `encoder_apply_fast`): `ops.stemconv.stem_conv7_fold4` runs the 7x7
    stem as a 3x3 conv over 16x the input channels, its instance norm
    runs grouped in phase layout, and only the normalised activation is
    interleaved; the rest is the module's own composition. H and W
    divisible by 4."""
    from ..ops.stemconv import (depth_to_space, instance_norm_grouped,
                                stem_conv7_fold4)
    if enc.addcoords:
        x = coord_channels(x)
    c = enc.conv_in
    fold = 4
    yf = stem_conv7_fold4(x.to(c.dtype), c.weight.to(c.dtype),
                          c.bias.to(c.dtype), precision=c.precision,
                          fold=fold)
    x = depth_to_space(torch.relu(instance_norm_grouped(yf, fold * fold)),
                       fold)
    for i in range(enc.n_downsampling):
        x = torch.relu(instance_norm(getattr(enc, f"down{i}")(x)))
    for j in range(enc.n_blocks):
        x = getattr(enc, f"block{j}")(x)
    return x
