"""TS-Net encoder trunk (counterpart of the JAX package's `nn/encoder.py`).

CoordConv channels (optional), a 7x7 reflect-pad conv to ngf channels,
`n_downsampling` stride-2 3x3 convs (zero pad 1) doubling the channels,
each followed by IN + ReLU, then `n_blocks` ResNet blocks. `ring_pad`
runs the stem and the blocks' reflect-pad convs without the padded
tensor (`ops.reflectconv`).

The stem's route follows its precision and the input's device
(`folds_stem`): under `precision="high"` on the card (bf16x3), for H and
W divisible by 4, the stem conv runs in 4x4-folded space (`folded_stem`,
`ops.stemconv`), a 3x3 conv over 16x the input channels that cuDNN takes
to its tensor cores, where the 7x7 over 5 or 8 channels runs its fp32
FFMA kernel; its instance norm runs in phase layout and only the
normalised activation is interleaved. Its backward is the 7x7 conv's, at
the conv's `bwd_precision`. Every other tier, and every CPU tensor, runs
the reflect-padded 7x7 (with `ring_pad`, without the padded tensor; the
folded stem pads its few input channels either way).
`encoder_apply_fast` is the module with the folded stem in any tier (the
JAX package's function of that name; its TPU measured it slower end to
end).

Every instance norm (+ ReLU) of the stem, the stride-2 convs and the
blocks takes the generator's norm route
(`ops.norm_kernels.instance_norm_routed`, counted in
`utils.profiling.TRUNK_NORMS`): K8, one launch each, at inference on the
card in a tier that `nn.blocks.norms_on_k8` admits (fp32 encoders at
"high", in K8's two-pass form, the port's fp32 statistics); the ATen
composition on the CPU, while a gradient flows, with `use_kernels=False`
and in the other tiers ("highest", `fast_trunk`).

Used twice in TS-Net: the image encoder (3 + label_nc input channels,
9 blocks) and the label encoder (label_nc input channels, no blocks).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.coords import coord_channels
from ..ops.norm_kernels import instance_norm_routed
from ..utils.profiling import TRUNK_NORMS
from .blocks import Conv2d, ResnetBlock, norms_on_k8, reflect_conv


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

    def forward(self, x: torch.Tensor,
                use_kernels: bool = True) -> torch.Tensor:
        """(B, H, W, in_ch) -> (B, H / 2^n, W / 2^n, ngf * 2^n).
        `use_kernels=False` keeps every norm on the composition."""
        if self.addcoords:
            x = coord_channels(x)
        c = self.conv_in
        if (folds_stem(c.precision, c.dtype, x.device.type)
                and x.shape[1] % 4 == 0 and x.shape[2] % 4 == 0):
            x = folded_stem(c, x, use_kernels=use_kernels)
        else:
            x = reflect_conv(x, c.weight, c.bias, 3, c.precision, c.dtype,
                             c.bwd_precision, self.ring_pad)
            x = instance_norm_routed(
                x, TRUNK_NORMS, relu=True,
                use_kernels=use_kernels and norms_on_k8(c.dtype, c.precision))
        return self.trunk(x, use_kernels)

    def trunk(self, x: torch.Tensor,
              use_kernels: bool = True) -> torch.Tensor:
        """The layers after the stem: the stride-2 convs, then the blocks."""
        for i in range(self.n_downsampling):
            down = getattr(self, f"down{i}")
            k8 = use_kernels and norms_on_k8(down.dtype, down.precision)
            x = instance_norm_routed(down(x), TRUNK_NORMS, relu=True,
                                     use_kernels=k8)
        for j in range(self.n_blocks):
            x = getattr(self, f"block{j}")(x, use_kernels, TRUNK_NORMS)
        return x


def folds_stem(precision: str, dtype, device_type: str) -> bool:
    """Whether `Encoder.forward` runs its stem folded: bf16x3 ("high" on
    an fp32 tensor) on the card. On the CPU "high" is the fp32 conv, and
    the bf16 and "default" tiers take one bf16 pass, which cuDNN already
    runs on its tensor cores, as it does "highest"'s plain fp32."""
    return (precision == "high" and dtype == torch.float32
            and device_type == "cuda")


def folded_stem(c: Conv2d, x: torch.Tensor, fold: int = 4,
                use_kernels: bool = True) -> torch.Tensor:
    """relu(instance_norm(stem conv `c` of reflect_pad(x, 3))), the stem
    conv in `fold`x`fold`-folded space (`ops.stemconv.stem_conv7_fold4`,
    at the conv's precision, backward at its `bwd_precision`), the norm
    and ReLU in phase layout (routed, `phase_groups=fold²`), then
    interleaved. H and W divisible by `fold`."""
    from ..ops.stemconv import depth_to_space, stem_conv7_fold4
    yf = stem_conv7_fold4(x.to(c.dtype), c.weight.to(c.dtype),
                          c.bias.to(c.dtype), c.precision, fold,
                          c.bwd_precision)
    y = instance_norm_routed(
        yf, TRUNK_NORMS, relu=True, phase_groups=fold * fold,
        use_kernels=use_kernels and norms_on_k8(c.dtype, c.precision))
    return depth_to_space(y, fold)


def encoder_apply_fast(enc: Encoder, x: torch.Tensor) -> torch.Tensor:
    """`enc(x)` with the stem conv computed in 4x4-folded space in any
    tier (`folded_stem`), then the module's own layers: the JAX
    package's `encoder_apply_fast`. H and W divisible by 4."""
    if enc.addcoords:
        x = coord_channels(x)
    return enc.trunk(folded_stem(enc.conv_in, x))
