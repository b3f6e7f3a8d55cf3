"""pix2pix-style generator zoo (counterpart of the JAX package's
`nn/generators.py`).

The reference's `define_G`, `ResnetGenerator` and `UnetGenerator`, which
TS-Net itself does not use; kept so that reference-style experiments
port directly. As in the JAX package, instance norm and reflect padding
throughout, and the upsampling is a bilinear 2x resize followed by a
conv instead of a transposed conv. NHWC tensors; parameters named as in
the JAX param trees (`compat.flax_params` maps one onto the other).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.norms import instance_norm
from ..ops.resize import upsample_bilinear_2x
from .blocks import Conv2d, ResnetBlock, reflect_pad


def _reset(module: nn.Module, generator) -> None:
    """normal(0, 0.02) kernels, zero biases, in module order."""
    for m in module.modules():
        if isinstance(m, Conv2d):
            m.reset_parameters(generator)


class ResnetGenerator(nn.Module):
    """7x7 stem, `n_downsampling` stride-2 3x3 convs, `n_blocks` ResNet
    blocks, `n_downsampling` [upsample, 3x3 conv] stages, 7x7 conv + tanh;
    IN + ReLU after every conv but the last."""

    def __init__(self, input_nc: int, output_nc: int = 3, ngf: int = 64,
                 n_blocks: int = 6, n_downsampling: int = 2,
                 dtype=torch.float32, precision: str = "highest"):
        super().__init__()
        kw = dict(dtype=dtype, precision=precision)
        self.n_blocks, self.n_downsampling = n_blocks, n_downsampling
        self.conv_in = Conv2d(input_nc, ngf, 7, **kw)
        for i in range(n_downsampling):
            mult = 2 ** i
            self.add_module(f"down{i}", Conv2d(ngf * mult, ngf * mult * 2, 3,
                                               stride=2, padding=1, **kw))
        mult = 2 ** n_downsampling
        for j in range(n_blocks):
            self.add_module(f"block{j}", ResnetBlock(ngf * mult, **kw))
        for i in range(n_downsampling):
            mult = 2 ** (n_downsampling - i)
            self.add_module(f"up{i}", Conv2d(ngf * mult, ngf * mult // 2, 3,
                                             **kw))
        self.conv_out = Conv2d(ngf, output_nc, 7, **kw)

    def reset_parameters(self, generator=None) -> None:
        _reset(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(instance_norm(self.conv_in(reflect_pad(x, 3))))
        for i in range(self.n_downsampling):
            x = torch.relu(instance_norm(getattr(self, f"down{i}")(x)))
        for j in range(self.n_blocks):
            x = getattr(self, f"block{j}")(x)
        for i in range(self.n_downsampling):
            x = reflect_pad(upsample_bilinear_2x(x), 1)
            x = torch.relu(instance_norm(getattr(self, f"up{i}")(x)))
        return torch.tanh(self.conv_out(reflect_pad(x, 3)))


class UnetGenerator(nn.Module):
    """U-Net with `num_downs` levels: 4x4 stride-2 convs down (IN on the
    inner ones, leaky ReLU 0.2), [ReLU, upsample, 3x3 conv] up (IN on all
    but the outermost), each level's output concatenated after its skip;
    tanh out. A 2^num_downs input side is needed."""

    def __init__(self, input_nc: int, output_nc: int = 3, ngf: int = 64,
                 num_downs: int = 7, dtype=torch.float32,
                 precision: str = "highest"):
        super().__init__()
        kw = dict(dtype=dtype, precision=precision)
        self.num_downs = num_downs
        chans = [min(ngf * 2 ** i, ngf * 8) for i in range(num_downs)]
        ch = input_nc
        for i, out in enumerate(chans):
            self.add_module(f"down{i}", Conv2d(ch, out, 4, stride=2,
                                               padding=1, **kw))
            ch = out
        for i in reversed(range(num_downs)):
            out = output_nc if i == 0 else chans[i - 1]
            in_ch = chans[i] if i == num_downs - 1 else 2 * chans[i]
            self.add_module(f"up{i}", Conv2d(in_ch, out, 3, padding=1, **kw))

    def reset_parameters(self, generator=None) -> None:
        _reset(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.num_downs
        skips = []
        for i in range(n):
            x = getattr(self, f"down{i}")(x)
            if 0 < i < n - 1:
                x = instance_norm(x)
            skips.append(x)
            if i < n - 1:
                x = F.leaky_relu(x, 0.2)
        for i in reversed(range(n)):
            x = getattr(self, f"up{i}")(upsample_bilinear_2x(torch.relu(x)))
            if i > 0:
                x = torch.cat([skips[i - 1], instance_norm(x)], dim=-1)
        return torch.tanh(x)


def define_G(input_nc: int, output_nc: int, ngf: int, net_g: str,
             device="cuda", generator=None, **kwargs) -> nn.Module:
    """Generator factory (the reference's `define_G`): resnet_9blocks,
    resnet_6blocks, unet_128 (7 levels) or unet_256 (8 levels),
    initialised from `generator` (normal(0, 0.02) kernels, zero biases)
    and placed on `device` (the GPU unless the caller asks for the
    CPU)."""
    dev = resolve_device(device)
    if net_g in ("resnet_9blocks", "resnet_6blocks"):
        net = ResnetGenerator(input_nc, output_nc, ngf,
                              n_blocks=9 if net_g == "resnet_9blocks" else 6,
                              **kwargs)
    elif net_g in ("unet_128", "unet_256"):
        net = UnetGenerator(input_nc, output_nc, ngf,
                            num_downs=7 if net_g == "unet_128" else 8,
                            **kwargs)
    else:
        raise NotImplementedError(f"Generator model name [{net_g}] "
                                  "is not recognized")
    net.reset_parameters(generator)
    return net.to(dev)
