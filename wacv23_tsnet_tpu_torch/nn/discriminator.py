"""70x70 PatchGAN discriminator and the zoo's PixelGAN and whole-image
discriminators (counterpart of the JAX package's `nn/discriminator.py`).

Returns the activations of all n_layers + 2 stages: all but the last feed
the feature-matching loss, the last is the patch logit map. 4x4 kernels
with zero padding 1: stride 2 on stages 0 .. n_layers-1, stride 1 on the
last two; affine-free instance norm on stages 1 .. n_layers; leaky ReLU
0.2 after every stage but the last. Every conv keeps its bias.
Parameters are named `stage{i}` as in the JAX package's tree.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.norms import instance_norm
from .blocks import Conv2d


class PatchDiscriminator(nn.Module):
    def __init__(self, in_ch: int, ndf: int = 64, n_layers: int = 3,
                 dtype=torch.float32, precision: str = "highest",
                 bwd_precision=None):
        super().__init__()
        self.n_layers = n_layers
        kw = dict(padding=1, dtype=dtype, precision=precision,
                  bwd_precision=bwd_precision)
        widths = [ndf] + [ndf * min(2 ** n, 8) for n in range(1, n_layers + 1)]
        ch = in_ch
        for i, out in enumerate(widths):
            stride = 2 if i < n_layers else 1
            self.add_module(f"stage{i}", Conv2d(ch, out, 4, stride=stride,
                                                **kw))
            ch = out
        self.add_module(f"stage{n_layers + 1}", Conv2d(ch, 1, 4, **kw))

    def reset_parameters(self, generator=None) -> None:
        """normal(0, 0.02) kernels, zero biases, in stage order."""
        for i in range(self.n_layers + 2):
            getattr(self, f"stage{i}").reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        for i in range(self.n_layers + 1):
            x = getattr(self, f"stage{i}")(x)
            if i > 0:
                x = instance_norm(x)
            x = F.leaky_relu(x, 0.2)
            feats.append(x)
        feats.append(getattr(self, f"stage{self.n_layers + 1}")(x))
        return feats


class PixelDiscriminator(nn.Module):
    """1x1 PixelGAN discriminator (the reference's, unused by TS-Net):
    conv0 to ndf, leaky ReLU, conv1 to 2 ndf, IN, leaky ReLU, conv2 to 1
    logit a pixel."""

    def __init__(self, in_ch: int, ndf: int = 64, dtype=torch.float32,
                 precision: str = "highest"):
        super().__init__()
        kw = dict(dtype=dtype, precision=precision)
        self.conv0 = Conv2d(in_ch, ndf, 1, **kw)
        self.conv1 = Conv2d(ndf, 2 * ndf, 1, **kw)
        self.conv2 = Conv2d(2 * ndf, 1, 1, **kw)

    def reset_parameters(self, generator=None) -> None:
        for i in range(3):
            getattr(self, f"conv{i}").reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.conv0(x), 0.2)
        x = F.leaky_relu(instance_norm(self.conv1(x)), 0.2)
        return self.conv2(x)


class VideoDiscriminator(nn.Module):
    """DCGAN-style whole-image discriminator (the reference's, unused by
    TS-Net): six bias-free stride-2 4x4 convs (zero pad 1) widening ndf x
    1..32, IN after all but the first, leaky ReLU 0.2; then a 4x4 VALID
    conv to `out_nc`, flattened per sample: 256² -> (B, out_nc)."""

    def __init__(self, in_ch: int, out_nc: int = 16, ndf: int = 64,
                 dtype=torch.float32, precision: str = "highest"):
        super().__init__()
        kw = dict(dtype=dtype, precision=precision, bias=False)
        ch = in_ch
        for i, m in enumerate((1, 2, 4, 8, 16, 32)):
            self.add_module(f"conv{i}", Conv2d(ch, ndf * m, 4, stride=2,
                                               padding=1, **kw))
            ch = ndf * m
        self.conv_out = Conv2d(ch, out_nc, 4, **kw)

    def reset_parameters(self, generator=None) -> None:
        for i in range(6):
            getattr(self, f"conv{i}").reset_parameters(generator)
        self.conv_out.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(6):
            x = getattr(self, f"conv{i}")(x)
            if i > 0:
                x = instance_norm(x)
            x = F.leaky_relu(x, 0.2)
        x = self.conv_out(x)
        return x.reshape(x.shape[0], -1)


def define_D(in_ch: int, ndf: int, net_d: str = "basic", n_layers_d: int = 3,
             device="cuda", generator=None, **kwargs) -> nn.Module:
    """Discriminator factory: "basic" (3 layers), "n_layers" or "pixel",
    initialised from `generator` (normal(0, 0.02) kernels, zero biases)
    and placed on `device` (the GPU unless the caller asks for the
    CPU)."""
    dev = resolve_device(device)
    if net_d == "basic":
        net = PatchDiscriminator(in_ch, ndf=ndf, n_layers=3, **kwargs)
    elif net_d == "n_layers":
        net = PatchDiscriminator(in_ch, ndf=ndf, n_layers=n_layers_d,
                                 **kwargs)
    elif net_d == "pixel":
        net = PixelDiscriminator(in_ch, ndf=ndf, **kwargs)
    else:
        raise NotImplementedError(f"Discriminator model name [{net_d}] "
                                  "is not recognized")
    net.reset_parameters(generator)
    return net.to(dev)
