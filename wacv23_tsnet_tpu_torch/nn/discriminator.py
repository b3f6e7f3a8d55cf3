"""70x70 PatchGAN discriminator (counterpart of the JAX package's
`nn/discriminator.py:PatchDiscriminator` and `define_D`).

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


def define_D(in_ch: int, ndf: int, net_d: str = "basic", n_layers_d: int = 3,
             **kwargs) -> PatchDiscriminator:
    """Discriminator factory: "basic" (3 layers) or "n_layers". The
    PixelGAN of the JAX package's zoo, unused by TS-Net, is not ported."""
    if net_d == "basic":
        return PatchDiscriminator(in_ch, ndf=ndf, n_layers=3, **kwargs)
    if net_d == "n_layers":
        return PatchDiscriminator(in_ch, ndf=ndf, n_layers=n_layers_d,
                                  **kwargs)
    raise NotImplementedError(f"Discriminator model name [{net_d}] is not "
                              "ported")
