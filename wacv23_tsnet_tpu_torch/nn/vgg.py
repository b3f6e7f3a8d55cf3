"""VGG19 feature extractor of the perceptual loss (counterpart of the JAX
package's `nn/vgg.py`).

torchvision's VGG19 `.features` up to relu5_1: 13 3x3 convs (zero padding
1), a ReLU after each, taps after the ReLUs of convs (0, 2, 4, 8, 12)
(relu1_1 .. relu5_1) and a 2x2 max pool after those of convs
(1, 3, 7, 11). The images go in as they are (model space), with no
ImageNet renormalization, as in the torch reference.

Weights: `load_vgg19_npz` reads `weights/vgg19_features.npz` (keys
`conv{i}_kernel` in HWIO and `conv{i}_bias`, the JAX package's format)
where that file exists. Without it the network keeps a seeded random
init (flax's lecun_normal: truncated normal, std 1/sqrt(fan_in)), a valid
random-feature perceptual loss but not the pretrained one.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import Conv2d

VGG_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512,
                512)
TAPS = (0, 2, 4, 8, 12)
POOL_AFTER = (1, 3, 7, 11)
DEFAULT_WEIGHTS = (Path(__file__).resolve().parent.parent.parent / "weights"
                   / "vgg19_features.npz")

# std of a unit normal truncated to [-2, 2]: flax's variance_scaling
# divides by it so that the truncated draw keeps the intended variance
_TRUNC_STD = 0.87962566103423978


class VGG19Features(nn.Module):
    """Returns [relu1_1, relu2_1, relu3_1, relu4_1, relu5_1] (NHWC)."""

    def __init__(self, dtype=torch.float32, precision: str = "highest"):
        super().__init__()
        ch = 3
        for i, out in enumerate(VGG_CHANNELS):
            self.add_module(f"conv{i}", Conv2d(ch, out, 3, padding=1,
                                               dtype=dtype,
                                               precision=precision))
            ch = out

    def reset_parameters(self, generator=None) -> None:
        """lecun_normal kernels (flax's default for this module), zero
        biases, drawn on the CPU from `generator`."""
        with torch.no_grad():
            for i in range(len(VGG_CHANNELS)):
                conv = getattr(self, f"conv{i}")
                fan_in = conv.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                w = torch.empty(conv.weight.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                conv.weight.copy_(w * std)
                conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for i in range(len(VGG_CHANNELS)):
            x = torch.relu(getattr(self, f"conv{i}")(x))
            if i in TAPS:
                taps.append(x)
            if i in POOL_AFTER:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        return taps


def load_vgg19_npz(path=None) -> dict | None:
    """The converted VGG19 conv weights as a flax-layout tree
    {conv{i}: {kernel (HWIO), bias}} of numpy arrays, or None where the
    file does not exist."""
    path = Path(path) if path is not None else DEFAULT_WEIGHTS
    if not path.exists():
        return None
    data = np.load(path)
    return {f"conv{i}": {"kernel": np.asarray(data[f"conv{i}_kernel"]),
                         "bias": np.asarray(data[f"conv{i}_bias"])}
            for i in range(len(VGG_CHANNELS))}
