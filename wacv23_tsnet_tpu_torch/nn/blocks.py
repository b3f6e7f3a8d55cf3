"""Shared building blocks (NHWC tensors, PyTorch modules).

Counterpart of the JAX package's `nn/blocks.py`: reflection padding
before VALID convolutions, affine-free instance norm, normal(0, 0.02)
kernels and zero biases.

Every convolution goes through `conv2d`, which takes the tier's
activation dtype and precision (see `configs/base.py`):

- dtype bf16 (`fast_tail`): input, kernel and bias in bf16, bf16 out;
- dtype f32, precision "default" (`fast_trunk`): one bf16 pass, output
  back to f32, bias added in f32;
- dtype f32, precision "high": TF32;
- dtype f32, precision "highest": full fp32, TF32 off.

The f32 tiers hold in both directions: autograd would dispatch a
convolution's backward later, under the process's own TF32 setting
(cuDNN's default is TF32 on), so `ops.dpconv.conv2d_dp` computes
grad-input and grad-weight under the tier's own setting, the forward's
or `bwd_precision`'s where a module sets one.

Tensors stay NHWC; a convolution sees them as channels_last NCHW views.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dpconv import PRECISIONS, conv2d_dp
from ..ops.norms import instance_norm


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Spatial reflection padding of an NHWC tensor (torch ReflectionPad2d)."""
    _, h, w, _ = x.shape

    def index(n):
        i = torch.arange(-p, n + p, device=x.device).abs()
        return torch.where(i > n - 1, 2 * (n - 1) - i, i)

    return x.index_select(1, index(h)).index_select(2, index(w))


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias=None, stride: int = 1,
           padding: int = 0, precision: str = "highest",
           dtype=torch.float32, bwd_precision=None) -> torch.Tensor:
    """2D convolution of an NHWC tensor with an OIHW kernel, in the tier's
    dtype and precision, its backward at `bwd_precision` (None: as the
    forward; `ops.dpconv`). Zero `padding` pixels on each side. A bf16
    conv's operands are bf16 in both directions."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")

    def run(xx, ww, bb):
        y = F.conv2d(xx.permute(0, 3, 1, 2), ww, bb, stride, padding)
        return y.permute(0, 2, 3, 1)

    if dtype == torch.bfloat16:
        b = None if bias is None else bias.to(torch.bfloat16)
        return run(x.to(torch.bfloat16), weight.to(torch.bfloat16), b)
    if precision == "default" and bwd_precision in (None, "default"):
        y = run(x.to(torch.bfloat16), weight.to(torch.bfloat16), None).float()
        return y if bias is None else y + bias.float()
    return conv2d_dp(x, weight, bias, stride, padding, precision,
                     bwd_precision)


class Conv2d(nn.Module):
    """Convolution module holding an OIHW kernel and a bias (f32)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype=torch.float32,
                 precision: str = "highest", bwd_precision=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.precision = precision
        self.bwd_precision = bwd_precision
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        """normal(0, 0.02) kernel, zero bias. Drawn on the CPU from
        `generator`, so one seed gives the same weights on any device."""
        with torch.no_grad():
            self.weight.copy_(torch.empty(self.weight.shape).normal_(
                0.0, 0.02, generator=generator))
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, self.stride, self.padding,
                      self.precision, self.dtype, self.bwd_precision)


class ResnetBlock(nn.Module):
    """reflect-pad 3x3 conv + IN + ReLU, reflect-pad 3x3 conv + IN, +skip."""

    def __init__(self, dim: int, dtype=torch.float32,
                 precision: str = "highest", bwd_precision=None):
        super().__init__()
        kw = dict(dtype=dtype, precision=precision,
                  bwd_precision=bwd_precision)
        self.conv1 = Conv2d(dim, dim, 3, **kw)
        self.conv2 = Conv2d(dim, dim, 3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(instance_norm(self.conv1(reflect_pad(x, 1))))
        return x + instance_norm(self.conv2(reflect_pad(h, 1)))
