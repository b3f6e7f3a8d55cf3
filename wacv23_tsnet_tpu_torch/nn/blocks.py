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
(cuDNN's default is TF32 on), so `_Conv2dTF32` computes grad-input and
grad-weight under the same `tf32(...)` setting as the forward.

Tensors stay NHWC; a convolution sees them as channels_last NCHW views.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.norms import instance_norm
from ..ops.precision import tf32

PRECISIONS = ("highest", "high", "default")


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Spatial reflection padding of an NHWC tensor (torch ReflectionPad2d)."""
    _, h, w, _ = x.shape

    def index(n):
        i = torch.arange(-p, n + p, device=x.device).abs()
        return torch.where(i > n - 1, 2 * (n - 1) - i, i)

    return x.index_select(1, index(h)).index_select(2, index(w))


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias=None, stride: int = 1,
           padding: int = 0, precision: str = "highest",
           dtype=torch.float32) -> torch.Tensor:
    """2D convolution of an NHWC tensor with an OIHW kernel, in the tier's
    dtype and precision. Zero `padding` pixels on each side."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")

    def run(xx, ww, bb):
        y = F.conv2d(xx.permute(0, 3, 1, 2), ww, bb, stride, padding)
        return y.permute(0, 2, 3, 1)

    if dtype == torch.bfloat16:
        b = None if bias is None else bias.to(torch.bfloat16)
        return run(x.to(torch.bfloat16), weight.to(torch.bfloat16), b)
    if precision == "default":
        y = run(x.to(torch.bfloat16), weight.to(torch.bfloat16), None).float()
        return y if bias is None else y + bias.float()
    y = _Conv2dTF32.apply(x.float().permute(0, 3, 1, 2), weight.float(), bias,
                          stride, padding, precision == "high")
    return y.permute(0, 2, 3, 1)


class _Conv2dTF32(torch.autograd.Function):
    """F.conv2d (NCHW) whose forward and backward both run under one
    TF32 setting: on for precision "high", off for "highest"."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, allow_tf32):
        with tf32(allow_tf32):
            y = F.conv2d(x, weight, bias, stride, padding)
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, allow_tf32, bias is not None)
        return y

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, allow_tf32, has_bias = ctx.conf
        need = ctx.needs_input_grad
        with tf32(allow_tf32):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]] if has_bias else None,
                [stride] * 2, [padding] * 2, [1, 1], False, [0, 0], 1,
                [need[0], need[1], has_bias and need[2]])
        return gx, gw, gb, None, None, None


class Conv2d(nn.Module):
    """Convolution module holding an OIHW kernel and a bias (f32)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype=torch.float32,
                 precision: str = "highest"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.precision = precision
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
                      self.precision, self.dtype)


class ResnetBlock(nn.Module):
    """reflect-pad 3x3 conv + IN + ReLU, reflect-pad 3x3 conv + IN, +skip."""

    def __init__(self, dim: int, dtype=torch.float32,
                 precision: str = "highest"):
        super().__init__()
        self.conv1 = Conv2d(dim, dim, 3, dtype=dtype, precision=precision)
        self.conv2 = Conv2d(dim, dim, 3, dtype=dtype, precision=precision)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(instance_norm(self.conv1(reflect_pad(x, 1))))
        return x + instance_norm(self.conv2(reflect_pad(h, 1)))
