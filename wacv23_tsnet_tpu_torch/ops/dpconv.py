"""Dual-precision convolution (counterpart of the JAX package's
`ops/dpconv.py`): the forward conv at `precision`, its two backward
convs (grad-input, grad-weight) at `bwd_precision`.

A conv's backward feeds Adam, not the temp-100 attention, so the JAX
package's shipped train tier runs it as one bf16 pass
(`bwd_precision="default"`) under a `precision="high"` forward. On the
GPU the tiers are:

- "highest": fp32 operands, TF32 off in cuDNN;
- "high": fp32 operands, TF32 on;
- "default": operands cast to bf16, result back to fp32.

The backward runs through `torch.ops.aten.convolution_backward` under
the backward tier, whatever the process's own TF32 flags, and saves only
(x, w), as the JAX VJP saves its residuals. With equal tiers this is the
plain conv of `nn.blocks.conv2d`, forward and backward, bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import tf32

PRECISIONS = ("highest", "high", "default")


def _forward(x, w, bias, stride, padding, precision):
    """NCHW fp32 conv at `precision` ("default": one bf16 pass, the bias
    added in fp32)."""
    if precision == "default":
        y = F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16), None,
                     stride, padding).float()
        return y if bias is None else y + bias.float()[:, None, None]
    with tf32(precision == "high"):
        return F.conv2d(x, w, bias, stride, padding)


def _backward(grad, x, w, has_bias, stride, padding, precision, need):
    """(grad-input, grad-weight, grad-bias) of an NCHW conv at `precision`."""
    args = ([stride] * 2, [padding] * 2, [1, 1], False, [0, 0], 1)
    if precision == "default":
        bf = torch.bfloat16
        gx, gw, _ = torch.ops.aten.convolution_backward(
            grad.to(bf), x.to(bf), w.to(bf), None, *args,
            [need[0], need[1], False])
        gb = None
        if has_bias and need[2]:      # the fp32 sum, as the fp32 tiers take it
            gb = torch.ops.aten.convolution_backward(
                grad, x, w, [w.shape[0]], *args, [False, False, True])[2]
        return (None if gx is None else gx.float(),
                None if gw is None else gw.float(), gb)
    with tf32(precision == "high"):
        return torch.ops.aten.convolution_backward(
            grad, x, w, [w.shape[0]] if has_bias else None, *args,
            [need[0], need[1], has_bias and need[2]])


class _ConvDP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, stride, padding, precision, bwd_precision):
        y = _forward(x, w, bias, stride, padding, precision)
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, bwd_precision, bias is not None)
        return y

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        stride, padding, bwd_precision, has_bias = ctx.conf
        gx, gw, gb = _backward(grad, x, w, has_bias, stride, padding,
                               bwd_precision, ctx.needs_input_grad[:3])
        return gx, gw, gb, None, None, None, None


def conv2d_dp(x: torch.Tensor, w: torch.Tensor, bias=None, stride: int = 1,
              padding: int = 0, precision: str = "highest",
              bwd_precision: str | None = None) -> torch.Tensor:
    """Conv of an fp32 NHWC tensor with an OIHW kernel, zero `padding`,
    forward at `precision` and backward at `bwd_precision` (None: the
    same). Returns fp32 NHWC."""
    bwd_precision = bwd_precision or precision
    for p in (precision, bwd_precision):
        if p not in PRECISIONS:
            raise ValueError(f"unknown precision {p!r}")
    y = _ConvDP.apply(x.float().permute(0, 3, 1, 2), w.float(), bias, stride,
                      padding, precision, bwd_precision)
    return y.permute(0, 2, 3, 1)
