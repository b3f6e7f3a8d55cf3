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
plain conv, forward and backward, bit for bit.

`conv2d` is the tier's convolution every module and op of the port calls
(re-exported by `nn.blocks`): it takes the tier's activation dtype and
precision and, for the fp32 tiers, runs through `conv2d_dp`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import tf32

PRECISIONS = ("highest", "high", "default")


def _forward(x, w, bias, stride, padding, groups, precision):
    """NCHW fp32 conv at `precision` ("default": one bf16 pass, the bias
    added in fp32)."""
    if precision == "default":
        y = F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16), None,
                     stride, padding, 1, groups).float()
        return y if bias is None else y + bias.float()[:, None, None]
    with tf32(precision == "high"):
        return F.conv2d(x, w, bias, stride, padding, 1, groups)


def _backward(grad, x, w, has_bias, stride, padding, groups, precision,
              need):
    """(grad-input, grad-weight, grad-bias) of an NCHW conv at `precision`."""
    args = ([stride] * 2, list(padding), [1, 1], False, [0, 0], groups)
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
    def forward(ctx, x, w, bias, stride, padding, groups, precision,
                bwd_precision):
        y = _forward(x, w, bias, stride, padding, groups, precision)
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, groups, bwd_precision, bias is not None)
        return y

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        stride, padding, groups, bwd_precision, has_bias = ctx.conf
        gx, gw, gb = _backward(grad, x, w, has_bias, stride, padding, groups,
                               bwd_precision, ctx.needs_input_grad[:3])
        return gx, gw, gb, None, None, None, None, None


def _pair(padding) -> tuple[int, int]:
    return ((padding, padding) if isinstance(padding, int)
            else tuple(padding))


def conv2d_dp(x: torch.Tensor, w: torch.Tensor, bias=None, stride: int = 1,
              padding=0, precision: str = "highest",
              bwd_precision: str | None = None,
              groups: int = 1) -> torch.Tensor:
    """Conv of an fp32 NHWC tensor with an OIHW kernel, zero `padding`
    (pixels on each side: one int, or (rows, columns)), `groups` as in
    `F.conv2d`, forward at `precision` and backward at `bwd_precision`
    (None: the same). Returns fp32 NHWC."""
    bwd_precision = bwd_precision or precision
    for p in (precision, bwd_precision):
        if p not in PRECISIONS:
            raise ValueError(f"unknown precision {p!r}")
    y = _ConvDP.apply(x.float().permute(0, 3, 1, 2), w.float(), bias, stride,
                      _pair(padding), groups, precision, bwd_precision)
    return y.permute(0, 2, 3, 1)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias=None, stride: int = 1,
           padding=0, precision: str = "highest",
           dtype=torch.float32, bwd_precision=None,
           groups: int = 1) -> torch.Tensor:
    """2D convolution of an NHWC tensor with an OIHW kernel, in the tier's
    dtype and precision, its backward at `bwd_precision` (None: as the
    forward). Zero `padding` pixels on each side (one int, or (rows,
    columns)); `groups` as in `F.conv2d`. A bf16 conv's operands are bf16
    in both directions."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    padding = _pair(padding)

    def run(xx, ww, bb):
        y = F.conv2d(xx.permute(0, 3, 1, 2), ww, bb, stride, padding, 1,
                     groups)
        return y.permute(0, 2, 3, 1)

    if dtype == torch.bfloat16:
        b = None if bias is None else bias.to(torch.bfloat16)
        return run(x.to(torch.bfloat16), weight.to(torch.bfloat16), b)
    if precision == "default" and bwd_precision in (None, "default"):
        y = run(x.to(torch.bfloat16), weight.to(torch.bfloat16), None).float()
        return y if bias is None else y + bias.float()
    return conv2d_dp(x, weight, bias, stride, padding, precision,
                     bwd_precision, groups)
