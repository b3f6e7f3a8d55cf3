"""Dual-precision convolution (counterpart of the JAX package's
`ops/dpconv.py`): the forward conv at `precision`, its two backward
convs (grad-input, grad-weight) at `bwd_precision`.

A conv's backward feeds Adam, not the temp-100 attention, so the JAX
package's shipped train tier runs it as one bf16 pass
(`bwd_precision="default"`) under a `precision="high"` forward. The
tiers are the JAX package's:

- "highest": fp32 operands, TF32 off in cuDNN;
- "high": three bf16 passes (bf16x3), as `Precision.HIGH` on the TPU:
  each fp32 operand is split into a bf16 head and the bf16 rounding of
  its residual (`split_bf16`), and the product is hi·hi + (hi·lo +
  lo·hi) with fp32 accumulation; only lo·lo, about 2^-16 relative, is
  dropped. On a CUDA tensor `conv_bf16x3` runs the three products
  through cuDNN with TF32 on: TF32 holds every bf16 value, so each
  product is exact, and the hi·hi sums are taken in pieces short enough
  for the tensor cores' accumulation (`CHAIN`). cuDNN runs the products
  on its TF32 tensor-core kernels where the input channels allow; over
  the encoders' 5 or 8 stem channels a 7x7 conv falls to its fp32 FFMA
  kernel (CUDA cores, 3x "highest"'s time), so the encoders take their
  stems through `ops.stemconv.conv_fold` under "high" on the card (a
  3x3 conv over 16x the channels, the same products; `nn.encoder.
  folds_stem`). On a CPU tensor "high"
  is the fp32 conv, as XLA's CPU backend computes `Precision.HIGH`;
- "default": operands cast to bf16, result back to fp32.

The backward runs through `torch.ops.aten.convolution_backward` under
the backward tier, whatever the process's own TF32 flags, and saves only
(x, w), as the JAX VJP saves its residuals: bf16x3 splits them again in
the backward (`conv_bf16x3_backward`). With equal tiers this is the
plain conv of the tier, forward and backward.

`conv2d` is the tier's convolution every module and op of the port calls
(re-exported by `nn.blocks`): it takes the tier's activation dtype and
precision and, for the fp32 tiers, runs through `conv2d_dp`.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .precision import tf32

PRECISIONS = ("highest", "high", "default")


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 x -> (hi, lo), fp32 tensors holding bf16 values: hi = bf16(x),
    lo = bf16(x - hi), so hi + lo is x to about 2^-16 relative (the JAX
    package's `_split_bf16`, kept in fp32 for the TF32 products).

    Four passes: x - hi is taken in fp32 from the bf16 head and rounded to
    bf16 as it is stored (`out=`), the same bits as rounding an fp32
    difference."""
    hi = x.to(torch.bfloat16)
    lo = torch.sub(x, hi, out=torch.empty_like(hi))
    return hi.float(), lo.float()


# On the card the tensor cores sum a long reduction less exactly than
# fp32 FMAs do: a TF32 conv of bf16-valued operands drifts from their
# exact sum by about 2e-9 relative per product summed. The hi·hi product,
# which carries all but 2^-8 of the result, is therefore summed in pieces
# of at most CHAIN products (channel slices for the forward and
# grad-input, batch slices for grad-weight), added in fp32; the two lo
# products, 2^-8 of it, are summed whole.
CHAIN = 1152


def _pieces(n: int, size: int) -> list[slice]:
    return [slice(i, min(i + size, n)) for i in range(0, n, size)]


def _channel_pieces(n: int, taps: int) -> list[slice]:
    """Slices of n channels of a reduction over channels x taps, each of
    at most CHAIN products (a multiple of 32 channels, at least 32)."""
    return _pieces(n, max(32, CHAIN // taps // 32 * 32))


def _per_group(t: torch.Tensor, dim: int, groups: int, sl: slice):
    """Entries `sl` of each of `groups` equal blocks of t along `dim`."""
    if groups == 1:
        return t[(slice(None),) * dim + (sl,)]
    t = t.unflatten(dim, (groups, -1))
    return t[(slice(None),) * (dim + 1) + (sl,)].flatten(dim, dim + 1)


def _sum(parts) -> torch.Tensor:
    """The fp32 sum of an iterable of tensors, in order."""
    return functools.reduce(torch.Tensor.add_, parts)


def conv_bf16x3(x, w, stride=1, padding=(0, 0), groups=1) -> torch.Tensor:
    """NCHW fp32 conv as three bf16 products summed in the JAX package's
    order, x_hi·w_hi + (x_hi·w_lo + x_lo·w_hi), fp32 accumulation (hi·hi
    in pieces of at most CHAIN products); no bias. Arguments as in
    `F.conv2d`."""
    (xh, xl), (wh, wl) = split_bf16(x), split_bf16(w)
    taps = w.shape[2] * w.shape[3]

    def conv(a, b):
        return F.conv2d(a, b, None, stride, padding, 1, groups)

    with tf32(True):
        hh = _sum(conv(_per_group(xh, 1, groups, sl), wh[:, sl])
                  for sl in _channel_pieces(w.shape[1], taps))
        return hh + (conv(xh, wl) + conv(xl, wh))


def conv_bf16x3_backward(grad, x, w, stride=1, padding=(0, 0), groups=1,
                         need=(True, True)):
    """(grad-input, grad-weight) of `conv_bf16x3`, each as three bf16
    products: g_hi·w_hi + (g_hi·w_lo + g_lo·w_hi) and x_hi⋆g_hi +
    (x_lo⋆g_hi + x_hi⋆g_lo), the hi·hi products in pieces as the forward
    sums them (grad-input over slices of the output channels,
    grad-weight over slices of the batch). One `convolution_backward`
    call gives one lo product of each. `need` masks them as
    `convolution_backward`'s output mask does (None where not asked)."""
    if not (need[0] or need[1]):
        return None, None
    (gh, gl), (xh, xl), (wh, wl) = map(split_bf16, (grad, x, w))
    args = ([stride] * 2, list(padding), [1, 1], False, [0, 0], groups)
    taps = w.shape[2] * w.shape[3]

    def bwd(g, xx, ww, mask):
        return torch.ops.aten.convolution_backward(
            g, xx, ww, None, *args, [*mask, False])[:2]

    with tf32(True):
        hl, lh = bwd(gh, xl, wl, need), bwd(gl, xh, wh, need)
        gx = gw = None
        if need[0]:
            gx = _sum(bwd(_per_group(gh, 1, groups, sl), xh,
                          _per_group(wh, 0, groups, sl), (True, False))[0]
                      for sl in _channel_pieces(w.shape[0] // groups, taps))
            gx = gx + (hl[0] + lh[0])
        if need[1]:
            per = max(1, CHAIN // (grad.shape[2] * grad.shape[3]))
            gw = _sum(bwd(gh[sl], xh[sl], wh, (False, True))[1]
                      for sl in _pieces(x.shape[0], per))
            gw = gw + (hl[1] + lh[1])
    return gx, gw


def _forward(x, w, bias, stride, padding, groups, precision):
    """NCHW fp32 conv at `precision` (bias added in fp32 after the
    products in the "default" and bf16x3 forms)."""
    if precision == "default":
        y = F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16), None,
                     stride, padding, 1, groups).float()
        return y if bias is None else y + bias.float()[:, None, None]
    if precision == "high" and x.is_cuda:
        y = conv_bf16x3(x, w, stride, padding, groups)
        return y if bias is None else y + bias.float()[:, None, None]
    with tf32(False):
        return F.conv2d(x, w, bias, stride, padding, 1, groups)


def conv_backward(grad, x, w, has_bias, stride, padding, groups, precision,
                  need):
    """(grad-input, grad-weight, grad-bias) of an NCHW conv at `precision`."""
    args = ([stride] * 2, list(padding), [1, 1], False, [0, 0], groups)
    if precision == "default":
        bf = torch.bfloat16
        gx, gw, _ = torch.ops.aten.convolution_backward(
            grad.to(bf), x.to(bf), w.to(bf), None, *args,
            [need[0], need[1], False])
        gx, gw = (None if g is None else g.float() for g in (gx, gw))
    elif precision == "high" and x.is_cuda:
        gx, gw = conv_bf16x3_backward(grad, x, w, stride, padding, groups,
                                      need[:2])
    else:
        with tf32(False):
            return torch.ops.aten.convolution_backward(
                grad, x, w, [w.shape[0]] if has_bias else None, *args,
                [need[0], need[1], has_bias and need[2]])
    gb = None
    if has_bias and need[2]:          # the fp32 sum, as the fp32 tiers take it
        gb = torch.ops.aten.convolution_backward(
            grad, x, w, [w.shape[0]], *args, [False, False, True])[2]
    return gx, gw, gb


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
        gx, gw, gb = conv_backward(grad, x, w, has_bias, stride, padding,
                                   groups, bwd_precision,
                                   ctx.needs_input_grad[:3])
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
