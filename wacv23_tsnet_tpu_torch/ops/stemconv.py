"""Space-to-depth ("folded") stem convolution of the encoder (the port's
copy of the JAX package's `ops/stemconv.py`).

The encoders' first layer (reflect-pad 3 + 7x7 conv to ngf channels)
reads a few input channels at full resolution: label_nc + 3 CoordConv
channels, 5 for the face config. `stem_conv7_fold4` computes the SAME
conv in 4x4-folded space:

    x (B, H, W, Ci) --space-to-depth 4x4--> (B, H/4, W/4, 16 Ci)
    7x7 kernel      --exact scatter------> (16 Co, 16 Ci, 3, 3)
    VALID 3x3 conv  -> (B, H/4, W/4, 16 Co)   [phase layout]

The folded kernel is a pure scatter of the original taps (a gather from
a zero-padded copy, no arithmetic), so every product of the original conv
appears exactly once: the same sum up to its order, among structural
zeros.

Borders: the reflect pad happens before folding, then the padded map is
zero-extended to a multiple of the fold; the placement never reaches the
extension (tap t = 4q + r - p <= 6). The result stays in phase layout,
so the instance norm behind it runs grouped (`ops.norms.
instance_norm_phase` with 16 groups: statistics over the 16 phase copies
of each channel, those of the interleaved tensor, in the module's own
two-pass fp32 form where the JAX package takes one pass) and only its
output is interleaved.

On the card this is how the encoders run their stems under
`precision="high"` (`nn.encoder.Encoder.forward`): a 7x7 conv over 5 or
8 channels falls to cuDNN's fp32 FFMA kernel, while the folded 3x3 conv
over 80 or 128 channels takes its TF32 tensor-core kernels, and its
9 x 16 Ci products a sum stay within bf16x3's `CHAIN` for Ci <= 8.

Kernels are OIHW, tensors NHWC; the conv is the tier's
`ops.dpconv.conv2d` in the input's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..nn.blocks import reflect_pad
from . import cuda_build
from .dpconv import conv2d, conv2d_dp, conv_backward


def fold_kernel(kernel: torch.Tensor, fold: int = 4) -> torch.Tensor:
    """(Co, Ci, K, K) -> (fold² Co, fold² Ci, S, S), S = (K + fold - 2) //
    fold + 1: tap t lands at folded offset q, input phase r, output phase
    p iff t = fold q + r - p. Bit-exact copies of the taps. Channels
    (ry * fold + rx) * Ci + ci in, (py * fold + px) * Co + co out, the
    layouts of `space_to_depth`."""
    co, ci, kh, _ = kernel.shape
    s = (kh + fold - 2) // fold + 1
    pad_hi = fold * (s - 1) + fold - kh
    k = F.pad(kernel, (fold - 1, pad_hi, fold - 1, pad_hi)).permute(
        2, 3, 1, 0)                                     # (Kp, Kp, Ci, Co)
    q = torch.arange(s, device=kernel.device)[:, None, None]
    r = torch.arange(fold, device=kernel.device)[None, :, None]
    p = torch.arange(fold, device=kernel.device)[None, None, :]
    it = fold * q + r - p + (fold - 1)                  # (S, fold, fold)
    kf = k[it[:, None, :, None, :, None],
           it[None, :, None, :, None, :]]               # S S ry rx py px i o
    kf = kf.permute(0, 1, 2, 3, 6, 4, 5, 7).reshape(
        s, s, fold * fold * ci, fold * fold * co)
    return kf.permute(3, 2, 0, 1).contiguous()


def space_to_depth(x: torch.Tensor, fold: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h // fold, fold, w // fold, fold, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // fold, w // fold,
                                               fold * fold * c)


def depth_to_space(x: torch.Tensor, fold: int) -> torch.Tensor:
    b, h, w, c = x.shape
    cc = c // (fold * fold)
    x = x.reshape(b, h, w, fold, fold, cc).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * fold, w * fold, cc)


def _fold_input(xp: torch.Tensor, fold: int) -> torch.Tensor:
    """xp zero-extended to a multiple of the fold, then `space_to_depth`."""
    hp, wp = xp.shape[1:3]
    xp = F.pad(xp, (0, 0, 0, (-wp) % fold, 0, (-hp) % fold))
    return space_to_depth(xp, fold)


class _FoldedConvDP(torch.autograd.Function):
    """`conv_fold` of an fp32 xp: the folded conv forward (the folded
    kernel kept while the weight lives unchanged,
    `cuda_build.kept_weight`), and as backward the plain K x K conv's
    (`ops.dpconv.conv_backward` at `bwd_precision`, the cotangent
    interleaved): for one cotangent the gradients are the unfolded
    conv's, bit for bit."""

    @staticmethod
    def forward(ctx, xp, kernel, bias, precision, bwd_precision, fold):
        ctx.save_for_backward(xp, kernel)
        ctx.conf = (bias is not None, bwd_precision, fold)
        kf = cuda_build.kept_weight(kernel, f"fold{fold}",
                                    lambda k: fold_kernel(k, fold))
        return conv2d_dp(_fold_input(xp, fold), kf,
                         None if bias is None else bias.repeat(fold * fold),
                         precision=precision)

    @staticmethod
    def backward(ctx, grad):
        xp, kernel = ctx.saved_tensors
        has_bias, bwd_precision, fold = ctx.conf
        g = depth_to_space(grad, fold).permute(0, 3, 1, 2)
        gx, gw, gb = conv_backward(g, xp.permute(0, 3, 1, 2), kernel,
                                   has_bias, 1, (0, 0), 1, bwd_precision,
                                   ctx.needs_input_grad[:3])
        if gx is not None:
            gx = gx.permute(0, 2, 3, 1)
        return gx, gw, gb, None, None, None


def conv_fold(xp: torch.Tensor, kernel: torch.Tensor, bias,
              precision: str = "highest", fold: int = 4,
              bwd_precision=None) -> torch.Tensor:
    """VALID K x K conv of xp (B, Hp, Wp, Ci) in `fold`x`fold`-folded space:
    xp zero-extended to a multiple of the fold, `space_to_depth`, a VALID
    S x S conv with `fold_kernel(kernel)` at the tier's `precision` in
    xp's dtype. Hp - K + 1 and Wp - K + 1 divisible by `fold`. Returns the
    phase-layout output (B, (Hp - K + 1) / fold, (Wp - K + 1) / fold,
    fold² Co).

    The backward is at `bwd_precision` (None: `precision`). An fp32 xp
    takes the unfolded conv's backward (`_FoldedConvDP`): no gradient
    sums over the structural zeros, and a bf16x3 grad-weight summed as
    the module's own; a bf16 xp, the folded conv's through the fold."""
    if xp.dtype == torch.float32:
        return _FoldedConvDP.apply(xp, kernel, bias, precision,
                                   bwd_precision or precision, fold)
    return conv2d(_fold_input(xp, fold), fold_kernel(kernel, fold),
                  None if bias is None else bias.repeat(fold * fold),
                  precision=precision, dtype=xp.dtype,
                  bwd_precision=bwd_precision)


def stem_conv7_fold4(x: torch.Tensor, kernel: torch.Tensor,
                     bias: torch.Tensor, precision: str = "highest",
                     fold: int = 4, bwd_precision=None) -> torch.Tensor:
    """[reflect_pad(3) -> 7x7 VALID conv] in `fold`x`fold`-folded space.

    x (B, H, W, Ci), H and W divisible by `fold`; kernel (Co, Ci, 7, 7);
    bias (Co,). Returns the phase-layout output (B, H/fold, W/fold,
    fold² Co) in x's dtype; `depth_to_space(y, fold)` interleaves it."""
    if kernel.shape[2:] != (7, 7):
        raise ValueError(f"stem kernel {tuple(kernel.shape[2:])} is not 7x7")
    if x.shape[1] % fold or x.shape[2] % fold:
        raise ValueError(f"H, W = {tuple(x.shape[1:3])} are not divisible "
                         f"by the fold {fold}")
    return conv_fold(reflect_pad(x, 3), kernel, bias, precision, fold,
                     bwd_precision)
