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
so the instance norm behind it runs grouped (`instance_norm_grouped`:
statistics over the 16 phase copies of each channel, those of the
interleaved tensor) and only its output is interleaved.

Kernels are OIHW, tensors NHWC; the conv is the tier's
`ops.dpconv.conv2d` in the input's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..nn.blocks import reflect_pad
from .dpconv import conv2d


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


def stem_conv7_fold4(x: torch.Tensor, kernel: torch.Tensor,
                     bias: torch.Tensor, precision: str = "highest",
                     fold: int = 4) -> torch.Tensor:
    """[reflect_pad(3) -> 7x7 VALID conv] in `fold`x`fold`-folded space.

    x (B, H, W, Ci), H and W divisible by `fold`; kernel (Co, Ci, 7, 7);
    bias (Co,). Returns the phase-layout output (B, H/fold, W/fold,
    fold² Co) in x's dtype; `depth_to_space(y, fold)` interleaves it."""
    if kernel.shape[2:] != (7, 7):
        raise ValueError(f"stem kernel {tuple(kernel.shape[2:])} is not 7x7")
    h = x.shape[1]
    xp = reflect_pad(x, 3)
    ext = (-(h + 6)) % fold
    xp = F.pad(xp, (0, 0, 0, ext, 0, ext))
    return conv2d(space_to_depth(xp, fold), fold_kernel(kernel, fold),
                  bias.repeat(fold * fold),
                  precision=precision, dtype=x.dtype)


def instance_norm_grouped(x: torch.Tensor, groups: int,
                          eps: float = 1e-5) -> torch.Tensor:
    """Instance norm of a phase-layout tensor: statistics per (sample,
    base channel) over space and the `groups` phase copies, one pass in
    fp32 (E[x²] - E[x]², clamped at 0), as the JAX package's form. The
    instance norm of the interleaved tensor."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h * w * groups, c // groups)
    mean = xf.mean(dim=1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=1, keepdim=True) - mean * mean,
                      min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return y.reshape(b, h, w, c).to(x.dtype)
