"""Reflect-padded convolution without the padded tensor (the port's copy
of the JAX package's `ops/reflectconv.py`, behind `TSNetConfig.ring_pad`).

The generators reflect-pad every ResNet-block conv and the 7x7 stem and
output convs; `nn.blocks.reflect_pad` writes a padded copy of the
activation each time (and its backward scatters the gradient back).
`conv2d_reflect_dp` computes the SAME sums without that copy:

    conv(reflect_pad(x, p), k, VALID)
      = conv(x, k, zero-pad p)                 # the padding is free
      + corrections from the four pad bands    # a thin (3p-wide) conv each

The kernel taps that would read pad positions fall into four disjoint
zones: rows above and below the image (with the corners, through their
columns' reflection) and columns left and right of it (real rows only).
Each zone's contribution is a small conv over a band of mirrored border
rows or columns stacked with zeros, added into the output's border by a
slice write. Interior outputs are the padded conv's (same taps, the zero
padding adds nothing there); border outputs differ only in the order of
the float sums. Every piece is a conv or a slice, so the gradient follows
by autograd, each conv's backward at `bwd_precision` (`ops.dpconv`).
"""

from __future__ import annotations

import torch

from .dpconv import conv2d


def conv2d_reflect_dp(x: torch.Tensor, weight: torch.Tensor, p: int,
                      bias=None, precision: str = "highest",
                      dtype=torch.float32, bwd_precision=None
                      ) -> torch.Tensor:
    """`conv2d(reflect_pad(x, p), weight, bias)` with no padded tensor.

    x (B, H, W, Ci) NHWC; weight (Co, Ci, 2p+1, 2p+1) OIHW; the tier's
    `dtype`, `precision` and `bwd_precision` as in `ops.dpconv.conv2d`.
    Returns (B, H, W, Co). Takes p >= 1 and H, W > 2p, so that an interior
    row and column lie between the output bands that the top and bottom,
    left and right corrections write (`reflect_pad` itself takes H, W >
    p); raises ValueError otherwise."""
    kh, kw = weight.shape[2:]
    if kh != 2 * p + 1 or kw != 2 * p + 1:
        raise ValueError(f"kernel {(kh, kw)} does not match pad {p}")
    b, h, w, c = x.shape
    if p < 1 or min(h, w) <= 2 * p:
        raise ValueError(f"pad {p} needs p >= 1 and H, W > {2 * p}; "
                         f"got H, W = {h}, {w}")
    y = conv2d(x, weight, bias, 1, p, precision, dtype, bwd_precision)

    def cols_reflected(band):
        # the band's columns reflect-extended by p: the corners' values
        idx = torch.arange(-p, w + p, device=x.device).abs()
        idx = torch.where(idx > w - 1, 2 * (w - 1) - idx, idx)
        return band.index_select(2, idx)

    def conv(v, padding=0):
        return conv2d(v, weight, None, 1, padding, precision, dtype,
                      bwd_precision)

    # rows -p..-1 hold x[p..1]; output rows 0..p-1 read them
    zeros_r = x.new_zeros(b, 2 * p, w + 2 * p, c)
    top = cols_reflected(x[:, 1:p + 1].flip(1))
    y[:, :p] += conv(torch.cat([top, zeros_r], dim=1))
    # rows H..H+p-1 hold x[H-2..H-1-p]; output rows H-p..H-1 read them
    bot = cols_reflected(x[:, h - 1 - p:h - 1].flip(1))
    y[:, -p:] += conv(torch.cat([zeros_r, bot], dim=1))
    # columns -p..-1 and W..W+p-1 on the real rows (zero row padding)
    zeros_c = x.new_zeros(b, h, 2 * p, c)
    left = x[:, :, 1:p + 1].flip(2)
    y[:, :, :p] += conv(torch.cat([left, zeros_c], dim=2), (p, 0))
    right = x[:, :, w - 1 - p:w - 1].flip(2)
    y[:, :, -p:] += conv(torch.cat([zeros_c, right], dim=2), (p, 0))
    return y
