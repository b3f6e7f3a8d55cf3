"""Bilinear grid sampling with `F.grid_sample` semantics (NHWC).

The plain warp of the transformation branch: (x, y) grid in [-1, 1],
`align_corners=False` unnormalization `ix = ((x + 1) * W - 1) / 2`, and
out-of-canvas corners weighted 0 (`padding_mode="zeros"`). Written as four
corner gathers, as in the JAX package's `ops/grid_sample.py`.
"""

from __future__ import annotations

import torch


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample `img` (B, H, W, C) at `grid` (B, Hg, Wg, 2) -> (B, Hg, Wg, C)."""
    b, h, w, _ = img.shape
    ix = ((grid[..., 0] + 1.0) * w - 1.0) * 0.5
    iy = ((grid[..., 1] + 1.0) * h - 1.0) * 0.5
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    wx = ix - x0
    wy = iy - y0
    x0i = x0.long()
    y0i = y0.long()
    bidx = torch.arange(b, device=img.device).reshape(
        (b,) + (1,) * (grid.dim() - 2))

    def corner(yi, xi, weight):
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        vals = img[bidx, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        wgt = torch.where(valid, weight, torch.zeros_like(weight))
        return vals * wgt[..., None].to(img.dtype)

    out = corner(y0i, x0i, (1.0 - wy) * (1.0 - wx))
    out = out + corner(y0i, x0i + 1, (1.0 - wy) * wx)
    out = out + corner(y0i + 1, x0i, wy * (1.0 - wx))
    out = out + corner(y0i + 1, x0i + 1, wy * wx)
    return out
