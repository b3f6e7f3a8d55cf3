"""Coordinate grids and CoordConv channels (NHWC).

Counterpart of the JAX package's `ops/coords.py`: `normalized_grid` is an
(h, w, 2) grid of (x, y) pairs with both axes `linspace(-1, 1)` inclusive,
and `coord_channels` appends x, y and the radius sqrt(x² + y²).
"""

from __future__ import annotations

import torch


def normalized_grid(h: int, w: int, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """(h, w, 2) grid of (x, y) coordinates, each in [-1, 1] inclusive."""
    ys = torch.linspace(-1.0, 1.0, h, dtype=dtype, device=device)
    xs = torch.linspace(-1.0, 1.0, w, dtype=dtype, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def coord_channels(x: torch.Tensor) -> torch.Tensor:
    """Append CoordConv channels (x, y, r) to an NHWC tensor."""
    b, h, w, _ = x.shape
    grid = normalized_grid(h, w, dtype=x.dtype, device=x.device)
    rr = torch.sqrt(grid[..., :1] * grid[..., :1]
                    + grid[..., 1:] * grid[..., 1:])
    extra = torch.cat([grid, rr], dim=-1).expand(b, h, w, 3)
    return torch.cat([x, extra], dim=-1)
