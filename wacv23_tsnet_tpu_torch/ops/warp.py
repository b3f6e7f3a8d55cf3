"""Patch-grid image warping: the image-space warp supervision of training.

Counterpart of the JAX package's `ops/warp.py`. The full-resolution
source image is cut into an h x w grid of (p x p) patches
(`space_to_depth`), the patch grid is grid-sampled with the
feature-resolution flow, and the patches are put back (`depth_to_space`):
the torch reference's `F.unfold` -> `F.grid_sample` -> `F.fold` with
kernel == stride, written as two reshapes around one `grid_sample`.
"""

from __future__ import annotations

import torch

from .grid_sample import grid_sample


def space_to_depth(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/p, W/p, p*p*C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // p, w // p, p * p * c)


def depth_to_space(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, h, w, p*p*C) -> (B, h*p, w*p, C)."""
    b, h, w, d = x.shape
    c = d // (p * p)
    x = x.reshape(b, h, w, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * p, w * p, c)


def patch_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp img (B, H, W, C) by a feature-resolution flow (B, h, w, 2),
    H = h * p, normalized (x, y) -> (B, H, W, C)."""
    p = img.shape[1] // flow.shape[1]
    return depth_to_space(grid_sample(space_to_depth(img, p), flow), p)
