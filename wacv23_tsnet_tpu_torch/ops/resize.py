"""Resizing with PyTorch index conventions (NHWC).

- `resize_nearest`: `F.interpolate(mode="nearest")`'s asymmetric
  `src = floor(dst * in / out)`, written as a gather so that it is the
  same index rule as the JAX package's `ops/resize.py`.
- `upsample_bilinear_2x`: `nn.Upsample(scale_factor=2, mode="bilinear",
  align_corners=False)`, the decoder's upsample.
- `sample_separable`: bilinear sampling at fractional row and column
  positions, each sample its own (the pose variant's face crops).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Torch-convention nearest resize of an NHWC tensor."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    ys = torch.floor(torch.arange(oh, dtype=torch.float32, device=x.device)
                     * (h / oh)).long().clamp(0, h - 1)
    xs = torch.floor(torch.arange(ow, dtype=torch.float32, device=x.device)
                     * (w / ow)).long().clamp(0, w - 1)
    return x.index_select(1, ys).index_select(2, xs)


def upsample_bilinear_2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of an NHWC tensor, `align_corners=False`."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1).contiguous()


def _gather_axis(x: torch.Tensor, axis: int, idx: torch.Tensor
                 ) -> torch.Tensor:
    """x (B, H, W, C) gathered along `axis` (1 or 2) at idx (B, n), per
    sample."""
    shape = list(x.shape)
    shape[axis] = idx.shape[1]
    view = (idx.shape[0], -1, 1, 1) if axis == 1 else (idx.shape[0], 1, -1, 1)
    return torch.gather(x, axis, idx.reshape(view).expand(shape))


def sample_separable(x: torch.Tensor, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """Separable bilinear sampling of x (B, H, W, C) f32 at each sample's
    rows ys (B, ny) and columns xs (B, nx): floor, clamp to the image,
    blend the two rows, then the two columns -> (B, ny, nx, C). The
    weights come from the clamped indices, as in the JAX package's
    `_sample_separable`. Differentiable in x; no loop over the batch."""
    _, h, w, _ = x.shape
    y0 = torch.floor(ys).long().clamp(0, h - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    wy = (ys - y0.to(ys.dtype))[:, :, None, None]
    x0 = torch.floor(xs).long().clamp(0, w - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wx = (xs - x0.to(xs.dtype))[:, None, :, None]
    rows = (_gather_axis(x, 1, y0) * (1.0 - wy)
            + _gather_axis(x, 1, y1) * wy)
    return (_gather_axis(rows, 2, x0) * (1.0 - wx)
            + _gather_axis(rows, 2, x1) * wx)
