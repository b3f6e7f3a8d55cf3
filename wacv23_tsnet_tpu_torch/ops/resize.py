"""Resizing with PyTorch index conventions (NHWC).

- `resize_nearest`: `F.interpolate(mode="nearest")`'s asymmetric
  `src = floor(dst * in / out)`, written as a gather so that it is the
  same index rule as the JAX package's `ops/resize.py`.
- `upsample_bilinear_2x`: `nn.Upsample(scale_factor=2, mode="bilinear",
  align_corners=False)`, the decoder's upsample.
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
