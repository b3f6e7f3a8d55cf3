"""Resizing with PyTorch index conventions (NHWC).

- `resize_nearest`: `F.interpolate(mode="nearest")`'s asymmetric
  `src = floor(dst * in / out)`, written as a gather so that it is the
  same index rule as the JAX package's `ops/resize.py`.
- `upsample_bilinear_2x`: `nn.Upsample(scale_factor=2, mode="bilinear",
  align_corners=False)`, the decoder's upsample.
- `sample_separable`: bilinear sampling at fractional row and column
  positions, each sample its own (the pose variant's face crops); its
  gradient sums in a fixed order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import tf32


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


def _weights(idx0: torch.Tensor, idx1: torch.Tensor, frac: torch.Tensor,
             n: int) -> torch.Tensor:
    """(B, m, n) interpolation rows: 1 - frac at idx0 plus frac at idx1
    (B, m) (one index where the clamp made them one)."""
    cols = torch.arange(n, device=frac.device)
    return ((cols == idx0[..., None]).to(frac.dtype) * (1.0 - frac)[..., None]
            + (cols == idx1[..., None]).to(frac.dtype) * frac[..., None])


class _SampleSeparable(torch.autograd.Function):
    """The gather form forward; a backward without scatters: the
    transposed column and row weights as two batched fp32 matmuls, which
    sum in a fixed order (a gather's CUDA backward adds by atomics, in an
    order that changes from call to call)."""

    @staticmethod
    def forward(ctx, x, y0, y1, wy, x0, x1, wx):
        ctx.save_for_backward(y0, y1, wy, x0, x1, wx)
        ctx.hw = x.shape[1:3]
        rows = (_gather_axis(x, 1, y0) * (1.0 - wy[:, :, None, None])
                + _gather_axis(x, 1, y1) * wy[:, :, None, None])
        return (_gather_axis(rows, 2, x0) * (1.0 - wx[:, None, :, None])
                + _gather_axis(rows, 2, x1) * wx[:, None, :, None])

    @staticmethod
    def backward(ctx, g):
        y0, y1, wy, x0, x1, wx = ctx.saved_tensors
        h, w = ctx.hw
        b, ny, nx, c = g.shape
        ry = _weights(y0, y1, wy, h)                         # (B, ny, H)
        rx = _weights(x0, x1, wx, w)                         # (B, nx, W)
        with tf32(False):
            g_rows = torch.matmul(g.permute(0, 1, 3, 2),
                                  rx[:, None])               # (B, ny, C, W)
            gx = torch.matmul(ry.transpose(1, 2),
                              g_rows.transpose(2, 3).reshape(b, ny, w * c))
        return (gx.reshape(b, h, w, c),) + (None,) * 6


def sample_separable(x: torch.Tensor, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """Separable bilinear sampling of x (B, H, W, C) f32 at each sample's
    rows ys (B, ny) and columns xs (B, nx): floor, clamp to the image,
    blend the two rows, then the two columns -> (B, ny, nx, C). The
    weights come from the clamped indices, as in the JAX package's
    `_sample_separable`. Differentiable in x (not in the positions), by
    a backward that gives the same bits on every call; no loop over the
    batch."""
    _, h, w, _ = x.shape
    y0 = torch.floor(ys).long().clamp(0, h - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x0 = torch.floor(xs).long().clamp(0, w - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    return _SampleSeparable.apply(x, y0, y1, ys - y0.to(ys.dtype), x0, x1,
                                  xs - x0.to(xs.dtype))
