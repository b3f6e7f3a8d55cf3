"""Normalization primitives (NHWC), written out to match the JAX forms.

`instance_norm` is `torch.nn.InstanceNorm2d(affine=False)` semantics with
the JAX package's two numerics forms (its `ops/norms.py:16-42`):

- fp32 input: two-pass statistics, mean then E[(x - mean)²];
- bf16 input: one-pass fp32 statistics E[x²] - E[x]², the variance
  clamped at 0 (the cancellation can dip below 0 for a near-constant
  channel with a large mean, which would NaN the rsqrt).

`instance_norm_phase` is the same norm for a tensor in a phase layout:
the 2x2 of `ops/warp.py:space_to_depth` or the 4x4 of the folded stem.

`instance_norm_one_pass` is the phase decoder's up-stage form (the JAX
package's `upconv_in_relu`): one-pass fp32 statistics for both dtypes,
the ReLU in fp32, one rounding.

`l2_normalize` is `F.normalize(p=2)`: x / max(||x||, eps).
"""

from __future__ import annotations

import torch


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-(sample, channel) spatial standardization of an NHWC tensor."""
    xf = x.float()
    if x.dtype == torch.bfloat16:
        n = x.shape[1] * x.shape[2]
        mean = xf.sum(dim=(1, 2), keepdim=True) / n
        var = torch.clamp(
            (xf * xf).sum(dim=(1, 2), keepdim=True) / n - mean * mean,
            min=0.0)
        return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    mean = xf.mean(dim=(1, 2), keepdim=True)
    d = xf - mean
    var = (d * d).mean(dim=(1, 2), keepdim=True)
    return (d * torch.rsqrt(var + eps)).to(x.dtype)


def instance_norm_phase(x: torch.Tensor, eps: float = 1e-5,
                        groups: int = 4) -> torch.Tensor:
    """`instance_norm` of the interleaved tensor, computed in phase layout.

    Copy of the JAX package's `ops/upconv.py:instance_norm_phase`. x is
    (B, H, W, groups·C) with channel (phase * C + c): with 4 groups the
    layout of `ops/warp.py:space_to_depth(y, 2)` for an interleaved y
    (B, 2H, 2W, C), with 16 that of `ops/stemconv.py:space_to_depth(y,
    4)`; statistics reduce over space and the `groups` phase copies of
    each channel, in `instance_norm`'s two numerics forms (two-pass for
    f32, one-pass clamped for bf16).
    """
    b, h, w, cg = x.shape
    xf = x.float().reshape(b, h, w, groups, cg // groups)
    dims = (1, 2, 3)
    if x.dtype == torch.bfloat16:
        n = h * w * groups
        mean = xf.sum(dim=dims, keepdim=True) / n
        var = torch.clamp((xf * xf).sum(dim=dims, keepdim=True) / n
                          - mean * mean, min=0.0)
    else:
        mean = xf.mean(dim=dims, keepdim=True)
        d = xf - mean
        var = (d * d).mean(dim=dims, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return y.reshape(b, h, w, cg).to(x.dtype)


def instance_norm_one_pass(x: torch.Tensor, eps: float = 1e-5,
                           groups: int = 1, relu: bool = False
                           ) -> torch.Tensor:
    """Instance norm (+ relu) of x (B, H, W, groups·C) in phase layout
    with one-pass fp32 statistics whatever x's dtype: sum and sum of
    squares over space and the `groups` phase copies of each channel,
    the variance clamped at 0, relu in fp32, one rounding to x's dtype."""
    b, h, w, cg = x.shape
    xf = x.float().reshape(b, h, w, groups, cg // groups)
    n = h * w * groups
    dims = (1, 2, 3)
    mean = xf.sum(dim=dims, keepdim=True) / n
    var = torch.clamp(xf.square().sum(dim=dims, keepdim=True) / n
                      - mean * mean, min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype).reshape(b, h, w, cg)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||_2, eps) along `dim` (F.normalize semantics)."""
    norm = torch.sqrt((x * x).sum(dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)
