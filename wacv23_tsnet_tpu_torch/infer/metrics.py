"""Evaluation metrics (counterpart of the JAX package's
`infer/metrics.py`): L1, PSNR, SSIM, the average keypoint distance and a
VGG feature distance, on tensors, so they run where the images are.

Images are (B, H, W, C) in [0, max_val]. The reference ships no metric
code; these are the self-contained ones the paper reports.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.precision import tf32


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


def psnr(a: torch.Tensor, b: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    mse = (a - b).square().mean()
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (
        size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM over (B, H, W, C) images (11x11 Gaussian, sigma 1.5)."""
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    kernel = _gaussian_kernel(device=a.device)[None, None]

    def filt(x):
        bsz, h, w, c = x.shape
        x = x.permute(0, 3, 1, 2).reshape(bsz * c, 1, h, w).float()
        # fp32 with TF32 off: sigma = E[x^2] - E[x]^2 cancels, and a
        # low-precision window conv throws SSIM far outside [-1, 1]
        with tf32(False):
            y = F.conv2d(x, kernel)
        oh, ow = y.shape[2:]
        return y.reshape(bsz, c, oh, ow).permute(0, 2, 3, 1)

    mu_a = filt(a)
    mu_b = filt(b)
    sigma_a = filt(a * a) - mu_a * mu_a
    sigma_b = filt(b * b) - mu_b * mu_b
    sigma_ab = filt(a * b) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * sigma_ab + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (sigma_a + sigma_b + c2)
    return (num / den).mean()


def average_keypoint_distance(pred_kp: torch.Tensor,
                              true_kp: torch.Tensor) -> torch.Tensor:
    """AKD over (..., K, 2) keypoints; points at (0, 0) in either set are
    invalid and skipped."""
    valid = (true_kp != 0).all(dim=-1) & (pred_kp != 0).all(dim=-1)
    d = torch.linalg.norm(pred_kp - true_kp, dim=-1)
    return torch.where(valid, d, torch.zeros_like(d)).sum() / torch.clamp(
        valid.sum(), min=1)


def vgg_feature_distance(vgg, a: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """LPIPS-style distance: mean squared difference of the unit-normalized
    VGG19 activations (`nn.vgg.VGG19Features`) at its five taps."""
    total = 0.0
    for xa, xb in zip(vgg(a), vgg(b)):
        na = xa / torch.clamp(torch.linalg.norm(xa, dim=-1, keepdim=True),
                              min=1e-10)
        nb = xb / torch.clamp(torch.linalg.norm(xb, dim=-1, keepdim=True),
                              min=1e-10)
        total = total + (na - nb).square().mean()
    return total / 5.0
