"""GAN objectives (counterpart of the JAX package's `losses/gan.py`).

TS-Net trains with the lsgan objective (MSE to 1/0 targets) and a
feature-matching L1 over the PatchGAN's intermediate activations. The
WGAN-GP penalty is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def lsgan_loss(pred: torch.Tensor, target_is_real: bool) -> torch.Tensor:
    """MSE of the patch logit map against a 1.0 / 0.0 target."""
    target = 1.0 if target_is_real else 0.0
    return (pred.float() - target).square().mean()


def gan_loss(pred: torch.Tensor, target_is_real: bool,
             mode: str = "lsgan") -> torch.Tensor:
    """lsgan (MSE), vanilla (BCE with logits) or wgangp (mean)."""
    pred = pred.float()
    if mode == "lsgan":
        return lsgan_loss(pred, target_is_real)
    if mode == "vanilla":
        target = torch.full_like(pred, 1.0 if target_is_real else 0.0)
        return F.binary_cross_entropy_with_logits(pred, target)
    if mode == "wgangp":
        return -pred.mean() if target_is_real else pred.mean()
    raise NotImplementedError(f"gan mode {mode} not implemented")


def feature_matching_loss(fake_feats, real_feats,
                          weight: float) -> torch.Tensor:
    """Sum over the intermediate D features (not the logit) of `weight`
    times their L1. The caller passes real features already detached."""
    loss = 0.0
    for f, r in zip(fake_feats[:-1], real_feats[:-1]):
        loss = loss + weight * (f.float() - r.float()).abs().mean()
    return loss
