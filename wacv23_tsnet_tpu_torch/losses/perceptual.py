"""VGG19 perceptual loss (counterpart of the JAX package's
`losses/perceptual.py`): weighted L1 over the relu{1..5}_1 activations,
weights 1/32, 1/16, 1/8, 1/4, 1. The caller detaches the real branch."""

from __future__ import annotations

import torch

VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def vgg_perceptual_loss(vgg, fake: torch.Tensor,
                        real: torch.Tensor) -> torch.Tensor:
    loss = 0.0
    for w, f, r in zip(VGG_WEIGHTS, vgg(fake), vgg(real)):
        loss = loss + w * (f.float() - r.float()).abs().mean()
    return loss
