"""GAN objectives (counterpart of the JAX package's `losses/gan.py`).

TS-Net trains with the lsgan objective (MSE to 1/0 targets) and a
feature-matching L1 over the PatchGAN's intermediate activations; the
zoo adds the WGAN-GP penalty.
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


def gradient_penalty(disc, real: torch.Tensor, fake: torch.Tensor,
                     alpha=None, kind: str = "mixed", constant: float = 1.0,
                     lambda_gp: float = 10.0) -> torch.Tensor:
    """WGAN-GP penalty (the reference's `cal_gradient_penalty`): the mean
    over samples of (||d disc(x_i) / d x_i||_2 - constant)², times
    lambda_gp, at x = real, fake, or (kind="mixed") alpha_i real_i +
    (1 - alpha_i) fake_i, differentiable in disc's parameters.

    `alpha`: a tensor of one weight a sample, or a `torch.Generator` (the
    weights drawn uniform from it on the CPU), or None (the global RNG).
    `disc(x)` returns a tensor; its sum is differentiated.

    The JAX package takes each sample's gradient alone
    (`vmap(grad(...))` over x[i][None]). One gradient of the sum over the
    batch is the same: disc(x_j) does not depend on x_i for j != i, since
    no layer of the zoo's discriminators mixes samples (instance norm
    only; `get_norm_layer` refuses batch norm).
    """
    if lambda_gp <= 0.0:
        return torch.zeros((), device=real.device)
    if kind == "real":
        x = real
    elif kind == "fake":
        x = fake
    elif kind == "mixed":
        if alpha is None or isinstance(alpha, torch.Generator):
            alpha = torch.rand(real.shape[0], generator=alpha)
        a = torch.as_tensor(alpha, dtype=real.dtype).to(real.device)
        a = a.reshape((real.shape[0],) + (1,) * (real.dim() - 1))
        x = a * real + (1.0 - a) * fake
    else:
        raise NotImplementedError(f"{kind} not implemented")
    x = x.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(disc(x).sum(), x, create_graph=True)
    flat = grads.reshape(x.shape[0], -1) + 1e-16
    norms = flat.square().sum(dim=1).sqrt()
    return (norms - constant).square().mean() * lambda_gp
