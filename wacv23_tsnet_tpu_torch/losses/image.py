"""Image-space losses (counterpart of the JAX package's `losses/image.py`).

NHWC tensors; every loss is computed in fp32.
"""

from __future__ import annotations

import torch


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).abs().mean()


def gradient_loss(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """L1 between |finite differences| of fake and real, horizontal plus
    vertical."""
    fx = fake[:, :, :-1] - fake[:, :, 1:]
    fy = fake[:, :-1] - fake[:, 1:]
    rx = real[:, :, :-1] - real[:, :, 1:]
    ry = real[:, :-1] - real[:, 1:]
    return l1_loss(rx.abs(), fx.abs()) + l1_loss(ry.abs(), fy.abs())


def cosine_align_loss(prop_fea: torch.Tensor, syn_fea: torch.Tensor,
                      eps: float = 1e-8) -> torch.Tensor:
    """1 - mean cosine similarity over the channel axis, with torch's
    `F.cosine_similarity` clamp of the norm product at `eps`."""
    a = prop_fea.float()
    b = syn_fea.float()
    dot = (a * b).sum(dim=-1)
    na = (a * a).sum(dim=-1).sqrt()
    nb = (b * b).sum(dim=-1).sqrt()
    return 1.0 - (dot / torch.clamp(na * nb, min=eps)).mean()


def renorm_to_reference(img: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Shift and scale `img` per (sample, channel) to `ref`'s mean and
    std over all pixels. The std is torch's unbiased one (ddof=1), as the
    torch reference computes it."""
    def stats(x):
        flat = x.float().reshape(x.shape[0], -1, x.shape[-1])
        mean = flat.mean(dim=1)
        std = flat.var(dim=1, correction=1).sqrt()
        return mean[:, None, None, :], std[:, None, None, :]

    gen_mean, gen_std = stats(img)
    ref_mean, ref_std = stats(ref)
    return (img - gen_mean) / gen_std * ref_std + ref_mean
