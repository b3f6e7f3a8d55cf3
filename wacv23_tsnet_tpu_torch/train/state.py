"""Training state: the modules, the frozen VGG19 and the two Adams
(counterpart of the JAX package's `train/state.py`).

The torch reference keeps one Adam per subnet with per-subnet learning
rates. Adam's moments are elementwise, so one `torch.optim.Adam` for the
generator with a param group per subnet (`img_enc`, `lbl_enc`,
`fuse_net`, `dec`) and one for the discriminator compute the same
updates; `train.step` sets each group's lr every step. The
discriminator's Adam has a group `netD` and, in the pose variant, a group
`netDF` (one optax Adam spans both in the JAX package). Betas (0.5, 0.999)
and eps 1e-8, as in the reference; the moments carry no lr, as optax's
`scale_by_adam` does not.
"""

from __future__ import annotations

import dataclasses

import torch

from ..compat.flax_params import load_flax_params
from ..configs import TSNetConfig
from ..device import resolve_device
from ..models.tsnet import GEN_SUBNETS, TSNetModules, disc_subnets
from ..nn.vgg import VGG19Features, load_vgg19_npz


@dataclasses.dataclass
class TrainState:
    mods: TSNetModules          # generator subnets, netD[, netDF]; grads on
    vgg: VGG19Features          # perceptual-loss network, frozen
    gen_opt: torch.optim.Adam   # one param group per generator subnet
    disc_opt: torch.optim.Adam  # one param group per discriminator
    step: int = 0


def create_train_state(cfg: TSNetConfig, device="cuda", seed: int = 0,
                       vgg_params=None, beta1: float = 0.5,
                       beta2: float = 0.999, eps: float = 1e-8) -> TrainState:
    """Seeded modules (generator from `seed`, netD from `seed + 1`,
    netDF from `seed + 3`), the
    VGG19 from `vgg_params` (a flax-layout tree), else from
    `weights/vgg19_features.npz`, else a seeded random init (`seed + 2`),
    and fresh Adam moments. Runs on the GPU unless `device="cpu"`."""
    dev = resolve_device(device)
    mods = TSNetModules(cfg, device=dev, seed=seed, train=True)
    vgg = VGG19Features(dtype=mods.dtype, precision=cfg.precision)
    tree = vgg_params if vgg_params is not None else load_vgg19_npz()
    if tree is not None:
        load_flax_params(vgg, tree.get("params", tree))
    else:
        vgg.reset_parameters(torch.Generator().manual_seed(seed + 2))
    vgg.requires_grad_(False)
    vgg.to(dev)
    kw = dict(betas=(beta1, beta2), eps=eps)
    gen_opt = torch.optim.Adam(
        [{"params": list(getattr(mods, name).parameters()), "name": name}
         for name in GEN_SUBNETS], **kw)
    disc_opt = torch.optim.Adam(
        [{"params": list(getattr(mods, name).parameters()), "name": name}
         for name in disc_subnets(cfg)], **kw)
    return TrainState(mods, vgg, gen_opt, disc_opt)
