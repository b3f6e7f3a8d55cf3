"""Reference `.pth` checkpoint -> flax-layout generator tree (the port's
own copy of the JAX package's `compat/torch_import.py`).

The reference trainers save a flat dict of per-subnet state dicts
(`{example, img_enc, lbl_enc, dec, fuse_net[, netD][, netDF]}`; netDF is
the pose variant's face discriminator) whose keys are
positional `Sequential` indices. The position tables below map them onto
the named flax tree, which `compat.flax_params.load_flax_params` then
maps onto the port's named modules:

- Encoder: `model.1` the stem conv, `model.{4+3i}` down conv i,
  `model.{4+3*nd+j}.conv_block.{1,5}` ResNet block j's convs.
- Decoder: `map_conv`, `model{j}.0.conv_block.{1,5}` the blocks,
  `model{nb+i}.2` the upsample convs, `model{nb+nd}.1` the final 7x7.
- FuseNet: `model.{j}.conv_block.{1,5}`, `conv`.
- PatchGAN discriminator: `model{n}.0`, the five stage convs.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .flax_params import DISC_SUBNETS


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _conv(sd: Mapping, key: str) -> dict:
    return {"kernel": _np(sd[f"{key}.weight"]).transpose(2, 3, 1, 0),
            "bias": _np(sd[f"{key}.bias"])}


def _resblock(sd: Mapping, key: str) -> dict:
    return {"conv1": _conv(sd, f"{key}.conv_block.1"),
            "conv2": _conv(sd, f"{key}.conv_block.5")}


def encoder_params_from_torch(sd: Mapping, n_downsampling: int,
                              n_blocks: int) -> dict:
    params = {"conv_in": _conv(sd, "model.1")}
    for i in range(n_downsampling):
        params[f"down{i}"] = _conv(sd, f"model.{4 + 3 * i}")
    base = 4 + 3 * n_downsampling
    for j in range(n_blocks):
        params[f"block{j}"] = _resblock(sd, f"model.{base + j}")
    return params


def decoder_params_from_torch(sd: Mapping, n_downsampling: int,
                              n_blocks: int) -> dict:
    params = {"map_conv": _conv(sd, "map_conv")}
    for j in range(n_blocks):
        params[f"block{j}"] = _resblock(sd, f"model{j}.0")
    for i in range(n_downsampling):
        params[f"up{i}"] = _conv(sd, f"model{n_blocks + i}.2")
    params["conv_out"] = _conv(sd, f"model{n_blocks + n_downsampling}.1")
    return params


def fusenet_params_from_torch(sd: Mapping, n_blocks: int = 1) -> dict:
    params = {f"block{j}": _resblock(sd, f"model.{j}")
              for j in range(n_blocks)}
    params["conv"] = _conv(sd, "conv")
    return params


def discriminator_params_from_torch(sd: Mapping, n_layers: int = 3) -> dict:
    return {f"stage{n}": _conv(sd, f"model{n}.0")
            for n in range(n_layers + 2)}


def generator_params_from_checkpoint(ckpt: Mapping, cfg) -> dict:
    """The four generator subnets of a reference checkpoint (the loaded
    dict) as a flax-layout tree of numpy arrays."""
    return {
        "img_enc": encoder_params_from_torch(
            ckpt["img_enc"], cfg.n_downsampling, cfg.enc_n_blocks),
        "lbl_enc": encoder_params_from_torch(
            ckpt["lbl_enc"], cfg.n_downsampling, 0),
        "dec": decoder_params_from_torch(
            ckpt["dec"], cfg.n_downsampling, cfg.dec_n_blocks),
        "fuse_net": fusenet_params_from_torch(ckpt["fuse_net"]),
    }


def load_reference_checkpoint(path: str, cfg,
                              include_discriminators: bool = False
                              ) -> tuple[dict, int]:
    """(generator tree[, with `netD` and `netDF` where the file has
    them], example count) of a reference `.pth`; loads tensors only
    (`weights_only=True`)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    params = generator_params_from_checkpoint(ckpt, cfg)
    if include_discriminators:
        for name in DISC_SUBNETS:
            if name in ckpt:
                params[name] = discriminator_params_from_torch(
                    ckpt[name], cfg.d_n_layers)
    return params, int(ckpt.get("example", 0))
