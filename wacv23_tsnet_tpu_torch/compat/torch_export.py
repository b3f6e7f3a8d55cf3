"""Flax-layout generator tree -> reference `.pth` checkpoint (the port's
own copy of the JAX package's `compat/torch_export.py`).

The inverse of `torch_import`: the flat `{example, img_enc, lbl_enc, dec,
fuse_net[, netD][, netDF]}` dict of positional-`Sequential` state dicts that the
reference trainers save, so weights held by the port load into the
PyTorch reference, and into the JAX package, unchanged.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .flax_params import DISC_SUBNETS


def _conv_sd(out: dict, key: str, conv: Mapping) -> None:
    out[f"{key}.weight"] = np.asarray(conv["kernel"]).transpose(3, 2, 0, 1)
    out[f"{key}.bias"] = np.asarray(conv["bias"])


def _resblock_sd(out: dict, key: str, block: Mapping) -> None:
    _conv_sd(out, f"{key}.conv_block.1", block["conv1"])
    _conv_sd(out, f"{key}.conv_block.5", block["conv2"])


def encoder_state_dict(params: Mapping, n_downsampling: int,
                       n_blocks: int) -> dict:
    sd: dict = {}
    _conv_sd(sd, "model.1", params["conv_in"])
    for i in range(n_downsampling):
        _conv_sd(sd, f"model.{4 + 3 * i}", params[f"down{i}"])
    base = 4 + 3 * n_downsampling
    for j in range(n_blocks):
        _resblock_sd(sd, f"model.{base + j}", params[f"block{j}"])
    return sd


def decoder_state_dict(params: Mapping, n_downsampling: int,
                       n_blocks: int) -> dict:
    sd: dict = {}
    _conv_sd(sd, "map_conv", params["map_conv"])
    for j in range(n_blocks):
        _resblock_sd(sd, f"model{j}.0", params[f"block{j}"])
    for i in range(n_downsampling):
        _conv_sd(sd, f"model{n_blocks + i}.2", params[f"up{i}"])
    _conv_sd(sd, f"model{n_blocks + n_downsampling}.1", params["conv_out"])
    return sd


def fusenet_state_dict(params: Mapping, n_blocks: int = 1) -> dict:
    sd: dict = {}
    for j in range(n_blocks):
        _resblock_sd(sd, f"model.{j}", params[f"block{j}"])
    _conv_sd(sd, "conv", params["conv"])
    return sd


def discriminator_state_dict(params: Mapping, n_layers: int = 3) -> dict:
    sd: dict = {}
    for n in range(n_layers + 2):
        _conv_sd(sd, f"model{n}.0", params[f"stage{n}"])
    return sd


def reference_checkpoint(gen_params: Mapping, cfg, example: int = 0,
                         disc_params: Mapping | None = None) -> dict:
    """The reference-format dict (numpy leaves) of a generator tree and,
    where given, `{netD: …, netDF: …}` (either may be left out)."""
    ckpt = {
        "example": int(example),
        "img_enc": encoder_state_dict(gen_params["img_enc"],
                                      cfg.n_downsampling, cfg.enc_n_blocks),
        "lbl_enc": encoder_state_dict(gen_params["lbl_enc"],
                                      cfg.n_downsampling, 0),
        "dec": decoder_state_dict(gen_params["dec"], cfg.n_downsampling,
                                  cfg.dec_n_blocks),
        "fuse_net": fusenet_state_dict(gen_params["fuse_net"]),
    }
    for name in DISC_SUBNETS:
        if disc_params and name in disc_params:
            ckpt[name] = discriminator_state_dict(disc_params[name],
                                                  cfg.d_n_layers)
    return ckpt


def save_reference_checkpoint(path: str, gen_params: Mapping, cfg,
                              example: int = 0,
                              disc_params: Mapping | None = None) -> None:
    """`torch.save` the reference-format dict, CPU tensors."""
    ckpt = {k: ({kk: torch.from_numpy(np.ascontiguousarray(vv))
                 for kk, vv in v.items()} if isinstance(v, dict) else v)
            for k, v in reference_checkpoint(gen_params, cfg, example,
                                             disc_params).items()}
    torch.save(ckpt, path)
