"""Carry generator weights between the JAX package and the port.

The JAX package's generator params are a nested dict (flax param tree)
whose leaves are `kernel` (HWIO) and `bias`; `jax.tree.map(np.asarray,
params)` turns it into numpy arrays. The port's modules use the same
names for their submodules, so a tree path `img_enc/block0/conv1/kernel`
is the state-dict key `img_enc.block0.conv1.weight`, with the kernel
transposed HWIO -> OIHW (as the JAX package's `compat/torch_export.py`
does for the reference checkpoint format). Works on `TSNetModules` and
on any one subnet (`Encoder`, `FuseNet`, `Decoder`, `ResnetBlock`), the
discriminator (`PatchDiscriminator`: `stage{i}`) and the perceptual
network (`VGG19Features`: `conv{i}`).

For training, `load_train_state` carries a JAX train state's three trees
(generator `{img_enc, lbl_enc, dec, fuse_net}`, discriminator `{netD}`,
VGG `{"params": {conv{i}}}`) into a port `TrainState`, and
`export_train_state` gives them back.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as nn


def flax_to_state_dict(tree: Mapping, prefix: str = "") -> dict:
    """Nested {…: {kernel, bias}} tree -> flat {key: OIHW / bias array}."""
    out = {}
    for name, val in tree.items():
        if isinstance(val, Mapping):
            out.update(flax_to_state_dict(val, f"{prefix}{name}."))
        elif name == "kernel":
            out[f"{prefix}weight"] = np.asarray(val).transpose(3, 2, 0, 1)
        elif name == "bias":
            out[f"{prefix}bias"] = np.asarray(val)
        else:
            raise KeyError(f"unexpected param leaf {prefix}{name}")
    return out


def state_dict_to_flax(state_dict: Mapping) -> dict:
    """Flat {key: tensor} -> nested tree with HWIO kernels (numpy)."""
    tree: dict = {}
    for key, val in state_dict.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        arr = val.detach().cpu().numpy()
        if leaf == "weight":
            node["kernel"] = arr.transpose(2, 3, 1, 0)
        elif leaf == "bias":
            node["bias"] = arr
        else:
            raise KeyError(f"unexpected state-dict entry {key}")
    return tree


def load_flax_params(module: nn.Module, tree: Mapping) -> None:
    """Copy a flax param tree into `module` (every parameter, exactly)."""
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in flax_to_state_dict(tree).items()}
    module.load_state_dict(sd, strict=True)


def export_flax_params(module: nn.Module) -> dict:
    """The module's parameters as a flax-layout tree of numpy arrays."""
    return state_dict_to_flax(module.state_dict())


def load_train_state(state, gen_params: Mapping, disc_params: Mapping,
                     vgg_params: Mapping | None = None) -> None:
    """Copy a JAX train state's parameter trees into a port `TrainState`
    (every parameter of the modules, exactly). The Adam moments are left
    as they are."""
    load_flax_params(state.mods, {**gen_params, **disc_params})
    if vgg_params is not None:
        load_flax_params(state.vgg, vgg_params.get("params", vgg_params))


def export_train_state(state) -> tuple[dict, dict, dict]:
    """(gen_params, disc_params, vgg_params) of a port `TrainState` in the
    JAX package's layout, numpy leaves."""
    tree = export_flax_params(state.mods)
    disc = {"netD": tree.pop("netD")}
    return tree, disc, {"params": export_flax_params(state.vgg)}
