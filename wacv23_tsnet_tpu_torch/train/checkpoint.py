"""Checkpoint save/restore in the JAX package's format (counterpart of
its `train/checkpoint.py`), without JAX.

A checkpoint is flax msgpack (`compat.flax_msgpack`). A trainer snapshot
is the `TSNetTrainState` state dict: parameters, both optimizers' Adam
moments and counts, the step and the VGG19 weights, so resume is exact.
A generator file holds the tree `{img_enc, lbl_enc, dec, fuse_net}`.
Files written here restore in the JAX package with its
`restore_checkpoint(path, template)`, and the JAX package's files
restore here.
"""

from __future__ import annotations

import os
from typing import Mapping

import torch.nn as nn

from ..compat import flax_msgpack
from ..compat.flax_params import (export_flax_params, load_flax_params,
                                  load_train_state_dict, train_state_dict)
from .state import GEN_SUBNETS, TrainState


def _state_dict(target):
    if isinstance(target, TrainState):
        return train_state_dict(target)
    if isinstance(target, Mapping):
        return target
    raise TypeError(f"cannot save a {type(target).__name__}: pass a "
                    "TrainState or a state-dict tree")


def save_checkpoint(path: str, target) -> None:
    """Write `target` (a `TrainState`, or a tree of numpy leaves) to
    `path` atomically: through `path + ".tmp"` and `os.replace`."""
    sd = _state_dict(target)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        flax_msgpack.dump(sd, f)
    os.replace(tmp, path)


def restore_checkpoint(path: str, template=None):
    """The checkpoint at `path`, restored into `template`:

    - a `TrainState`: parameters, moments, step counts and step loaded
      in place, and returned;
    - an `nn.Module` with the generator subnets (`TSNetModules`): the
      generator tree loaded (from a trainer snapshot, its `gen_params`),
      and returned;
    - None: the file's tree (numpy leaves).
    """
    tree = flax_msgpack.load(path)
    if template is None:
        return tree
    if isinstance(template, TrainState):
        load_train_state_dict(template, tree)
    elif isinstance(template, nn.Module):
        load_flax_params(template, generator_tree(tree))
    else:
        raise TypeError(f"cannot restore into a {type(template).__name__}")
    return template


def generator_tree(tree: Mapping) -> dict:
    """The generator subnets of a generator file's tree or of a trainer
    snapshot's (its `gen_params`)."""
    if "gen_params" in tree:
        tree = tree["gen_params"]
    return {name: tree[name] for name in GEN_SUBNETS}


def find_latest_checkpoint(snapshot_dir: str,
                           prefix: str = "TSNet_S") -> str | None:
    """The last `prefix*.msgpack` in `snapshot_dir` by name, or None."""
    if not os.path.isdir(snapshot_dir):
        return None
    snaps = sorted(f for f in os.listdir(snapshot_dir)
                   if f.startswith(prefix) and f.endswith(".msgpack"))
    return os.path.join(snapshot_dir, snaps[-1]) if snaps else None


def save_generator_params(path: str, gen_params) -> None:
    """Inference-only export: the four generator subnets, from a tree or
    from the modules (`TSNetModules`, f32 parameters)."""
    if isinstance(gen_params, nn.Module):
        tree = export_flax_params(gen_params)
        gen_params = {name: tree[name] for name in GEN_SUBNETS}
    save_checkpoint(path, gen_params)


def restore_generator_params(path: str, template=None):
    """A generator file (or a trainer snapshot's generator): loaded into
    `template` (`TSNetModules`) and returned, or with no template its
    tree."""
    if template is not None:
        return restore_checkpoint(path, template)
    return generator_tree(flax_msgpack.load(path))
