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

For training, `load_train_state` carries a JAX train state's trees
(generator `{img_enc, lbl_enc, dec, fuse_net}`, discriminator `{netD}`, or
`{netD, netDF}` in the pose variant,
VGG `{"params": {conv{i}}}`, and optax `scale_by_adam`'s state `{count,
mu, nu}` of each optimizer, and the step) into a port `TrainState`, and
`export_train_state` / `export_opt_states` give them back;
`train_state_dict` is the whole `TSNetTrainState` state dict, as
`flax.serialization.to_state_dict` gives it. The Adam moments map as the
parameters do (HWIO <-> OIHW); optax's `count` is each parameter's torch
Adam `step`. Both bias-correct with the count of updates taken.

The zoo's networks (`nn.generators`, `nn.discriminator`) map the same way
(`conv_in`, `down{i}`, `block{j}`, `up{i}`, `conv_out`; `conv{i}`); a
bias-free conv has no `bias` in either layout. For tensor parallelism,
`tp_split_dim` is the JAX package's `parallel/spmd.py:_param_spec` rule
by state-dict name, and `shard_flax_tree` / `gather_flax_trees` cut a
flax tree into a rank's share and put the shares back together.

The modules hold f32 parameters in every tier (a bf16 tier casts them
where it computes), so loading and exporting are exact; a tensor of any
other dtype refuses to export, since that would not give the f32 tree
back.
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
    """Flat {key: tensor} -> nested tree with HWIO kernels (numpy).
    Refuses tensors that are not float32."""
    tree: dict = {}
    for key, val in state_dict.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        if val.dtype != torch.float32:
            raise ValueError(f"{key} is {val.dtype}: only float32 tensors "
                             "export to the flax layout exactly")
        arr = val.detach().cpu().numpy()
        if leaf == "weight":
            node["kernel"] = arr.transpose(2, 3, 1, 0)
        elif leaf == "bias":
            node["bias"] = arr
        else:
            raise KeyError(f"unexpected state-dict entry {key}")
    return tree


def tp_split_dim(name: str) -> int | None:
    """The TP rule (the JAX package's `_param_spec`) for a state-dict
    name: inside any `block*`, conv1's weight and bias are split by
    out-channels (OIHW dim 0), conv2's weight by in-channels (dim 1), its
    bias replicated; None (replicated) for everything else."""
    parts = name.split(".")
    inside_block = any(p.startswith("block") for p in parts)
    if inside_block and "conv1" in parts:
        return 0
    if inside_block and "conv2" in parts:
        return 1 if parts[-1] == "weight" else None
    return None


# the flax-layout axis of an OIHW dim: HWIO kernels, (O,) biases
_FLAX_AXIS = {("kernel", 0): 3, ("kernel", 1): 2, ("bias", 0): 0}


def _tp_axes(tree: Mapping) -> dict:
    """flat state-dict name -> (path, flax axis or None) of each leaf."""
    out = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, path + (key,))
                continue
            name = ".".join(path + ("weight" if key == "kernel" else key,))
            dim = tp_split_dim(name)
            out[name] = (path + (key,), None if dim is None
                         else _FLAX_AXIS[(key, dim)])
    walk(tree, ())
    return out


def _put(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def shard_flax_tree(tree: Mapping, index: int, count: int) -> dict:
    """Rank `index`'s share (of `count`) of a flax param tree under the
    TP rule: split leaves cut into `count` equal contiguous parts along
    their axis, the rest as they are (numpy leaves)."""
    out: dict = {}
    for path, axis in _tp_axes(tree).values():
        leaf = tree
        for key in path:
            leaf = leaf[key]
        leaf = np.asarray(leaf)
        if axis is not None:
            leaf = np.split(leaf, count, axis=axis)[index]
        _put(out, path, leaf)
    return out


def gather_flax_trees(trees: list) -> dict:
    """The full flax tree from the ranks' shares (`shard_flax_tree` of
    each index, in order)."""
    out: dict = {}
    for path, axis in _tp_axes(trees[0]).values():
        leaves = []
        for t in trees:
            for key in path:
                t = t[key]
            leaves.append(np.asarray(t))
        _put(out, path, leaves[0] if axis is None
             else np.concatenate(leaves, axis=axis))
    return out


def load_flax_params(module: nn.Module, tree: Mapping) -> None:
    """Copy a flax param tree into `module` (every parameter, exactly)."""
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in flax_to_state_dict(tree).items()}
    module.load_state_dict(sd, strict=True)


def export_flax_params(module: nn.Module) -> dict:
    """The module's parameters as a flax-layout tree of numpy arrays."""
    return state_dict_to_flax(module.state_dict())


def _moments(opt: torch.optim.Adam, params: Mapping, count: int,
             mu: Mapping, nu: Mapping) -> None:
    """Set the torch Adam state of each parameter in `params` (name ->
    parameter) from optax's count and moment trees."""
    mu_sd, nu_sd = flax_to_state_dict(mu), flax_to_state_dict(nu)
    if set(mu_sd) != set(params) or set(nu_sd) != set(params):
        raise KeyError("the Adam moments do not match the parameters: "
                       f"{sorted(set(mu_sd) ^ set(params))}")
    for name, p in params.items():
        st = opt.state[p]
        st["step"] = torch.tensor(float(count), dtype=torch.float32)
        for key, tree in (("exp_avg", mu_sd), ("exp_avg_sq", nu_sd)):
            # a copy: Adam updates its moments in place, and the caller's
            # arrays may be views of JAX buffers, which must not change
            st[key] = torch.tensor(np.asarray(tree[name]), device=p.device,
                                   dtype=p.dtype)


def _opt_state(opt: torch.optim.Adam, params: Mapping) -> dict:
    """optax `ScaleByAdamState` state dict {count, mu, nu} of the torch
    Adam over `params`. optax keeps one count; torch skips a parameter
    whose gradient is None, where optax takes a zero gradient (the port's
    train step gives its unused parameters zero gradients, so they step
    with the rest). So the count is the largest step, and a parameter
    with fewer steps (or none) must have zero moments, which is what
    optax holds for it; a fresh optimizer gives zeros and count 0, as
    `optax.scale_by_adam().init` does."""
    steps = {name: int(opt.state[p]["step"].item()) if p in opt.state else 0
             for name, p in params.items()}
    count = max(steps.values())
    mu, nu = {}, {}
    for name, p in params.items():
        st = opt.state.get(p, {})
        mu[name] = st.get("exp_avg", torch.zeros_like(p))
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
        if steps[name] != count and (mu[name].any() or nu[name].any()):
            raise ValueError(
                f"{name} took {steps[name]} Adam steps of {count} with "
                "non-zero moments; optax's one count cannot carry that")
    return {"count": np.asarray(count, np.int32),
            "mu": state_dict_to_flax(mu), "nu": state_dict_to_flax(nu)}


# the discriminators' names in the flax trees and reference checkpoints
# (netDF: the pose variant's face discriminator)
DISC_SUBNETS = ("netD", "netDF")


def _split_params(state) -> tuple[dict, dict]:
    """The generator's and the discriminators' (netD, netDF) parameters by
    state-dict name."""
    gen, disc = {}, {}
    for name, p in state.mods.named_parameters():
        (disc if name.split(".")[0] in DISC_SUBNETS else gen)[name] = p
    return gen, disc


def load_train_state(state, gen_params: Mapping, disc_params: Mapping,
                     vgg_params: Mapping | None = None,
                     gen_opt_state: Mapping | None = None,
                     disc_opt_state: Mapping | None = None,
                     step=None) -> None:
    """Copy a JAX train state's trees into a port `TrainState`: every
    parameter of the modules, exactly; with `gen_opt_state` /
    `disc_opt_state` (optax `scale_by_adam` state dicts {count, mu, nu})
    the Adam moments and each parameter's step count; with `step`,
    `TrainState.step`. What is not given is left as it is."""
    load_flax_params(state.mods, {**gen_params, **disc_params})
    if vgg_params is not None:
        load_flax_params(state.vgg, vgg_params.get("params", vgg_params))
    gen, disc = _split_params(state)
    for opt, params, opt_state in ((state.gen_opt, gen, gen_opt_state),
                                   (state.disc_opt, disc, disc_opt_state)):
        if opt_state is not None:
            _moments(opt, params, int(opt_state["count"]), opt_state["mu"],
                     opt_state["nu"])
    if step is not None:
        state.step = int(step)


def export_train_state(state) -> tuple[dict, dict, dict]:
    """(gen_params, disc_params, vgg_params) of a port `TrainState` in the
    JAX package's layout, numpy leaves; disc_params is `{netD}` or, in
    the pose variant, `{netD, netDF}`."""
    tree = export_flax_params(state.mods)
    disc = {name: tree.pop(name) for name in DISC_SUBNETS if name in tree}
    return tree, disc, {"params": export_flax_params(state.vgg)}


def export_opt_states(state) -> tuple[dict, dict]:
    """(gen_opt_state, disc_opt_state) of a port `TrainState`: optax
    `scale_by_adam` state dicts {count, mu: {…}, nu: {…}}."""
    gen, disc = _split_params(state)
    return _opt_state(state.gen_opt, gen), _opt_state(state.disc_opt, disc)


def train_state_dict(state) -> dict:
    """The JAX package's `TSNetTrainState` state dict of a port
    `TrainState` (field order of `train/state.py`), numpy leaves."""
    gen, disc, vgg = export_train_state(state)
    gen_opt, disc_opt = export_opt_states(state)
    return {"step": np.asarray(state.step, np.int32), "gen_params": gen,
            "disc_params": disc, "gen_opt_state": gen_opt,
            "disc_opt_state": disc_opt, "vgg_params": vgg}


def load_train_state_dict(state, sd: Mapping) -> None:
    """Load a `TSNetTrainState` state dict (`train_state_dict`'s layout,
    as a JAX trainer snapshot holds it) into a port `TrainState`."""
    load_train_state(state, sd["gen_params"], sd["disc_params"],
                     sd.get("vgg_params"), sd["gen_opt_state"],
                     sd["disc_opt_state"], sd["step"])
