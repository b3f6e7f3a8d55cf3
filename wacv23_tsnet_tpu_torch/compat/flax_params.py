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
(generator `{img_enc, lbl_enc, dec, fuse_net}`, discriminator `{netD}`,
VGG `{"params": {conv{i}}}`, and optax `scale_by_adam`'s state `{count,
mu, nu}` of each optimizer, and the step) into a port `TrainState`, and
`export_train_state` / `export_opt_states` give them back;
`train_state_dict` is the whole `TSNetTrainState` state dict, as
`flax.serialization.to_state_dict` gives it. The Adam moments map as the
parameters do (HWIO <-> OIHW); optax's `count` is each parameter's torch
Adam `step`. Both bias-correct with the count of updates taken.

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
    whose gradient is None (FuseNet's conv2 bias, which the instance norm
    after it cancels, never has one), where optax takes a zero gradient
    and keeps zero moments. So the count is the largest step, and a
    parameter with fewer steps (or none) must have zero moments, which
    is what optax holds for it; a fresh optimizer gives zeros and count
    0, as `optax.scale_by_adam().init` does."""
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


def _split_params(state) -> tuple[dict, dict]:
    """The generator's and netD's parameters by state-dict name."""
    gen, disc = {}, {}
    for name, p in state.mods.named_parameters():
        (disc if name.startswith("netD.") else gen)[name] = p
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
    JAX package's layout, numpy leaves."""
    tree = export_flax_params(state.mods)
    disc = {"netD": tree.pop("netD")}
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
