"""SPMD train and inference wrappers: DP + TP + SP over a `Mesh`
(counterpart of the JAX package's `parallel/spmd.py`).

The JAX package annotates shardings and lets XLA insert the collectives;
here every rank runs the same program on its share and the collectives
are explicit (`parallel.mesh.Mesh`):

- **Data parallel**: the batch (and, for clip inference, the driving
  frames) is split over `data` in contiguous slices (`shard_batch`).
  Each rank runs the port's train step on its slice; before either Adam
  update the gradients are averaged over `data` (one all-reduce of the
  flattened gradients per optimizer), so every rank takes the same
  update. Each loss is a mean over samples and every norm is per sample,
  so with equal slices the mean of the ranks' means is the global mean.
  The metrics are averaged the same way and the reconstructions gathered,
  so every rank returns the global `(state, metrics, rec)`.
- **Tensor parallel**: the JAX package's rule (`_param_spec` there,
  `compat.flax_params.tp_split_dim` here): inside any `block*`, conv1 is
  split over `model` by out-channels (OIHW dim 0, and its bias), conv2
  by in-channels (dim 1; its bias replicated); everything else
  replicates. Only the ResNet-block conv pairs split: they hold most of
  the generator's FLOPs and parameters and need one all-reduce a block;
  the stem, the down/up-sample convs and the discriminators replicate.
  `shard_state` cuts the parameters and their Adam moments in place and
  marks the blocks
  (`nn.blocks.ResnetBlock` runs the split forward and backward);
  `gather_state` puts them back together. With `ring_pad` the split
  conv2 sums ring convs of the rank's channels (`conv2d_split_in`), the
  same function as under the JAX package's mesh. The gradients of every
  parameter are averaged over `data` only: the work of the ranks of one
  `model` group on a replicated tensor is the same, and so are its
  gradients.
- **Spatial parallel** (`spatial_parallel=True`): the plain path splits
  the similarity over target pixels across `model`
  (`ops.similarity.spatial_partitioning`). With kernels on, each kernel
  takes the full target-pixel axis of its data slice, as in the JAX
  package.

The kernels run per rank on the rank's slice, which is what the JAX
package's `batch_partitioning` / `shard_map` does.
"""

from __future__ import annotations

import contextlib
from typing import Mapping

import torch
import torch.nn as nn

from ..compat.flax_params import tp_split_dim
from ..models.tsnet import TSNetModules, tsnet_forward_clip
from ..nn.blocks import ResnetBlock
from ..ops.similarity import spatial_partitioning
from ..train.state import TrainState
from ..train.step import make_train_step
from .mesh import Mesh


def _names(params) -> list[str]:
    return ([n for n, _ in params.named_parameters()]
            if isinstance(params, nn.Module) else list(params))


def generator_param_shardings(params, mesh: Mesh,
                              tensor_parallel: bool = True) -> dict:
    """{parameter name: the dim split over `model`, or None} for a module
    or a state dict (the names of `TSNetModules`, as in the flax trees).
    The Adam moments follow their parameter."""
    del mesh
    return {name: tp_split_dim(name) if tensor_parallel else None
            for name in _names(params)}


def _model_axis(mesh: Mesh) -> str:
    return mesh.axis_names[1]


def _split_params(mods: nn.Module):
    """(parameter, dim) of each parameter the TP rule splits."""
    return [(p, dim) for name, p in mods.named_parameters()
            if (dim := tp_split_dim(name)) is not None]


def _mark_blocks(mods: nn.Module, value) -> None:
    for name, m in mods.named_modules():
        if isinstance(m, ResnetBlock) and name.split(".")[-1].startswith(
                "block"):
            m.tensor_parallel = value


def shard_modules(mods: nn.Module, mesh: Mesh) -> nn.Module:
    """Cut each split parameter down to this rank's `model` share, in
    place (the same `Parameter` objects), and mark the blocks."""
    axis = _model_axis(mesh)
    if mesh.size(axis) == 1:
        return mods
    with torch.no_grad():
        for p, dim in _split_params(mods):
            sl = mesh.chunk(p.shape[dim], axis)
            p.data = p.data.narrow(dim, sl.start, sl.stop - sl.start).clone()
    _mark_blocks(mods, (mesh, axis))
    return mods


def shard_state(state: TrainState, mesh: Mesh,
                tensor_parallel: bool = True) -> TrainState:
    """Place a train state on the mesh: with `tensor_parallel`, the split
    parameters and their Adam moments cut to this rank's share, in place.
    Replicated parameters stay as they are (every rank starts from the
    same state)."""
    axis = _model_axis(mesh)
    if not tensor_parallel or mesh.size(axis) == 1:
        return state
    with torch.no_grad():
        for p, dim in _split_params(state.mods):
            sl = mesh.chunk(p.shape[dim], axis)
            for opt in (state.gen_opt, state.disc_opt):
                st = opt.state.get(p, {})
                for key in ("exp_avg", "exp_avg_sq"):
                    if key in st:
                        st[key] = st[key].narrow(
                            dim, sl.start, sl.stop - sl.start).clone()
    shard_modules(state.mods, mesh)
    return state


def gather_modules(mods: nn.Module, mesh: Mesh) -> nn.Module:
    """Undo `shard_modules` in place: each split parameter (and its
    gradient, where it has one) gathered over `model`."""
    axis = _model_axis(mesh)
    if mesh.size(axis) == 1:
        return mods
    with torch.no_grad():
        for p, dim in _split_params(mods):
            grad = p.grad
            p.data = mesh.all_gather(p.data, axis, dim)
            if grad is not None:
                p.grad = mesh.all_gather(grad, axis, dim)
    _mark_blocks(mods, None)
    return mods


def gather_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Undo `shard_state` in place: the full parameters, gradients and
    Adam moments on every rank, for checkpoints and comparisons."""
    axis = _model_axis(mesh)
    if mesh.size(axis) == 1:
        return state
    with torch.no_grad():
        for p, dim in _split_params(state.mods):
            for opt in (state.gen_opt, state.disc_opt):
                st = opt.state.get(p, {})
                for key in ("exp_avg", "exp_avg_sq"):
                    if key in st:
                        st[key] = mesh.all_gather(st[key], axis, dim)
    gather_modules(state.mods, mesh)
    return state


def shard_batch(batch: Mapping, mesh: Mesh) -> dict:
    """This rank's contiguous slice of each array along axis 0, in `data`
    order; refuses a batch that the `data` size does not divide (the JAX
    package needs the same)."""
    axis = mesh.axis_names[0]
    return {k: v[mesh.chunk(len(v), axis)] for k, v in batch.items()}


def _spatial(mesh: Mesh, on: bool):
    if on:
        return spatial_partitioning(mesh, _model_axis(mesh))
    return contextlib.nullcontext()


def make_parallel_train_step(state: TrainState, mesh: Mesh,
                             spatial_parallel: bool = True, **kwargs):
    """DP(+TP+SP) train step: `step(state, local_batch, lr) -> (state,
    metrics, rec)` with `local_batch = shard_batch(batch, mesh)` and the
    state placed by `shard_state`; returns the global metrics (means over
    `data`) and rec (B, H, W, 3), the slices gathered in `data` order.
    `kwargs` go to `train.step.make_train_step`. `spatial_parallel`
    affects only the plain path (`use_kernels=False`)."""
    data = mesh.axis_names[0]

    def average_grads(opt: torch.optim.Optimizer) -> None:
        grads = [p.grad for group in opt.param_groups
                 for p in group["params"] if p.grad is not None]
        flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                               data, average=True)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    inner = make_train_step(state, grad_hook=average_grads, **kwargs)

    def step(state: TrainState, batch: Mapping, lr: float):
        with _spatial(mesh, spatial_parallel):
            state, metrics, rec = inner(state, batch, lr)
        names = list(metrics)
        means = mesh.all_reduce(torch.stack([metrics[k].float()
                                             for k in names]), data,
                                average=True)
        return (state, dict(zip(names, means.unbind())),
                mesh.all_gather(rec, data, 0))

    return step


def make_parallel_clip_infer(mods: TSNetModules, mesh: Mesh,
                             use_kernels: bool = False,
                             spatial_parallel: bool = False,
                             fused_blocks: bool = False):
    """Clip inference with the driving frames split over `data`:
    `run(src_img, src_lbl, src_bbox, tar_lbl, tar_bbox) -> (F, H, W, 3)`.

    The sources stay whole on every rank (each rank encodes them); each
    rank decodes its contiguous share of the F frames through
    `tsnet_forward_clip` (F must split evenly over `data`), and the
    frames are gathered back in order on every rank. `mods` may be TP
    (`shard_modules`); `fused_blocks` as in `tsnet_forward_clip`.
    """
    data = mesh.axis_names[0]

    def run(src_img, src_lbl, src_bbox, tar_lbl, tar_bbox) -> torch.Tensor:
        rows = mesh.chunk(len(tar_lbl), data)
        with _spatial(mesh, spatial_parallel):
            out = tsnet_forward_clip(mods, src_img, src_lbl, src_bbox,
                                     tar_lbl[rows], tar_bbox[rows],
                                     use_kernels=use_kernels,
                                     device=mods.device,
                                     fused_blocks=fused_blocks)
        return mesh.all_gather(out, data, 0)

    return run
