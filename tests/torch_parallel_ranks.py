"""Rank programs of tests/test_torch_parallel.py.

Each runs in a process of its own, spawned by
`wacv23_tsnet_tpu_torch.parallel.spawn_ranks`: one thread, a gloo group
over a `FileStore` in the test's temporary directory, the port on the
CPU. They import no JAX (a rank starts from a fresh interpreter), and
each returns numpy results for the test to hold against its references.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from wacv23_tsnet_tpu_torch.compat import load_flax_params, load_train_state
from wacv23_tsnet_tpu_torch.configs import toy_config, toy_pose_config
from wacv23_tsnet_tpu_torch.models import TSNetModules
from wacv23_tsnet_tpu_torch.parallel import (gather_state,
                                             generator_param_shardings,
                                             init_distributed,
                                             make_mesh,
                                             make_parallel_clip_infer,
                                             make_parallel_train_step,
                                             shard_batch, shard_modules,
                                             shard_state)
from wacv23_tsnet_tpu_torch.parallel.spmd import gather_modules
from wacv23_tsnet_tpu_torch.train import create_train_state

LR = 2e-4
FUSE_ENV = "TSNET_FUSE_PAIR_KERNEL"


def join(rank: int, world: int, store: str, model_parallel: int):
    torch.set_num_threads(1)
    init_distributed(rank, world, f"file://{store}", device="cpu")
    return make_mesh(model_parallel=model_parallel)


def grads(mods) -> dict:
    """name -> gradient (zeros where the loss does not reach)."""
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)
                ).numpy().copy() for n, p in mods.named_parameters()}


def step_result(state, metrics, rec, mesh) -> dict:
    return {"step": state.step,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "rec": rec.numpy(), "grads": grads(state.mods),
            "calls": {"/".join(k): v for k, v in mesh.calls.items()}}


def dp_ranks(rank, world, store, gen_tree, train_trees, clip_args, batch):
    """(4, 1): the clip with kernels off and on, one face train step."""
    mesh = join(rank, world, store, 1)
    out = {}
    mods = TSNetModules(toy_config(), device="cpu")
    load_flax_params(mods, gen_tree)
    for use_kernels in (False, True):
        run = make_parallel_clip_infer(mods, mesh, use_kernels=use_kernels)
        out[f"clip_kernels_{use_kernels}"] = run(*clip_args).numpy()
    state = create_train_state(toy_config(), device="cpu", seed=3)
    load_train_state(state, *train_trees)
    step = make_parallel_train_step(state, mesh, spatial_parallel=False,
                                    use_kernels=False)
    state, metrics, rec = step(state, shard_batch(batch, mesh), LR)
    out.update(step_result(state, metrics, rec, mesh))
    return out


def tp_ranks(rank, world, store, gen_tree, clip_args, batches):
    """(2, 2): the TP+SP clip, the sharding rule, `bench+fused` under TP,
    one DP+TP+SP train step for face and for the toy pose config."""
    mesh = join(rank, world, store, 2)
    out = {}
    mods = TSNetModules(toy_config(), device="cpu")
    load_flax_params(mods, gen_tree)
    full = {n: p.detach().clone() for n, p in mods.named_parameters()}
    shard_modules(mods, mesh)
    # the rule: each split parameter is this rank's share of the full one
    rule = generator_param_shardings(mods, mesh)
    shares = {}
    for n, p in mods.named_parameters():
        dim = rule[n]
        want = full[n] if dim is None else full[n].chunk(2, dim)[
            mesh.index("model")]
        shares[n] = bool(torch.equal(p.detach(), want))
    out["rule"], out["shares"] = rule, shares
    run = make_parallel_clip_infer(mods, mesh, spatial_parallel=True)
    out["clip_tp_sp"] = run(*clip_args).numpy()

    bench = dataclasses.replace(toy_config(), precision="high",
                                fast_tail=True, fast_trunk=True)
    fused = TSNetModules(bench, device="cpu")
    load_flax_params(fused, gen_tree)
    shard_modules(fused, mesh)
    os.environ[FUSE_ENV] = "1"
    try:
        run = make_parallel_clip_infer(fused, mesh, use_kernels=True,
                                       fused_blocks=True)
        out["clip_fused_tp"] = run(*clip_args).numpy()
    finally:
        del os.environ[FUSE_ENV]
    gather_modules(fused, mesh)
    out["fused_gathered_equal"] = all(
        torch.equal(p.detach(), full[n]) for n, p in fused.named_parameters())

    for name, cfg in (("face", toy_config()), ("pose", toy_pose_config())):
        state = create_train_state(cfg, device="cpu", seed=0)
        shard_state(state, mesh)
        step = make_parallel_train_step(state, mesh, spatial_parallel=True,
                                        use_kernels=False)
        state, metrics, rec = step(state, shard_batch(batches[name], mesh),
                                   LR)
        gather_state(state, mesh)
        out[name] = step_result(state, metrics, rec, mesh)
    return out


def dp_kernel_ranks(rank, world, store, batch):
    """(2, 1): one face train step on the kernel path (its plain versions
    on the CPU) with TP asked for on a mesh without a model axis."""
    mesh = join(rank, world, store, 1)
    state = create_train_state(toy_config(), device="cpu", seed=0)
    shard_state(state, mesh)
    step = make_parallel_train_step(state, mesh, use_kernels=True)
    state, metrics, rec = step(state, shard_batch(batch, mesh), LR)
    out = step_result(state, metrics, rec, mesh)
    try:
        shard_batch({"x": np.zeros((3, 1))}, mesh)
    except ValueError as e:
        out["uneven"] = str(e)
    for n, mp in ((4, 1), (2, 3)):
        try:
            make_mesh(n, model_parallel=mp)
        except ValueError as e:
            out[f"refused_{n}_{mp}"] = str(e)
    return out
