"""Multi-device training and clip inference over `torch.distributed`
(counterpart of the JAX package's `parallel/`): a 2-D mesh of ranks
(`data`, `model`) and DP + TP + SP wrappers of the train step and the
clip forward."""

from .launch import init_distributed, spawn_ranks
from .mesh import Mesh, make_mesh
from .spmd import (gather_state, generator_param_shardings,
                   make_parallel_clip_infer, make_parallel_train_step,
                   shard_batch, shard_modules, shard_state)

__all__ = ["init_distributed", "spawn_ranks", "Mesh", "make_mesh",
           "gather_state", "generator_param_shardings",
           "make_parallel_clip_infer", "make_parallel_train_step",
           "shard_batch", "shard_modules", "shard_state"]
