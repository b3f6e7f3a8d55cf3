"""A 2-D layout of `torch.distributed` ranks (counterpart of the JAX
package's `parallel/mesh.py:make_mesh`).

The JAX package builds a `jax.sharding.Mesh` of devices with a `data` axis
(batch parallelism) and a `model` axis (tensor and spatial parallelism),
and XLA inserts the collectives. Here the ranks of an initialised process
group are laid out as an (n / model_parallel, model_parallel) grid, rank
r at row r // model_parallel and column r % model_parallel; a rank's
`data` group is its column (the ranks that hold the same model shard) and
its `model` group its row (the ranks that share one data slice). The
collectives are explicit, as methods of the `Mesh`:

- `all_reduce`, `all_gather`: plain collectives over one axis;
- `copy_to(x, axis)`: the identity forward, an all-reduce (sum) of the
  gradient backward: where a replicated tensor enters work split over
  `axis`;
- `reduce_from(x, axis)`: an all-reduce (sum) forward, the identity
  backward: where partial sums over `axis` become the replicated tensor;
- `gather_from(x, axis, dim)`: an all-gather along `dim` forward, the
  rank's own slice of the gradient backward: where each rank's rows
  become the replicated tensor.

The backward rules hold because the work downstream of a replicated
tensor is the same on every rank of the axis, so its gradient is too.

The backend is the caller's (`launch.init_distributed` picks NCCL for
CUDA and gloo for the CPU). Where a group runs gloo and the tensor lives
on a GPU, the collective stages through host memory: a copy to the CPU,
the collective, a copy back. bf16 tensors travel as f32. `calls` counts
the collectives this mesh ran by (name, axis, backend, device type).
Nothing here changes the current device or the backend.
"""

from __future__ import annotations

import collections
from typing import Optional, Sequence

import torch
import torch.distributed as dist


class Mesh:
    """An (n / model_parallel, model_parallel) grid of process-group
    ranks with one process group per row and per column."""

    def __init__(self, shape: tuple[int, int], axes: Sequence[str],
                 groups: dict, coords: Optional[tuple[int, int]]):
        self.shape = tuple(shape)
        self.axis_names = tuple(axes)
        self._groups = groups            # axis -> this rank's group
        self.coords = coords             # (row, column); None: not a member
        self.calls: collections.Counter = collections.Counter()

    # -- layout ---------------------------------------------------------
    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        if self.coords is None:
            raise RuntimeError("this rank is not in the mesh")
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        if self.coords is None:
            raise RuntimeError("this rank is not in the mesh")
        return self._groups[axis]

    def chunk(self, n: int, axis: str) -> slice:
        """This rank's contiguous share of n items split over `axis`;
        refuses an n that `axis` does not divide."""
        size = self.size(axis)
        if n % size:
            raise ValueError(f"{n} does not split evenly over the {axis} "
                             f"axis of size {size}")
        per = n // size
        i = self.index(axis)
        return slice(i * per, (i + 1) * per)

    # -- collectives without autograd ----------------------------------
    def _staged(self, name: str, axis: str, x: torch.Tensor):
        """(tensor to hand the backend, function giving back a result in
        x's device and dtype)."""
        group = self.group(axis)
        backend = dist.get_backend(group)
        self.calls[(name, axis, backend, x.device.type)] += 1
        # a fresh contiguous copy: the backend works on it in place
        y = x.detach().to(
            device="cpu" if backend == "gloo" else x.device,
            dtype=torch.float32 if x.dtype == torch.bfloat16 else x.dtype,
            memory_format=torch.contiguous_format, copy=True)

        def back(t):
            return t.to(device=x.device, dtype=x.dtype)

        return group, y, back

    def all_reduce(self, x: torch.Tensor, axis: str,
                   average: bool = False) -> torch.Tensor:
        """The sum (or mean) of x over the ranks of `axis`, as a new
        tensor."""
        group, y, back = self._staged("all_reduce", axis, x)
        dist.all_reduce(y, group=group)
        if average:
            y = y / self.size(axis)
        return back(y)

    def all_gather(self, x: torch.Tensor, axis: str,
                   dim: int = 0) -> torch.Tensor:
        """The ranks' x concatenated along `dim` in `axis` order."""
        group, y, back = self._staged("all_gather", axis, x)
        parts = [torch.empty_like(y) for _ in range(self.size(axis))]
        dist.all_gather(parts, y, group=group)
        return back(torch.cat(parts, dim=dim))

    # -- collectives with autograd -------------------------------------
    def copy_to(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Identity forward; all-reduce (sum) of the gradient backward."""
        if self.size(axis) == 1:
            return x
        return _CopyTo.apply(x, self, axis)

    def reduce_from(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """All-reduce (sum) forward; identity backward."""
        if self.size(axis) == 1:
            return x
        return _ReduceFrom.apply(x, self, axis)

    def gather_from(self, x: torch.Tensor, axis: str,
                    dim: int) -> torch.Tensor:
        """All-gather along `dim` forward; this rank's slice of the
        gradient backward."""
        if self.size(axis) == 1:
            return x
        return _GatherFrom.apply(x, self, axis, dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, x.shape[dim]
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index(ctx.axis)
        return (g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None,
                None)


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("data", "model"),
              model_parallel: int = 1) -> Mesh:
    """Build an (n / model_parallel, model_parallel) mesh over ranks
    [0, n) of the default process group (n: the world size by default).

    With model_parallel=1 this is pure data parallelism; the mesh keeps
    both axes so the same program works at any split. Every rank of the
    world calls it (group creation is collective); a rank outside the
    first n gets a mesh it is not a member of.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.launch.init_distributed)")
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"need {n} devices, have {world}")
    if n % model_parallel:
        raise ValueError(f"{n} devices do not split into model_parallel="
                         f"{model_parallel}")
    rows, cols = n // model_parallel, model_parallel
    rank = dist.get_rank()
    coords = divmod(rank, cols) if rank < n else None
    groups = {}
    # every rank creates every group, in one order
    for j in range(cols):
        g = dist.new_group([i * cols + j for i in range(rows)])
        if coords is not None and coords[1] == j:
            groups[axes[0]] = g
    for i in range(rows):
        g = dist.new_group([i * cols + j for j in range(cols)])
        if coords is not None and coords[0] == i:
            groups[axes[1]] = g
    return Mesh((rows, cols), axes, groups, coords)
