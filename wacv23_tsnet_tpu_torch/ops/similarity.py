"""The transformation branch: mask-aware similarity -> coordinate flow.

Counterpart of the JAX package's `ops/similarity.py`. For every target
pixel t and source pixel u at feature resolution:

    S[t, u]  = (mt*mu + (1-mt)*(1-mu)) * <tar_fea[t], src_fea[u]>
    A        = softmax(temp * S, axis=u)           # temp = 100
    flow[t]  = sum_u A[t, u] * grid[u]

`masked_attention_flow` is the plain form (fp32 matmuls, TF32 off: temp
100 multiplies any logit error by 100 inside exp) and
`masked_attention_flow_fused` its kernel (K5), both in `ops/flow_kernels.py`;
`transformation_warp(use_kernels=True)` runs the kernel.
`transformation_warp_clip` and `transformation_warp_clip_mean` are the
clip-inference entry points; they dispatch to the CUDA kernels of
`ops/warp_kernels.py` (K3-nf and K1). `transformation_warp_sources` is
the training entry point, differentiable: K3-flow forward and K4
backward.

Spatial (sequence) parallelism: inside `spatial_partitioning(mesh,
axis)` (set by `parallel.spmd`, as the JAX package's hook of the same
name constrains the logits' sharding), the plain path computes only this
rank's contiguous share of the target pixels T: its rows of the
similarity, the softmax, the flow and the warp; the rows are gathered
over `axis`, and the replicated inputs' gradients summed over it
(`parallel.mesh.Mesh`). The kernel path ignores it, as in the JAX
package: each kernel takes the full T of its rank's data slice (the JAX
package's `batch_partitioning`, which runs its kernels per data shard,
has no counterpart here: each rank already holds only its slice).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from .coords import normalized_grid
from .flow_kernels import masked_attention_flow, masked_attention_flow_fused
from .grid_sample import grid_sample
from .warp_kernels import (transform_warp_mean_plain, transform_warp_pairs,
                           transform_warp_pairs_mean, transform_warp_pairs_nf,
                           transform_warp_pairs_nf_plain)

_SPATIAL: contextvars.ContextVar = contextvars.ContextVar(
    "tsnet_spatial_partitioning", default=None)


@contextlib.contextmanager
def spatial_partitioning(mesh, axis: str = "model"):
    """Context: the plain path splits the target pixels over `axis` of
    `mesh` (a `parallel.mesh.Mesh`)."""
    token = _SPATIAL.set((mesh, axis))
    try:
        yield
    finally:
        _SPATIAL.reset(token)


def _spatial():
    """(mesh, axis) of the active spatial partitioning over more than one
    rank, else None."""
    ctx = _SPATIAL.get()
    return ctx if ctx is not None and ctx[0].size(ctx[1]) > 1 else None


def transformation_warp(src_img_fea, tar_fea_n, src_fea_n, tar_mask, src_mask,
                        temp: float = 100.0, use_kernels: bool = False):
    """Transformation branch for one source per sample.

    src_img_fea (B, h, w, C) un-normalized; tar_fea_n, src_fea_n
    (B, h, w, C) L2-normalized; masks (B, h, w).
    Returns (warped (B, h, w, C), flow (B, h, w, 2)).

    `use_kernels=True` takes the flow from `masked_attention_flow_fused`
    (K5 on CUDA tensors), as the JAX package's `use_pallas=True` does;
    the default is the plain form, as there.
    """
    b, h, w, c = src_img_fea.shape
    grid = normalized_grid(h, w, device=src_img_fea.device).reshape(h * w, 2)
    sp = None if use_kernels else _spatial()
    if sp is not None:
        mesh, axis = sp
        rows = mesh.chunk(h * w, axis)
        src_img_fea, tar_fea_n, src_fea_n = (
            mesh.copy_to(x, axis) for x in (src_img_fea, tar_fea_n, src_fea_n))
        flow = masked_attention_flow(
            tar_fea_n.reshape(b, h * w, c)[:, rows],
            src_fea_n.reshape(b, h * w, c),
            tar_mask.reshape(b, h * w)[:, rows], src_mask.reshape(b, h * w),
            grid, temp=temp)                                 # (B, rows, 2)
        warped = grid_sample(src_img_fea, flow[:, None])[:, 0]
        return (mesh.gather_from(warped, axis, 1).reshape(b, h, w, c),
                mesh.gather_from(flow, axis, 1).reshape(b, h, w, 2))
    flow_fn = (masked_attention_flow_fused if use_kernels
               else masked_attention_flow)
    flow = flow_fn(
        tar_fea_n.reshape(b, h * w, c), src_fea_n.reshape(b, h * w, c),
        tar_mask.reshape(b, h * w), src_mask.reshape(b, h * w), grid,
        temp=temp).reshape(b, h, w, 2)
    return grid_sample(src_img_fea, flow), flow


def transformation_warp_sources(src_img_fea, tar_fea_n, src_fea_n, tar_mask,
                                src_mask, temp: float = 100.0,
                                use_kernels: bool = True,
                                fast_warp: bool = False,
                                bwd_fast3: bool = False):
    """Transformation branch for all sources of a training batch.

    src_img_fea (B, S, h, w, C) un-normalized, src_fea_n its L2
    normalization, src_mask (B, S, h, w); tar_fea_n (B, h, w, C),
    tar_mask (B, h, w). Returns (warped (B, S, h, w, C), flow
    (B, S, h, w, 2)), differentiable in the features.

    `use_kernels=True` runs `warp_kernels.transform_warp_pairs` over
    (group = sample, source, one frame): K3-flow forward and K4 backward
    on CUDA tensors, its plain version on CPU tensors. `use_kernels=False`
    runs the plain per-source path (`transformation_warp` for each
    source), as the JAX package's `use_pallas=False` does. `fast_warp`
    and `bwd_fast3` are the JAX package's knobs and change nothing here
    (see `warp_kernels`).
    """
    b, s, h, w, c = src_img_fea.shape
    if not use_kernels:
        outs = [transformation_warp(src_img_fea[:, i], tar_fea_n,
                                    src_fea_n[:, i], tar_mask, src_mask[:, i],
                                    temp=temp) for i in range(s)]
        return (torch.stack([o[0] for o in outs], 1),
                torch.stack([o[1] for o in outs], 1))
    t = h * w
    grid = normalized_grid(h, w, device=src_img_fea.device).reshape(t, 2)
    warped, flow = transform_warp_pairs(
        src_img_fea.float().reshape(b, s, t, c).contiguous(),
        tar_fea_n.float().reshape(b, 1, t, c).contiguous(),
        src_fea_n.float().reshape(b, s, t, c).contiguous(),
        tar_mask.float().reshape(b, 1, t).contiguous(),
        src_mask.float().reshape(b, s, t).contiguous(), grid, h, w, temp,
        fast_warp, bwd_fast3)
    return (warped[:, :, 0].reshape(b, s, h, w, c),
            flow[:, :, 0].reshape(b, s, h, w, 2))


def _flat(src_fea, src_fea_n, src_mask, tar_fea_n, tar_mask):
    """Clip inputs as the kernels' contiguous f32 (T, C) planes.

    The port keeps NHWC storage, so an (h, w, C) feature map already is T
    rows with C contiguous, as the kernels read it: the reshapes are
    views (no permute at the kernel boundary)."""
    s, h, w, c = src_fea.shape
    f = tar_fea_n.shape[0]
    t = h * w
    rows = (src_fea.float().reshape(s, t, c),
            tar_fea_n.float().reshape(f, t, c),
            src_fea_n.float().reshape(s, t, c),
            tar_mask.float().reshape(f, t), src_mask.float().reshape(s, t))
    grid = normalized_grid(h, w, device=src_fea.device).reshape(t, 2)
    return tuple(x.contiguous() for x in rows) + (grid,)


def transformation_warp_clip(src_fea, src_fea_n, src_mask, tar_fea_n,
                             tar_mask, temp: float = 100.0,
                             use_kernels: bool = True) -> torch.Tensor:
    """Every (source, frame) pair of a clip: (S, F, h, w, C) f32.

    src_fea (S, h, w, C) un-normalized, src_fea_n its L2 normalization,
    src_mask (S, h, w); tar_fea_n (F, h, w, C), tar_mask (F, h, w).
    `use_kernels=False` runs the plain version on any device (the
    reference the kernel is held against).
    """
    s, h, w, c = src_fea.shape
    f = tar_fea_n.shape[0]
    args = _flat(src_fea, src_fea_n, src_mask, tar_fea_n, tar_mask)
    if use_kernels:
        out = transform_warp_pairs_nf(*args, h, w, temp)
    else:
        out = _target_rows(transform_warp_pairs_nf_plain, args, 2, h, w, temp)
    return out.reshape(s, f, h, w, c)


def transformation_warp_clip_mean(src_fea, src_fea_n, src_mask, tar_fea_n,
                                  tar_mask, temp: float = 100.0,
                                  out_dtype=torch.float32,
                                  use_kernels: bool = True) -> torch.Tensor:
    """`transformation_warp_clip(...).mean(0)` without the per-pair tensor.

    Returns (F, h, w, C) in `out_dtype` (bf16 for the fast tail).
    """
    _, h, w, c = src_fea.shape
    f = tar_fea_n.shape[0]
    args = _flat(src_fea, src_fea_n, src_mask, tar_fea_n, tar_mask)
    if use_kernels:
        out = transform_warp_pairs_mean(*args, h, w, temp, out_dtype)
    else:
        out = _target_rows(transform_warp_mean_plain, args, 1, h, w, temp,
                           out_dtype)
    return out.reshape(f, h, w, c)


def _target_rows(plain, args, dim: int, *rest) -> torch.Tensor:
    """plain(*args, *rest) on the clip inputs of `_flat`; under spatial
    partitioning on this rank's target rows only, the result's rows
    (axis `dim`) gathered over the axis (inference: no gradient)."""
    sp = _spatial()
    if sp is None:
        return plain(*args, *rest)
    mesh, axis = sp
    src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask, grid = args
    rows = mesh.chunk(tar_fea_n.shape[1], axis)
    out = plain(src_fea, tar_fea_n[:, rows].contiguous(), src_fea_n,
                tar_mask[:, rows].contiguous(), src_mask, grid, *rest)
    return mesh.all_gather(out, axis, dim)
