"""The masked attention flow kernel (CUDA, K5) and its plain version.

Counterpart of the JAX package's `ops/pallas_similarity.py:
masked_attention_flow_fused` (`_flow_kernel`): for target features t
(B, T, C), source features s (B, S, C), masks mt (B, T), ms (B, S) and a
grid (S, 2),

    z[b, t, s] = temp * <t, s> * (mt*ms + (1-mt)*(1-ms))
    flow[b, t] = sum_s softmax_s(z[b, t, :]) * grid[s]

without writing the (B, T, S) attention. The mask is a real-valued
coefficient on the logit (a cross-region pair gets logit 0, not -inf).
`masked_attention_flow` is the plain form (fp32 matmuls, TF32 off: temp
100 multiplies any logit error by 100 inside exp); it lives here, and
`ops/similarity.py` takes it from here.

`masked_attention_flow_fused` runs `csrc/attention_flow.cu` on CUDA
tensors (see its header for the design and what bounds it) and the plain
version on CPU tensors. A CUDA tensor launches the kernel or raises;
nothing falls back. It is differentiable in all five tensors: the
backward recomputes the plain composition and backpropagates through it,
as the JAX package's `_fused_bwd` does with the einsum VJP; the TPU has no
backward kernel here, so neither has the port.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .precision import tf32


def _mask_coeff(tar_mask: torch.Tensor,
                src_mask: torch.Tensor) -> torch.Tensor:
    """(B, T) x (B, S) -> (B, T, S) same-region coefficient."""
    mt = tar_mask[:, :, None]
    ms = src_mask[:, None, :]
    return mt * ms + (1.0 - mt) * (1.0 - ms)


def masked_attention_flow(tar_fea, src_fea, tar_mask, src_mask, grid,
                          temp: float = 100.0) -> torch.Tensor:
    """Coordinate-translator flow (the plain version of K5).

    tar_fea (B, T, C) and src_fea (B, S, C) L2-normalized; tar_mask (B, T);
    src_mask (B, S); grid (S, 2). Returns (B, T, 2).
    """
    with tf32(False):
        logits = torch.matmul(tar_fea.float(), src_fea.float().transpose(1, 2))
        logits = logits * _mask_coeff(tar_mask.float(), src_mask.float())
        attn = torch.softmax(temp * logits, dim=-1)
        return torch.matmul(attn, grid.float())


def masked_attention_flow_fused(tar_fea, src_fea, tar_mask, src_mask, grid,
                                temp: float = 100.0) -> torch.Tensor:
    """K5: `masked_attention_flow` in one kernel, (B, T, 2) f32.

    Inputs as `masked_attention_flow`, any float dtype (the kernel reads
    them as f32, as the JAX entry casts them); any B, T, S and C.
    """
    if tar_fea.device.type == "cpu":
        return masked_attention_flow(tar_fea, src_fea, tar_mask, src_mask,
                                     grid, temp)
    _check(tar_fea, src_fea, tar_mask, src_mask, grid)
    return _MaskedAttentionFlow.apply(tar_fea, src_fea, tar_mask, src_mask,
                                      grid, temp)


def _check(tar_fea, src_fea, tar_mask, src_mask, grid) -> None:
    """Raise unless the shapes are (B, T, C), (B, S, C), (B, T), (B, S)
    and (S, 2), none of them empty."""
    if tar_fea.dim() != 3 or src_fea.dim() != 3:
        raise ValueError("masked_attention_flow_fused kernel: tar_fea "
                         f"(B, T, C) and src_fea (B, S, C), got "
                         f"{tuple(tar_fea.shape)} and {tuple(src_fea.shape)}")
    b, t, c = tar_fea.shape
    s = src_fea.shape[1]
    want = {"src_fea": (src_fea, (b, s, c)), "tar_mask": (tar_mask, (b, t)),
            "src_mask": (src_mask, (b, s)), "grid": (grid, (s, 2))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"masked_attention_flow_fused kernel: {name} "
                             f"must be {shape} for tar_fea {(b, t, c)} and "
                             f"S={s}, got {tuple(x.shape)}")
    if min(b, t, s, c) == 0:
        raise ValueError("masked_attention_flow_fused kernel: empty input, "
                         f"B, T, S, C = {b, t, s, c}")


class _MaskedAttentionFlow(torch.autograd.Function):
    """K5 forward; backward through the recomputed plain composition."""

    @staticmethod
    def forward(ctx, tar_fea, src_fea, tar_mask, src_mask, grid, temp):
        ctx.save_for_backward(tar_fea, src_fea, tar_mask, src_mask, grid)
        ctx.temp = temp
        return _launch(tar_fea, src_fea, tar_mask, src_mask, grid, temp)

    @staticmethod
    def backward(ctx, g_flow):
        inputs = [x.detach().requires_grad_(need) for x, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [x for x in inputs if x.requires_grad]
        with torch.enable_grad():
            flow = masked_attention_flow(*inputs, temp=ctx.temp)
            grads = iter(torch.autograd.grad(flow, wanted, g_flow))
        return tuple(next(grads) if x.requires_grad else None
                     for x in inputs) + (None,)


def _launch(tar_fea, src_fea, tar_mask, src_mask, grid, temp) -> torch.Tensor:
    dev = tar_fea.device
    for x in (src_fea, tar_mask, src_mask, grid):
        if dev.type != "cuda" or x.device != dev:
            raise ValueError(f"masked_attention_flow_fused kernel: tensors on "
                             f"{dev} and {x.device}; it runs on CUDA tensors "
                             "of one device (CPU tensors take the plain "
                             "version)")
    tar, src, mt, ms, gr = (x.detach().float().contiguous() for x in (
        tar_fea, src_fea, tar_mask, src_mask, grid))
    b, t, c = tar.shape
    s = src.shape[1]
    out = torch.empty((b, t, 2), dtype=torch.float32, device=dev)
    lib = _library()
    p = cuda_build.ptr
    with torch.cuda.device(dev):
        err = lib.tsnet_attention_flow(p(tar), p(src), p(mt), p(ms), p(gr),
                                       p(out), b, t, s, c, float(temp),
                                       cuda_build.stream_of(tar))
    cuda_build.check_launch(lib, err, "masked_attention_flow_fused")
    cuda_build.LAUNCHES["masked_attention_flow_fused"] += 1
    return out


def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library("attention_flow")
    fn = lib.tsnet_attention_flow
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib
