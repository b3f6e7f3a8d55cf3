"""The fused instance-norm mean kernel (CUDA) and its plain version.

Counterpart of the JAX package's `ops/pallas_norms.py:instance_norm_mean`
(K2): for x (S, F, H, W, C), the instance norm of each (s, f) plane
averaged over S, without writing the per-pair normalised tensor. It runs
`csrc/in_mean.cu` on CUDA tensors (see its header for the design and what
bounds it) and the plain version on CPU tensors. A CUDA tensor launches
the kernel or raises; nothing falls back.

It is differentiable. On the GPU its backward recomputes the plain
composition and backpropagates through it, as the JAX package's
`_in_mean_bwd` does with `_in_mean_ref`; the TPU has no backward kernel
here, so neither has the port. On the CPU autograd runs through the
plain version itself.

The kernel's statistics are one-pass fp32 (E[x²] - E[x]², clamped at 0),
as the TPU kernel's; the plain version is the JAX package's composition
`_in_mean_ref`: the fp32 two-pass `instance_norm` of each plane, then the
mean. The two agree to float rounding.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .norms import instance_norm

_DTYPES = (torch.float32, torch.bfloat16)


def instance_norm_mean_plain(x: torch.Tensor, eps: float = 1e-5,
                             out_dtype=None) -> torch.Tensor:
    """mean_s instance_norm(x[s]) in fp32, cast to `out_dtype` (x's dtype
    by default). x (S, F, H, W, C) -> (F, H, W, C)."""
    s, f, h, w, c = x.shape
    y = instance_norm(x.float().reshape(s * f, h, w, c), eps)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    return y.reshape(s, f, h, w, c).mean(dim=0).to(out_dtype)


def instance_norm_mean(x: torch.Tensor, eps: float = 1e-5,
                       out_dtype=None) -> torch.Tensor:
    """K2: mean over the leading source axis of per-plane instance norms.

    x (S, F, H, W, C) in f32 or bf16 -> (F, H, W, C) in `out_dtype`
    (x's dtype by default).
    """
    if x.device.type == "cpu":
        return instance_norm_mean_plain(x, eps, out_dtype)
    return _InstanceNormMean.apply(x, eps, out_dtype)


class _InstanceNormMean(torch.autograd.Function):
    """K2 forward; backward through the recomputed plain composition."""

    @staticmethod
    def forward(ctx, x, eps, out_dtype):
        ctx.save_for_backward(x)
        ctx.eps_dtype = (eps, out_dtype)
        return _launch(x, eps, out_dtype)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            y = instance_norm_mean_plain(xx, *ctx.eps_dtype)
            (gx,) = torch.autograd.grad(y, xx, grad)
        return gx, None, None


def _launch(x: torch.Tensor, eps: float, out_dtype) -> torch.Tensor:
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_mean kernel: x on {x.device}; it "
                         "runs on CUDA tensors (CPU tensors take the plain "
                         "version)")
    if x.dim() != 5 or not x.is_contiguous():
        raise ValueError("instance_norm_mean kernel: x must be a contiguous "
                         f"(S, F, H, W, C) tensor, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError("instance_norm_mean kernel: x and out_dtype must be "
                         f"float32 or bfloat16, got {x.dtype} -> {out_dtype}")
    s, f, h, w, c = x.shape
    out = torch.empty((f, h, w, c), dtype=out_dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.tsnet_in_mean(
            cuda_build.ptr(x), cuda_build.ptr(out), s, f, h * w, c,
            int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            float(eps), cuda_build.stream_of(x))
    # a plane too large for the shared-memory slab is refused here
    # (invalid argument from cudaFuncSetAttribute)
    cuda_build.check_launch(
        lib, err, f"instance_norm_mean (its fp32 slab of {h * w} pixels x "
                  f"32 channels takes {h * w * 128} bytes of shared memory)")
    cuda_build.LAUNCHES["instance_norm_mean"] += 1
    return out


def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library("in_mean")
    fn = lib.tsnet_in_mean
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib
