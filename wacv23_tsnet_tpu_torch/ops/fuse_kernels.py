"""The fused FuseNet pair block (K6): CUDA kernel and plain version.

Counterpart of the JAX package's `ops/pallas_fuse.py:fuse_pair_conv2`:
for the conv1 halves c1a (S, H, W, K) of the sources and c1t (F, H, W, K)
of the frames, every (source, frame) pair's
conv2(reflect_pad(relu(IN(c1a[s] + c1t[f])))), a bias-free 3x3, without
writing the per-pair normalised tensor. It runs `csrc/fuse_pair_conv2.cu`
on CUDA tensors (see its header for the design and what bounds it) and the
plain version on CPU tensors. A CUDA tensor launches the kernel or raises;
nothing falls back.

The weight is the port's OIHW conv2 weight (Co, K, 3, 3); the wrapper
repacks it to (Co, 3, 3, K) in c1a's dtype for the GEMM. The plain version
keeps the TPU kernel's rounding points: the pair sum in fp32, one-pass
fp32 statistics clamped at 0, hp rounded to the input dtype, the conv in
fp32 on those rounded operands (TF32 off), one rounding of the output.
Inference only, as in the JAX package: no gradient.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build
from .precision import tf32


def fuse_pair_conv2_plain(c1a: torch.Tensor, c1t: torch.Tensor,
                          w2: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """conv2(reflect_pad(relu(IN(c1a[s] + c1t[f])))) for all S x F pairs.

    c1a (S, H, W, K), c1t (F, H, W, K), w2 (Co, K, 3, 3) -> (S, F, H, W, Co)
    in c1a's dtype.
    """
    s, h, w, k = c1a.shape
    f = c1t.shape[0]
    co = w2.shape[0]
    xb = (c1a.float()[:, None] + c1t.float()[None]).reshape(s * f, h, w, k)
    n = h * w
    mean = xb.sum(dim=(1, 2), keepdim=True) / n
    var = torch.clamp((xb * xb).sum(dim=(1, 2), keepdim=True) / n
                      - mean * mean, min=0.0)
    hp = torch.relu((xb - mean) * torch.rsqrt(var + eps)).to(c1a.dtype)
    hp = F.pad(hp.float().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    with tf32(False):
        h2 = F.conv2d(hp, w2.to(c1a.dtype).float())
    return h2.permute(0, 2, 3, 1).reshape(s, f, h, w, co).to(c1a.dtype)


def fuse_pair_conv2(c1a: torch.Tensor, c1t: torch.Tensor, w2: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """K6: the FuseNet block's per-pair conv2 with its IN + relu in front.

    c1a (S, H, W, K) and c1t (F, H, W, K), bf16 on the GPU; w2 (Co, K, 3, 3)
    OIHW, any float dtype. Returns (S, F, H, W, Co) in c1a's dtype.
    """
    if c1a.device.type == "cpu":
        return fuse_pair_conv2_plain(c1a, c1t, w2, eps)
    return _launch(c1a, c1t, w2, eps)


def _check(c1a, c1t, w2) -> None:
    if c1a.dim() != 4 or c1t.dim() != 4 or c1a.shape[1:] != c1t.shape[1:]:
        raise ValueError("fuse_pair_conv2 kernel: c1a (S, H, W, K) and c1t "
                         f"(F, H, W, K), got {tuple(c1a.shape)} and "
                         f"{tuple(c1t.shape)}")
    s, h, w, k = c1a.shape
    if w2.dim() != 4 or w2.shape[1:] != (k, 3, 3):
        raise ValueError("fuse_pair_conv2 kernel: w2 must be (Co, K, 3, 3) "
                         f"with K={k}, got {tuple(w2.shape)}")
    co = w2.shape[0]
    if c1a.dtype != torch.bfloat16 or c1t.dtype != torch.bfloat16:
        raise ValueError("fuse_pair_conv2 kernel: c1a and c1t must be "
                         f"bfloat16, got {c1a.dtype} and {c1t.dtype}")
    if not (c1a.is_contiguous() and c1t.is_contiguous()):
        raise ValueError("fuse_pair_conv2 kernel: c1a and c1t must be "
                         "contiguous")
    if k % 8 or co % 8:
        raise ValueError("fuse_pair_conv2 kernel: K and Co must be multiples "
                         f"of 8 (16-byte chunks), got K={k}, Co={co}")
    if h < 2 or w < 2:
        raise ValueError("fuse_pair_conv2 kernel: the reflect pad needs H and "
                         f"W of at least 2, got {h}x{w}")


def _launch(c1a, c1t, w2, eps):
    _check(c1a, c1t, w2)
    for t in (c1a, c1t, w2):
        if t.device.type != "cuda" or t.device != c1a.device:
            raise ValueError(f"fuse_pair_conv2 kernel: tensors on {t.device}; "
                             "it runs on CUDA tensors of one device (CPU "
                             "tensors take the plain version)")
    cuda_build.check_aligned("fuse_pair_conv2", c1a, c1t)
    s, h, w, k = c1a.shape
    f = c1t.shape[0]
    co = w2.shape[0]
    wr = cuda_build.gemm_weight(w2)
    stats = torch.empty((s * f, k, 2), dtype=torch.float32, device=c1a.device)
    out = torch.empty((s, f, h, w, co), dtype=torch.bfloat16,
                      device=c1a.device)
    lib = _library()
    with torch.cuda.device(c1a.device):
        err = lib.tsnet_fuse_pair_conv2(
            cuda_build.ptr(c1a), cuda_build.ptr(c1t), cuda_build.ptr(wr),
            cuda_build.ptr(stats), cuda_build.ptr(out), s, f, h, w, k, co,
            float(eps), cuda_build.stream_of(c1a))
    cuda_build.check_launch(lib, err, "fuse_pair_conv2")
    cuda_build.LAUNCHES["fuse_pair_conv2"] += 1
    return out


def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library("fuse_pair_conv2")
    fn = lib.tsnet_fuse_pair_conv2
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib
