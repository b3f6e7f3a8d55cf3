"""The fused decoder ResNet-block conv (K7): CUDA kernel and plain version.

Counterpart of the JAX package's `ops/pallas_conv.py`: `conv3x3_in` is
`instance_norm(conv3x3(reflect_pad(x)))` followed by relu or by a
residual add, and `resblock_fused` is one ResnetBlock as two such calls.
`conv3x3_in` runs `csrc/conv3x3_in.cu` on CUDA tensors (see its header for
the design and what bounds it) and the plain version on CPU tensors. A
CUDA tensor launches the kernel or raises; nothing falls back.

Weights are the port's OIHW conv weights (Co, C, 3, 3); the conv bias is
not taken, since a per-channel constant cancels in the instance norm. The
plain version keeps the TPU kernel's rounding points: the conv in fp32 on
the input-dtype-rounded operands (TF32 off), one-pass fp32 statistics
clamped at 0, relu or the skip added in fp32, one rounding at the end.
Inference only, as in the JAX package: no gradient.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build
from .precision import tf32


def conv3x3_in_plain(x: torch.Tensor, w: torch.Tensor, skip=None,
                     relu: bool = True, eps: float = 1e-5) -> torch.Tensor:
    """IN(conv3x3(reflect_pad(x), w)) (+ relu) (+ skip), in x's dtype.

    x (B, H, W, C), w (Co, C, 3, 3), skip (B, H, W, Co) or None.
    """
    xp = F.pad(x.float().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    with tf32(False):
        y = F.conv2d(xp, w.to(x.dtype).float()).permute(0, 2, 3, 1)
    n = y.shape[1] * y.shape[2]
    mean = y.sum(dim=(1, 2), keepdim=True) / n
    var = torch.clamp((y * y).sum(dim=(1, 2), keepdim=True) / n - mean * mean,
                      min=0.0)
    y = (y - mean) * torch.rsqrt(var + eps)
    if relu:
        y = torch.relu(y)
    if skip is not None:
        y = y + skip.float()
    return y.to(x.dtype)


def conv3x3_in(x: torch.Tensor, w: torch.Tensor, skip=None, relu: bool = True,
               eps: float = 1e-5) -> torch.Tensor:
    """K7: fused reflect-pad 3x3 conv -> instance norm (-> relu) (+ skip).

    x (B, H, W, C), bf16 on the GPU; w (Co, C, 3, 3) OIHW, any float dtype;
    skip (B, H, W, Co) in x's dtype, added after the norm. Returns
    (B, H, W, Co) in x's dtype.
    """
    if x.device.type == "cpu":
        return conv3x3_in_plain(x, w, skip, relu, eps)
    launch, out = launcher(x, w, skip, relu, eps)
    launch()
    cuda_build.LAUNCHES["conv3x3_in"] += 1
    return out


def resblock_fused(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   eps: float = 1e-5, use_kernels: bool = True) -> torch.Tensor:
    """One ResnetBlock, x + IN(conv2(relu(IN(conv1(x))))), as two K7 calls
    (their plain versions with `use_kernels=False`). Biases are not taken:
    they cancel in the instance norms."""
    conv = conv3x3_in if use_kernels else conv3x3_in_plain
    h = conv(x, w1, relu=True, eps=eps)
    return conv(h, w2, skip=x, relu=False, eps=eps)


def _check(x, w, skip) -> None:
    if x.dim() != 4:
        raise ValueError("conv3x3_in kernel: x must be (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    b, h, wd, c = x.shape
    if w.dim() != 4 or w.shape[1:] != (c, 3, 3):
        raise ValueError("conv3x3_in kernel: w must be (Co, C, 3, 3) with "
                         f"C={c}, got {tuple(w.shape)}")
    co = w.shape[0]
    if skip is not None and (skip.shape != (b, h, wd, co)
                             or skip.dtype != x.dtype
                             or not skip.is_contiguous()):
        raise ValueError("conv3x3_in kernel: skip must be a contiguous "
                         f"{(b, h, wd, co)} tensor of x's dtype, got "
                         f"{tuple(skip.shape)} {skip.dtype}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"conv3x3_in kernel: x must be bfloat16, got "
                         f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("conv3x3_in kernel: x must be contiguous")
    if c % 8 or co % 8:
        raise ValueError("conv3x3_in kernel: C and Co must be multiples of 8 "
                         f"(16-byte chunks), got C={c}, Co={co}")
    if h < 2 or wd < 2:
        raise ValueError("conv3x3_in kernel: the reflect pad needs H and W "
                         f"of at least 2, got {h}x{wd}")


# A block's tile: 128 output pixels of one plane, TC = min(W, 128) columns
# by 128 // TC rows (csrc/igemm_sm90.cuh rect_of). A plane of at most
# MAX_CLUSTER tiles takes the cluster path (one launch, the norm finished
# inside a cluster of its tiles); a larger one the two-pass path.
TILE = 128
MAX_CLUSTER = 8

# The two-pass path's launches, by the bit that selects each
# (csrc/conv3x3_in.cu); the cluster path is one launch.
PHASES = ("conv", "stats", "finish")


def tiles(h: int, w: int) -> int:
    """The tiles of an h x w plane."""
    tc = min(w, TILE)
    return -(-h // (TILE // tc)) * -(-w // tc)


def cluster_size(h: int, w: int) -> int:
    """The cluster of the cluster path for an h x w plane (its tiles), or
    0 where the plane takes the two-pass path."""
    n = tiles(h, w)
    return n if n <= MAX_CLUSTER else 0


def launcher(x, w, skip=None, relu: bool = True, eps: float = 1e-5,
             two_pass=None):
    """K7's checks, output and scratch for these CUDA inputs, without a
    launch: returns (launch, out). The path follows from the plane
    (`cluster_size`); `two_pass=True` takes the two-pass path for any
    plane.
    launch(phases) runs the two-pass path's launches whose bits `phases`
    sets (bit i: PHASES[i]; all by default), and the cluster path's one
    launch for any bits; it counts nothing. `conv3x3_in` is one launch()."""
    _check(x, w, skip)
    for t in (x, w) if skip is None else (x, w, skip):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"conv3x3_in kernel: tensors on {t.device}; it "
                             "runs on CUDA tensors of one device (CPU tensors "
                             "take the plain version)")
    cuda_build.check_aligned("conv3x3_in", x, *(() if skip is None
                                                else (skip,)))
    b, h, wd, c = x.shape
    co = w.shape[0]
    n_tiles = tiles(h, wd)
    if two_pass is None:
        two_pass = cluster_size(h, wd) == 0
    wr = cuda_build.gemm_weight(w)
    out = torch.empty((b, h, wd, co), dtype=torch.bfloat16, device=x.device)
    scratch = (None, None, None)
    if two_pass:
        f32 = dict(dtype=torch.float32, device=x.device)
        scratch = (torch.empty((b, h, wd, co), **f32),       # pre-norm y
                   torch.empty((b * n_tiles, 2, co), **f32),  # tile sums
                   torch.empty((b, co, 2), **f32))            # mean, rstd
    lib = _library()
    p = cuda_build.ptr

    def launch(phases: int = (1 << len(PHASES)) - 1) -> None:
        with torch.cuda.device(x.device):
            err = lib.tsnet_conv3x3_in(
                p(x), p(wr), None if skip is None else p(skip), p(out),
                *(None if t is None else p(t) for t in scratch), b, h, wd, c,
                co, int(relu), float(eps), int(two_pass), phases,
                cuda_build.stream_of(x))
        cuda_build.check_launch(lib, err, "conv3x3_in")

    return launch, out


def max_active_clusters(h: int, w: int, co: int) -> int:
    """How many clusters of the cluster path for an h x w plane and co
    output channels the current CUDA device runs at once."""
    lib = _library()
    n = ctypes.c_int(0)
    cuda_build.check_launch(lib, lib.tsnet_conv3x3_in_max_clusters(
        h, w, co, ctypes.byref(n)), "conv3x3_in occupancy")
    return n.value


def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library("conv3x3_in")
    fn = lib.tsnet_conv3x3_in
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        occ = lib.tsnet_conv3x3_in_max_clusters
        occ.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        occ.restype = ctypes.c_int
    return lib
