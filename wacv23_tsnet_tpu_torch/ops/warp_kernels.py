"""The transformation-branch kernels (CUDA) and their plain versions.

Counterpart of the JAX package's `ops/pallas_similarity.py` entry points
on the clip-inference path:

- `transform_warp_pairs_mean` (K1): the mean over sources of the warped
  source features, (F, T, C) in `out_dtype`. One CUDA design covers both
  TPU forms (`_mean_kernel` and the big-T `_mean_bigt_kernel`): it
  streams the sources, so it has no resident-memory budget.
- `transform_warp_pairs_nf` (K3-nf): every (source, frame) pair,
  (S, F, T, C) in f32, without the flow output.

Both run `csrc/transform_warp.cu` on CUDA tensors (see its header for the
design and what bounds it) and their plain PyTorch versions on CPU
tensors. A CUDA tensor launches the kernel or raises; nothing falls back.

The kernel takes the L2-normalised source features that `encode_sources`
already computes (the TPU mean kernel renormalises `src_fea` itself); the
plain versions take the same inputs and compute the same function. The
logits and the flow run in fp32 in every tier (never TF32 or bf16).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .grid_sample import grid_sample
from .similarity import masked_attention_flow


def transform_warp_pairs_plain(src_fea, tar_fea_n, src_fea_n, tar_mask,
                               src_mask, grid, h: int, w: int,
                               temp: float = 100.0) -> torch.Tensor:
    """Plain version of K3-nf: (S, F, T, C) f32 warped features.

    src_fea, src_fea_n (S, T, C); tar_fea_n (F, T, C); tar_mask (F, T);
    src_mask (S, T); grid (T, 2).
    """
    s, t, c = src_fea.shape
    f = tar_fea_n.shape[0]
    out = []
    for si in range(s):
        flow = masked_attention_flow(
            tar_fea_n, src_fea_n[si].expand(f, t, c), tar_mask,
            src_mask[si].expand(f, t), grid, temp=temp)        # (F, T, 2)
        img = src_fea[si].reshape(1, h, w, c).expand(f, h, w, c)
        out.append(grid_sample(img, flow.reshape(f, h, w, 2)).reshape(f, t, c))
    return torch.stack(out)


def transform_warp_mean_plain(src_fea, tar_fea_n, src_fea_n, tar_mask,
                              src_mask, grid, h: int, w: int,
                              temp: float = 100.0,
                              out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of K1: (F, T, C) mean over sources in `out_dtype`."""
    return transform_warp_pairs_plain(
        src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask, grid, h, w,
        temp).mean(dim=0).to(out_dtype)


def _check(src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask, grid, h, w):
    s, t, c = src_fea.shape
    f = tar_fea_n.shape[0]
    want = {"src_fea": (src_fea, (s, t, c)),
            "tar_fea_n": (tar_fea_n, (f, t, c)),
            "src_fea_n": (src_fea_n, (s, t, c)),
            "tar_mask": (tar_mask, (f, t)),
            "src_mask": (src_mask, (s, t)),
            "grid": (grid, (t, 2))}
    dev = src_fea.device
    if dev.type != "cuda":
        raise ValueError(f"transform_warp kernel: tensors on {dev}; it "
                         "runs on CUDA tensors (CPU tensors take the plain "
                         "version)")
    for name, (x, shape) in want.items():
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"transform_warp kernel: {name} must be float32 "
                             f"on {dev}, got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"transform_warp kernel: {name} must be a "
                             f"contiguous {shape}, got {tuple(x.shape)}")
    if t != h * w:
        raise ValueError(f"transform_warp kernel: T={t} != h*w={h * w}")


def _launch(out, mean, src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask,
            grid, h, w, temp):
    s, t, c = src_fea.shape
    f = tar_fea_n.shape[0]
    lib = _library()
    p = cuda_build.ptr
    with torch.cuda.device(src_fea.device):
        err = lib.tsnet_transform_warp(
            p(src_fea), p(src_fea_n), p(src_mask), p(tar_fea_n), p(tar_mask),
            p(grid), p(out), s, f, t, c, h, w, float(temp), int(mean),
            int(out.dtype == torch.bfloat16), cuda_build.stream_of(src_fea))
    cuda_build.check_launch(lib, err, "transform_warp")


def transform_warp_pairs_nf(src_fea, tar_fea_n, src_fea_n, tar_mask,
                            src_mask, grid, h: int, w: int,
                            temp: float = 100.0) -> torch.Tensor:
    """K3-nf: (S, F, T, C) f32 warped features of every pair."""
    if src_fea.device.type == "cpu":
        return transform_warp_pairs_plain(src_fea, tar_fea_n, src_fea_n,
                                          tar_mask, src_mask, grid, h, w,
                                          temp)
    _check(src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask, grid, h, w)
    s, t, c = src_fea.shape
    f = tar_fea_n.shape[0]
    out = torch.empty((s, f, t, c), dtype=torch.float32, device=src_fea.device)
    _launch(out, False, src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask,
            grid, h, w, temp)
    cuda_build.LAUNCHES["transform_warp_pairs_nf"] += 1
    return out


def transform_warp_pairs_mean(src_fea, tar_fea_n, src_fea_n, tar_mask,
                              src_mask, grid, h: int, w: int,
                              temp: float = 100.0,
                              out_dtype=torch.float32) -> torch.Tensor:
    """K1: (F, T, C) mean over sources of the warped features."""
    if src_fea.device.type == "cpu":
        return transform_warp_mean_plain(src_fea, tar_fea_n, src_fea_n,
                                         tar_mask, src_mask, grid, h, w,
                                         temp, out_dtype)
    _check(src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask, grid, h, w)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"transform_warp kernel: out_dtype {out_dtype} is "
                         "neither float32 nor bfloat16")
    s, t, c = src_fea.shape
    f = tar_fea_n.shape[0]
    out = torch.empty((f, t, c), dtype=out_dtype, device=src_fea.device)
    _launch(out, True, src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask,
            grid, h, w, temp)
    cuda_build.LAUNCHES["transform_warp_pairs_mean"] += 1
    return out


def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library("transform_warp")
    fn = lib.tsnet_transform_warp
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib
