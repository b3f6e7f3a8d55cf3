"""The transformation-branch kernels (CUDA) and their plain versions.

Counterpart of the JAX package's `ops/pallas_similarity.py` entry points:

- `transform_warp_pairs_mean` (K1): the mean over sources of the warped
  source features, (F, T, C) in `out_dtype`. One CUDA design covers both
  TPU forms (`_mean_kernel` and the big-T `_mean_bigt_kernel`): it
  streams the sources, so it has no resident-memory budget.
- `transform_warp_pairs_nf` (K3-nf): every (source, frame) pair,
  (S, F, T, C) in f32, without the flow output.
- `transform_warp_pairs` (K3-flow forward, K4 backward): the training
  form over (group, source, frame) pairs, returning the warped features
  and the flow; an `autograd.Function` whose forward is
  `transform_warp_pairs_fwd` and whose backward is the flash backward
  `transform_warp_pairs_bwd`.

The forwards run `csrc/transform_warp.cu` and the backward
`csrc/transform_warp_bwd.cu` on CUDA tensors (see their headers for the
designs and what bounds them), and their plain PyTorch versions on CPU
tensors. A CUDA tensor launches the kernel or raises; nothing falls back.

The kernels take the L2-normalised source features that the callers
already compute (the TPU mean kernel renormalises `src_fea` itself); the
plain versions take the same inputs and compute the same function. The
logits and the flow run in fp32 in every tier (never TF32 or bf16), the
warp is an exact fp32 4-tap gather in every tier, and the backward's two
other products (gtn, gsn) are 3xTF32 tensor-core products, about fp32
accuracy, in every tier; so `fast_warp` (a one-pass bf16 tent matmul on
the TPU) and `bwd_fast3` (bf16x3 backward matmuls on the TPU) are
accepted and change nothing.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .grid_sample import grid_sample
from .precision import tf32


def transform_warp_pairs_plain(src_fea, tar_fea_n, src_fea_n, tar_mask,
                               src_mask, grid, h: int, w: int,
                               temp: float = 100.0, dtype=torch.float32):
    """Plain version of K3-flow, differentiable in every input.

    src_fea, src_fea_n (G, NS, T, C); tar_fea_n (G, NF, Tt, C); tar_mask
    (G, NF, Tt); src_mask (G, NS, T); grid (T, 2); Tt target rows, T of
    them or, under spatial partitioning (`ops.similarity`), a rank's
    share. Returns warped (G, NS, NF, Tt, C), flow (G, NS, NF, Tt, 2) and
    each row's softmax log-sum-exp (G, NS, NF, Tt), computed in `dtype`
    (f32; float64 makes the reference the kernels' rounding is measured
    against).
    """
    g, ns, t, c = src_fea.shape
    nf, tt = tar_fea_n.shape[1:3]
    mt = tar_mask.to(dtype)[:, :, :, None]                    # (G, NF, Tt, 1)
    warped, flows, lses = [], [], []
    for si in range(ns):
        ms = src_mask.to(dtype)[:, si, None, None, :]         # (G, 1, 1, T)
        with tf32(False):
            logits = torch.matmul(tar_fea_n.to(dtype),
                                  src_fea_n[:, si, None].to(dtype).transpose(
                                      -1, -2))                # (G, NF, Tt, T)
            z = temp * (logits * (mt * ms + (1.0 - mt) * (1.0 - ms)))
            flow = torch.matmul(torch.softmax(z, dim=-1), grid.to(dtype))
        img = src_fea[:, si, None].to(dtype).expand(g, nf, t, c)
        warped.append(grid_sample(img.reshape(g * nf, h, w, c),
                                  flow.reshape(g * nf, 1, tt, 2)
                                  ).reshape(g, nf, tt, c))
        flows.append(flow)
        lses.append(torch.logsumexp(z, dim=-1))
    return torch.stack(warped, 1), torch.stack(flows, 1), torch.stack(lses, 1)


def transform_warp_pairs_nf_plain(src_fea, tar_fea_n, src_fea_n, tar_mask,
                                  src_mask, grid, h: int, w: int,
                                  temp: float = 100.0) -> torch.Tensor:
    """Plain version of K3-nf: (S, F, T, C) f32 warped features.

    src_fea, src_fea_n (S, T, C); tar_fea_n (F, T, C); tar_mask (F, T);
    src_mask (S, T); grid (T, 2): one group of the pairs form.
    """
    warped, _, _ = transform_warp_pairs_plain(
        src_fea[None], tar_fea_n[None], src_fea_n[None], tar_mask[None],
        src_mask[None], grid, h, w, temp)
    return warped[0]


def transform_warp_mean_plain(src_fea, tar_fea_n, src_fea_n, tar_mask,
                              src_mask, grid, h: int, w: int,
                              temp: float = 100.0,
                              out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of K1: (F, T, C) mean over sources in `out_dtype`."""
    return transform_warp_pairs_nf_plain(
        src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask, grid, h, w,
        temp).mean(dim=0).to(out_dtype)


def transform_warp_pairs_bwd_plain(src_fea, tar_fea_n, src_fea_n, tar_mask,
                                   src_mask, grid, g_warped, g_flow, h: int,
                                   w: int, temp: float = 100.0,
                                   dtype=torch.float32):
    """Plain version of K4: autograd through `transform_warp_pairs_plain`
    in `dtype`.

    g_warped (G, NS, NF, T, C), g_flow (G, NS, NF, T, 2). Returns the
    cotangents of (src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask,
    grid), in that order.
    """
    inputs = [x.detach().to(dtype).requires_grad_(True) for x in (
        src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask, grid)]
    with torch.enable_grad():
        warped, flow, _ = transform_warp_pairs_plain(*inputs, h, w, temp,
                                                     dtype)
        return torch.autograd.grad((warped, flow), inputs,
                                   (g_warped.to(dtype), g_flow.to(dtype)))


def _check_cuda(what, tensors: dict):
    """Raise unless every (tensor, shape) is a contiguous f32 CUDA tensor
    of that shape on one device."""
    dev = next(iter(tensors.values()))[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what} kernel: tensors on {dev}; it runs on CUDA "
                         "tensors (CPU tensors take the plain version)")
    for name, (x, shape) in tensors.items():
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"{what} kernel: {name} must be float32 on "
                             f"{dev}, got {x.dtype} on {x.device}")
        if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
            raise ValueError(f"{what} kernel: {name} must be a contiguous "
                             f"{tuple(shape)}, got {tuple(x.shape)}")


def _pairs_shapes(src_fea, tar_fea_n, h, w):
    g, ns, t, c = src_fea.shape
    nf = tar_fea_n.shape[1]
    if t != h * w:
        raise ValueError(f"transform_warp kernel: T={t} != h*w={h * w}")
    return g, ns, nf, t, c


def _pairs_specs(src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask, grid,
                 h, w) -> dict:
    """The (tensor, shape) each pairs-form input must have."""
    g, ns, nf, t, c = _pairs_shapes(src_fea, tar_fea_n, h, w)
    return {"src_fea": (src_fea, (g, ns, t, c)),
            "tar_fea_n": (tar_fea_n, (g, nf, t, c)),
            "src_fea_n": (src_fea_n, (g, ns, t, c)),
            "tar_mask": (tar_mask, (g, nf, t)),
            "src_mask": (src_mask, (g, ns, t)),
            "grid": (grid, (t, 2))}


def _launch_fwd(out, mean, src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask,
                grid, h, w, temp, flow=None, lse=None):
    """One launch of `csrc/transform_warp.cu` on (G, S, T, C) inputs."""
    g, s, t, c = src_fea.shape
    f = tar_fea_n.shape[1]
    lib = _library()
    p = cuda_build.ptr
    none = ctypes.c_void_p(None)
    with torch.cuda.device(src_fea.device):
        err = lib.tsnet_transform_warp(
            p(src_fea), p(src_fea_n), p(src_mask), p(tar_fea_n), p(tar_mask),
            p(grid), p(out), none if flow is None else p(flow),
            none if lse is None else p(lse), g, s, f, t, c, h, w,
            float(temp), int(mean), int(out.dtype == torch.bfloat16),
            cuda_build.stream_of(src_fea))
    cuda_build.check_launch(lib, err, "transform_warp")


def _clip_as_group(src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask):
    """The clip inputs (S, T, C) / (F, T, C) as one group (views)."""
    return (src_fea[None], tar_fea_n[None], src_fea_n[None], tar_mask[None],
            src_mask[None])


def transform_warp_pairs_nf(src_fea, tar_fea_n, src_fea_n, tar_mask,
                            src_mask, grid, h: int, w: int,
                            temp: float = 100.0) -> torch.Tensor:
    """K3-nf: (S, F, T, C) f32 warped features of every pair."""
    if src_fea.device.type == "cpu":
        return transform_warp_pairs_nf_plain(src_fea, tar_fea_n, src_fea_n,
                                             tar_mask, src_mask, grid, h, w,
                                             temp)
    group = _clip_as_group(src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask)
    _check_cuda("transform_warp", _pairs_specs(*group, grid, h, w))
    s, t, c = src_fea.shape
    f = tar_fea_n.shape[0]
    out = torch.empty((s, f, t, c), dtype=torch.float32, device=src_fea.device)
    _launch_fwd(out, False, *group, grid, h, w, temp)
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
    group = _clip_as_group(src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask)
    _check_cuda("transform_warp", _pairs_specs(*group, grid, h, w))
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"transform_warp kernel: out_dtype {out_dtype} is "
                         "neither float32 nor bfloat16")
    t, c = src_fea.shape[1:]
    f = tar_fea_n.shape[0]
    out = torch.empty((f, t, c), dtype=out_dtype, device=src_fea.device)
    _launch_fwd(out, True, *group, grid, h, w, temp)
    cuda_build.LAUNCHES["transform_warp_pairs_mean"] += 1
    return out


def transform_warp_pairs_fwd(src_fea, tar_fea_n, src_fea_n, tar_mask,
                             src_mask, grid, h: int, w: int,
                             temp: float = 100.0):
    """K3-flow: (warped (G, NS, NF, T, C), flow (G, NS, NF, T, 2),
    lse (G, NS, NF, T)), all f32; lse is each row's softmax log-sum-exp,
    the residual the backward kernel reads."""
    if src_fea.device.type == "cpu":
        return transform_warp_pairs_plain(src_fea, tar_fea_n, src_fea_n,
                                          tar_mask, src_mask, grid, h, w,
                                          temp)
    _check_cuda("transform_warp", _pairs_specs(
        src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask, grid, h, w))
    g, ns, nf, t, c = _pairs_shapes(src_fea, tar_fea_n, h, w)
    kw = dict(dtype=torch.float32, device=src_fea.device)
    out = torch.empty((g, ns, nf, t, c), **kw)
    flow = torch.empty((g, ns, nf, t, 2), **kw)
    lse = torch.empty((g, ns, nf, t), **kw)
    _launch_fwd(out, False, src_fea, tar_fea_n, src_fea_n, tar_mask,
                src_mask, grid, h, w, temp, flow, lse)
    cuda_build.LAUNCHES["transform_warp_pairs"] += 1
    return out, flow, lse


# K4's launches in the order they run, by the bit that selects each
# (csrc/transform_warp_bwd.cu); each reads what the ones before it wrote
BWD_PHASES = ("warp_bwd", "da_sort", "da_sum", "logits", "gtn", "gsn",
              "reduce")
_BWD_ALL = (1 << len(BWD_PHASES)) - 1
_BWD_TM = 64   # target rows per logit block (TM of the logit tile)


def transform_warp_pairs_bwd(src_fea, tar_fea_n, src_fea_n, tar_mask,
                             src_mask, grid, flow, lse, g_warped, g_flow,
                             h: int, w: int, temp: float = 100.0):
    """K4: the cotangents of (src_fea, tar_fea_n, src_fea_n, tar_mask,
    src_mask, grid) given those of (warped, flow).

    flow and lse are K3-flow's outputs for the same inputs. On CPU
    tensors the plain version recomputes them instead.
    """
    if src_fea.device.type == "cpu":
        return transform_warp_pairs_bwd_plain(
            src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask, grid,
            g_warped, g_flow, h, w, temp)
    launch, (da, gtn, gsn, gmt, gms, gg_part) = bwd_launcher(
        src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask, grid, flow, lse,
        g_warped, g_flow, h, w, temp)
    launch()
    cuda_build.LAUNCHES["transform_warp_pairs_bwd"] += 1
    return da, gtn, gsn, gmt, gms, gg_part.sum(dim=(0, 1))


def bwd_launcher(src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask, grid,
                 flow, lse, g_warped, g_flow, h: int, w: int,
                 temp: float = 100.0):
    """K4's checks, outputs and scratch for these CUDA inputs, without a
    launch: returns (launch, (da, gtn, gsn, gmt, gms, gg_part)), the
    outputs filled once every launch has run (gg_part: ggrid's partial per
    (group, source)). launch(phases) runs the launches whose bits `phases`
    sets (bit i: BWD_PHASES[i]; all by default) and counts nothing, so a
    caller may time them apart, each after the ones before it have run."""
    g, ns, nf, t, c = _pairs_shapes(src_fea, tar_fea_n, h, w)
    _check_cuda("transform_warp_bwd", {
        **_pairs_specs(src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask,
                       grid, h, w),
        "flow": (flow, (g, ns, nf, t, 2)), "lse": (lse, (g, ns, nf, t)),
        "g_warped": (g_warped, (g, ns, nf, t, c)),
        "g_flow": (g_flow, (g, ns, nf, t, 2))})
    kw = dict(dtype=torch.float32, device=src_fea.device)
    tp = -(-t // 4) * 4                  # gL rows padded to 16 bytes
    nrt = -(-t // _BWD_TM)
    gflow = torch.empty((g, ns, nf, t, 2), **kw)
    da = torch.empty((g, ns, t, c), **kw)
    gtn = torch.empty((g, nf, t, c), **kw)
    gsn = torch.empty((g, ns, t, c), **kw)
    gmt = torch.empty((g, nf, t), **kw)
    gms = torch.empty((g, ns, t), **kw)
    gg_part = torch.empty((g, ns, t, 2), **kw)
    # da's counting sort: keys, ranks and order of the 4 NF T corner
    # contributions of each (group, source), and its T + 1 bucket offsets
    da_part = torch.empty(g * ns * (3 * 4 * nf * t + t + 1),
                          dtype=torch.int32, device=src_fea.device)
    gl = torch.empty((g, ns, nf, t, tp), **kw)
    glt = torch.empty((g, nf, ns, t, tp), **kw)
    gmt_part = torch.empty((g, ns, nf, t), **kw)
    col_part = torch.empty((g, ns, nf, nrt, t, 3), **kw)
    lib = _bwd_library()
    p = cuda_build.ptr

    def launch(phases: int = _BWD_ALL) -> None:
        with torch.cuda.device(src_fea.device):
            err = lib.tsnet_transform_warp_bwd(
                p(src_fea), p(src_fea_n), p(src_mask), p(tar_fea_n),
                p(tar_mask), p(grid), p(flow), p(lse), p(g_warped),
                p(g_flow), p(gflow), p(da), p(gtn), p(gsn), p(gmt), p(gms),
                p(gg_part), p(da_part), p(gl), p(glt), p(gmt_part),
                p(col_part), g, ns, nf, t, c, h, w, float(temp), phases,
                cuda_build.stream_of(src_fea))
        cuda_build.check_launch(lib, err, "transform_warp_bwd")

    return launch, (da, gtn, gsn, gmt, gms, gg_part)


class _TransformWarpPairs(torch.autograd.Function):
    """K3-flow forward, K4 backward (CUDA tensors)."""

    @staticmethod
    def forward(ctx, src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask, grid,
                h, w, temp):
        warped, flow, lse = transform_warp_pairs_fwd(
            src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask, grid, h, w,
            temp)
        ctx.save_for_backward(src_fea, tar_fea_n, src_fea_n, tar_mask,
                              src_mask, grid, flow, lse)
        ctx.hw_temp = (h, w, temp)
        return warped, flow

    @staticmethod
    def backward(ctx, g_warped, g_flow):
        *inputs, flow, lse = ctx.saved_tensors
        if g_warped is None:
            g, ns, t, c = inputs[0].shape
            g_warped = flow.new_zeros((g, ns, flow.shape[2], t, c))
        g_warped = g_warped.float().contiguous()
        g_flow = (torch.zeros_like(flow) if g_flow is None
                  else g_flow.float().contiguous())
        grads = transform_warp_pairs_bwd(*inputs, flow, lse, g_warped, g_flow,
                                         *ctx.hw_temp)
        return tuple(gr if need else None for gr, need in
                     zip(grads, ctx.needs_input_grad)) + (None, None, None)


def transform_warp_pairs(src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask,
                         grid, h: int, w: int, temp: float = 100.0,
                         fast_warp: bool = False, bwd_fast3: bool = False):
    """Differentiable transformation branch over (group, source, frame)
    pairs: (warped (G, NS, NF, T, C), flow (G, NS, NF, T, 2)) in f32.

    Inputs as `transform_warp_pairs_plain`. CUDA tensors run K3-flow
    forward and K4 backward; CPU tensors the plain version under
    autograd. `fast_warp` and `bwd_fast3` are accepted for the JAX
    package's signature and ignored: the port's warp and backward run at
    one precision in every tier (see the module docstring).
    """
    del fast_warp, bwd_fast3
    if src_fea.device.type == "cpu":
        warped, flow, _ = transform_warp_pairs_plain(
            src_fea, tar_fea_n, src_fea_n, tar_mask, src_mask, grid, h, w,
            temp)
        return warped, flow
    return _TransformWarpPairs.apply(src_fea, tar_fea_n, src_fea_n, tar_mask,
                                     src_mask, grid, h, w, temp)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library("transform_warp")
    fn = lib.tsnet_transform_warp
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = cuda_build.load_library("transform_warp_bwd")
    fn = lib.tsnet_transform_warp_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 22 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib
