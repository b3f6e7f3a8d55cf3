"""The fused instance-norm kernels (CUDA) and their plain versions.

Counterparts of the JAX package's `ops/pallas_norms.py`:

- `instance_norm_mean` (K2): for x (S, F, H, W, C), the instance norm of
  each (s, f) plane averaged over S, without writing the per-pair
  normalised tensor; `csrc/in_mean.cu`.
- `instance_norm_fused` (K8, the TPU's `_stats_kernel` and `_norm_kernel`
  behind one entry point): the instance norm (+ relu) of an NHWC tensor;
  with `phase_groups=g` the statistics pool the g channel groups (the
  2x2 phase layout of `ops/warp.py:space_to_depth` for g=4);
  `csrc/in_fused.cu`. One launch that reads x once where a thread-block
  cluster holds a (sample, channel slab) unit (`fused_plan`), else three
  (statistics, finalize, normalise). Inference only, as in the JAX
  package. `two_pass=True` takes the two-pass statistics of the port's
  fp32 `ops.norms.instance_norm` instead, on the cluster path only.

`instance_norm_routed` is the one route of the generator's instance norms
(+ ReLU): the encoders' stems and stride-2 convs, the ResNet blocks,
FuseNet's per-pair norm in `fuse_clip`, and the phase decoder's up
stages. Where `fuses_norm` says so (a CUDA tensor through which no
gradient flows, with `use_kernels` set) it is one K8 launch, in the
statistics form the composition has for x's dtype; everywhere else the
ATen composition runs, bit for bit: on the CPU, while a gradient flows
(training) and with `use_kernels=False`. Which tiers let their norms
take K8 is the caller's choice, made through `use_kernels`
(`nn.blocks.norms_on_k8`).

Each runs its CUDA source on CUDA tensors (see its header for the design
and what bounds it) and its plain version on CPU tensors. A CUDA tensor
launches the kernel or raises; nothing falls back.

K2 is differentiable. On the GPU its backward recomputes the plain
composition and backpropagates through it, as the JAX package's
`_in_mean_bwd` does with `_in_mean_ref`; the TPU has no backward kernel
here, so neither has the port. On the CPU autograd runs through the
plain version itself.

K2's statistics are one-pass fp32 (E[x²] - E[x]², clamped at 0), as the
TPU kernel's; its plain version is the JAX package's composition
`_in_mean_ref`: the fp32 two-pass `instance_norm` of each plane, then the
mean. The two agree to float rounding. K8's plain version follows the TPU
kernels' numerics instead (one-pass fp32 sums for both dtypes), since the
JAX entry has no composition of its own beside them; its two-pass form's
plain version (`instance_norm_two_pass_plain`) is `ops.norms`'s fp32
two-pass composition, ReLU in fp32 and one rounding.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import cuda_build
from .norms import instance_norm, instance_norm_one_pass, instance_norm_phase

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


# A K2 block's tile: 128 pixels of one frame and 64 channels. A plane of
# at most MAX_CLUSTER tiles takes the cluster path (one launch, x read once);
# a larger one the two-pass path (statistics, then normalise and mean).
TILE = 128
MAX_CLUSTER = 8

# The two-pass path's launches, by the bit that selects each
# (csrc/in_mean.cu); the cluster path is one launch.
PHASES = ("stats", "mean")


def mean_tiles(h: int, w: int) -> int:
    """The tiles of an h x w plane."""
    return -(-(h * w) // TILE)


def mean_cluster_size(h: int, w: int) -> int:
    """The cluster of K2's cluster path for an h x w plane (its tiles), or
    0 where the plane takes the two-pass path."""
    n = mean_tiles(h, w)
    return n if n <= MAX_CLUSTER else 0


def _launch(x: torch.Tensor, eps: float, out_dtype) -> torch.Tensor:
    launch, out = launcher(x, eps, out_dtype)
    launch()
    cuda_build.LAUNCHES["instance_norm_mean"] += 1
    return out


def launcher(x: torch.Tensor, eps: float = 1e-5, out_dtype=None,
             two_pass=None):
    """K2's checks, output and scratch for this CUDA input, without a
    launch: returns (launch, out). The path follows from the plane
    (`mean_cluster_size`); `two_pass=True` takes the two-pass path for
    any plane.
    launch(phases) runs the two-pass path's launches whose bits `phases`
    sets (bit i: PHASES[i]; both by default), and the cluster path's one
    launch for any bits; it counts nothing."""
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
    if two_pass is None:
        two_pass = mean_cluster_size(h, w) == 0
    # 16-byte copies where C and the pointer allow them, else one element
    vec = int(c % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0)
    out = torch.empty((f, h, w, c), dtype=out_dtype, device=x.device)
    stats = (torch.empty((s, f, c, 2), dtype=torch.float32, device=x.device)
             if two_pass else None)
    lib = _library()

    def launch(phases: int = (1 << len(PHASES)) - 1) -> None:
        with torch.cuda.device(x.device):
            err = lib.tsnet_in_mean(
                cuda_build.ptr(x), cuda_build.ptr(out),
                None if stats is None else cuda_build.ptr(stats), s, f, h * w,
                c, int(x.dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16), vec, int(two_pass), phases,
                float(eps), cuda_build.stream_of(x))
        cuda_build.check_launch(lib, err, "instance_norm_mean")

    return launch, out


def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library("in_mean")
    fn = lib.tsnet_in_mean
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def instance_norm_fused_plain(x: torch.Tensor, eps: float = 1e-5,
                              relu: bool = False, phase_groups: int = 1,
                              out_dtype=None) -> torch.Tensor:
    """The TPU kernels' instance norm (+ relu) of an NHWC tensor.

    x (B, H, W, C). One-pass fp32 sums per (b, c) for both dtypes; with
    `phase_groups=g` the sums of the g groups of C // g channels pool,
    over n * g values; var = max(E[x²] - E[x]², 0); (x - mean) *
    rsqrt(var + eps), relu in fp32, one cast to `out_dtype` (x's dtype by
    default).
    """
    b, h, w, c = x.shape
    g = phase_groups
    count = h * w * g
    xf = x.float().reshape(b, h * w, c)
    sums = xf.sum(dim=1).reshape(b, g, c // g).sum(dim=1)
    sqs = (xf * xf).sum(dim=1).reshape(b, g, c // g).sum(dim=1)
    mean = sums / count
    var = torch.clamp(sqs / count - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    y = (xf - mean.repeat(1, g)[:, None]) * inv.repeat(1, g)[:, None]
    if relu:
        y = torch.relu(y)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    return y.reshape(b, h, w, c).to(out_dtype)


def instance_norm_two_pass_plain(x: torch.Tensor, eps: float = 1e-5,
                                relu: bool = False, phase_groups: int = 1,
                                out_dtype=None) -> torch.Tensor:
    """K8's two-pass form: `ops.norms.instance_norm_phase`'s fp32
    two-pass statistics (mean, then E[(x - mean)²]) over space and the
    `phase_groups` groups, whatever x's dtype; relu in fp32, one cast to
    `out_dtype` (x's dtype by default)."""
    b, h, w, c = x.shape
    g = phase_groups
    xf = x.float().reshape(b, h, w, g, c // g)
    dims = (1, 2, 3)
    mean = xf.mean(dim=dims, keepdim=True)
    d = xf - mean
    var = (d * d).mean(dim=dims, keepdim=True)
    y = d * torch.rsqrt(var + eps)
    if relu:
        y = torch.relu(y)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    return y.reshape(b, h, w, c).to(out_dtype)


def instance_norm_fused(x: torch.Tensor, eps: float = 1e-5,
                        relu: bool = False, phase_groups: int = 1,
                        two_pass: bool = False) -> torch.Tensor:
    """K8: instance_norm (+ relu) of an NHWC tensor, f32 or bf16.

    x (B, H, W, C) -> the same shape and dtype. With `phase_groups=g > 1`
    the channel axis is (g, C // g) and the statistics reduce over the g
    groups as well. Any H, W and C (C a multiple of g). `two_pass=True`:
    the two-pass statistics (`instance_norm_two_pass_plain`), which only
    the cluster path has; a shape no cluster covers is refused. Inference
    only: a CUDA-bound tensor that requires grad while grad mode is on is
    refused.
    """
    if x.device.type == "cpu":
        plain = (instance_norm_two_pass_plain if two_pass
                 else instance_norm_fused_plain)
        return plain(x, eps, relu, phase_groups)
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("instance_norm_fused kernel: inference only (no "
                         "gradient, as in the JAX package); x requires grad")
    launch, out = fused_launcher(x, eps, relu, phase_groups,
                                 two_pass=two_pass)
    launch()
    cuda_build.LAUNCHES["instance_norm_fused"] += 1
    return out


def fuses_norm(x: torch.Tensor, use_kernels: bool = True,
               norms: dict | None = None, phase_groups: int = 1,
               two_pass: bool = False) -> bool:
    """Whether the instance norm of x runs through K8: x is on CUDA,
    `use_kernels` is set, no gradient flows through x (K8 is inference
    only) and, for the `two_pass` form, a cluster covers x (`fused_plan`;
    the three-launch path has no two-pass form). Counts the norm in
    `norms` (a `utils.profiling` counter, or None) by the route it
    takes."""
    fused = (use_kernels and x.device.type == "cuda"
             and not (torch.is_grad_enabled() and x.requires_grad))
    if fused and two_pass:
        b, h, w, c = x.shape
        fused = fused_plan(h * w, c, phase_groups, x.element_size(),
                           x.data_ptr() % 16 == 0).path == "cluster"
    if norms is not None:
        norms["fused" if fused else "plain"] += 1
    return fused


def instance_norm_routed(x: torch.Tensor, norms: dict | None,
                         relu: bool = False, phase_groups: int = 1,
                         use_kernels: bool = True, one_pass: bool = False,
                         eps: float = 1e-5) -> torch.Tensor:
    """instance_norm (+ relu) of an NHWC x by its route (`fuses_norm`),
    counted in `norms`.

    The composition is `ops.norms.instance_norm` (`instance_norm_phase`
    with `phase_groups` > 1), two-pass statistics for fp32 and one-pass
    for bf16, then the ReLU; with `one_pass` it is
    `ops.norms.instance_norm_one_pass` (one-pass for both dtypes, the
    phase decoder's up stages). Through K8 the statistics keep that form:
    `two_pass` for fp32 unless `one_pass`."""
    two_pass = x.dtype == torch.float32 and not one_pass
    xc = x.contiguous()
    if fuses_norm(xc, use_kernels, norms, phase_groups, two_pass):
        return instance_norm_fused(xc, eps, relu, phase_groups,
                                   two_pass=two_pass)
    if one_pass:
        return instance_norm_one_pass(x, eps, phase_groups, relu)
    y = (instance_norm(x, eps) if phase_groups == 1
         else instance_norm_phase(x, eps, phase_groups))
    return torch.relu(y) if relu else y


# K8's cluster path takes a unit of work, (sample, slab of SEGMENT bytes of
# channels of each phase group, or 32 or 16 where C/G does not allow it)
# over all N pixels, in a cluster of as few blocks as hold it, up to
# MAX_FUSED_CLUSTER; a block holds its part of the unit in 16-byte chunks,
# one slot of a pixel's chunks a thread, REG_CHUNKS of a thread's chunks
# in registers and the rest in at most MAX_FUSED_SMEM bytes of shared
# memory (csrc/in_fused.cu). Fewer blocks a cluster wait less on each
# other: on the H100, at the phase decoder's block norm (B=64, 1024
# pixels, 512 channels, bf16) one block a unit took 78 us where 16
# blocks of 64 pixels took 785; at B <= 8, where every cluster size
# takes 13-30 us, none gained more than 6 us over the fewest blocks.
# What no such cluster covers takes the three-launch path (statistics,
# finalize, normalise), which reads x twice.
SEGMENT = 64
CHUNK = 16
FUSED_THREADS = 256
MAX_FUSED_CLUSTER = 16
MAX_FUSED_SMEM = 208 * 1024
REG_CHUNKS = 12

FUSED_PATHS = ("cluster", "three_launch")
# The three-launch path's launches, by the bit that selects each
# (csrc/in_fused.cu); the cluster path is one launch.
FUSED_PHASES = ("stats", "finalize", "norm")


class FusedPlan(NamedTuple):
    """How K8 runs a call: its path, and on the cluster path the channels
    of a slab, the blocks of a cluster, the pixels of a block and the
    dynamic shared memory of a block (0 on the three-launch path)."""
    path: str
    slab: int
    cluster: int
    rows_per_block: int
    smem_bytes: int


def fused_plan(n: int, c: int, groups: int, itemsize: int,
               aligned: bool = True) -> FusedPlan:
    """K8's path for N = n pixels, C = c channels in `groups` phase groups
    of `itemsize`-byte elements; `aligned`: x starts on a 16-byte
    boundary. The cluster path needs C/G in whole 16-byte chunks and a
    unit within MAX_FUSED_CLUSTER blocks' registers and MAX_FUSED_SMEM;
    it takes the fewest blocks that hold the unit."""
    three = FusedPlan("three_launch", 0, 0, 0, 0)
    cg = c // groups
    vec = CHUNK // itemsize
    if not aligned or cg % vec:
        return three
    slab = next(k for k in (SEGMENT // itemsize, 32 // itemsize, vec)
                if cg % k == 0)
    slots = groups * (slab // vec)       # 16-byte chunks of a pixel
    if slots > FUSED_THREADS:
        return three
    lanes = FUSED_THREADS // slots       # pixels the block's threads take
    # the most pixels a block holds: REG_CHUNKS chunks a thread in
    # registers, the rest in MAX_FUSED_SMEM
    most = lanes * (REG_CHUNKS + MAX_FUSED_SMEM // (FUSED_THREADS * CHUNK))
    cluster = -(-n // most)
    if cluster > MAX_FUSED_CLUSTER:
        return three
    rows = -(-n // cluster)
    cluster = -(-n // rows)
    smem = max(0, -(-rows // lanes) - REG_CHUNKS) * FUSED_THREADS * CHUNK
    return FusedPlan("cluster", slab, cluster, rows, smem)


def _fused_check(x: torch.Tensor, phase_groups: int) -> None:
    if x.dim() != 4:
        raise ValueError("instance_norm_fused kernel: x must be (B, H, W, C), "
                         f"got {tuple(x.shape)}")
    c = x.shape[-1]
    if phase_groups < 1 or c % phase_groups:
        raise ValueError(f"instance_norm_fused kernel: C={c} is not a "
                         f"multiple of phase_groups={phase_groups}")
    if x.dtype not in _DTYPES:
        raise ValueError("instance_norm_fused kernel: x must be float32 or "
                         f"bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("instance_norm_fused kernel: x must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_fused kernel: x on {x.device}; it "
                         "runs on CUDA tensors (CPU tensors take the plain "
                         "version)")
    if x.numel() == 0:
        raise ValueError("instance_norm_fused kernel: empty x "
                         f"{tuple(x.shape)}")


def fused_launcher(x: torch.Tensor, eps: float = 1e-5, relu: bool = False,
                   phase_groups: int = 1, path=None, two_pass: bool = False):
    """K8's checks, plan, output and scratch for this CUDA input, without a
    launch: returns (launch, out). The path follows from the shape
    (`fused_plan`); `path` forces one of FUSED_PATHS. `two_pass` takes
    the two-pass statistics, on the cluster path only.
    launch(phases) runs the three-launch path's launches whose bits
    `phases` sets (bit i: FUSED_PHASES[i]; all by default), and the
    cluster path's one launch for any bits; it counts nothing."""
    _fused_check(x, phase_groups)
    b, h, w, c = x.shape
    n = h * w
    plan = fused_plan(n, c, phase_groups, x.element_size(),
                      x.data_ptr() % 16 == 0)
    if path not in (None, *FUSED_PATHS):
        raise ValueError(f"instance_norm_fused kernel: path {path!r} is not "
                         f"one of {FUSED_PATHS}")
    if path not in (None, plan.path, "three_launch"):
        raise ValueError(f"instance_norm_fused kernel: no cluster covers "
                         f"{tuple(x.shape)} {x.dtype} with phase_groups="
                         f"{phase_groups}")
    if two_pass and (path == "three_launch" or plan.path != "cluster"):
        raise ValueError("instance_norm_fused kernel: the two-pass form runs "
                         f"on the cluster path only; {tuple(x.shape)} "
                         f"{x.dtype} with phase_groups={phase_groups} takes "
                         "the three-launch path")
    out = torch.empty_like(x)
    lib = _fused_library()
    p = cuda_build.ptr
    bf16 = int(x.dtype == torch.bfloat16)
    if path != "three_launch" and plan.path == "cluster":
        def launch(phases: int = (1 << len(FUSED_PHASES)) - 1) -> None:
            with torch.cuda.device(x.device):
                err = lib.tsnet_in_fused_cluster(
                    p(x), p(out), b, n, c, phase_groups, plan.slab,
                    plan.cluster, plan.rows_per_block, plan.smem_bytes, bf16,
                    int(relu), int(two_pass), float(eps),
                    cuda_build.stream_of(x))
            cuda_build.check_launch(lib, err, "instance_norm_fused")

        return launch, out
    # 16-byte loads where C and the pointer allow them, else one channel
    vec = 16 // x.element_size()
    if c % vec or x.data_ptr() % 16:
        vec = 1
    # pixel ranges per sample: about 8 blocks of 256 threads (a full SM)
    # for each SM in all, each range at least 64 pixels
    blocks = 8 * torch.cuda.get_device_properties(
        x.device).multi_processor_count
    slabs = -(-(c // vec) // 256)
    splits = max(1, min(-(-blocks // (b * slabs)), -(-n // 64)))
    f32 = dict(dtype=torch.float32, device=x.device)
    partial = torch.empty((b, splits, 2, c), **f32)
    stats = torch.empty((b, c, 2), **f32)

    def launch(phases: int = (1 << len(FUSED_PHASES)) - 1) -> None:
        with torch.cuda.device(x.device):
            err = lib.tsnet_in_fused(
                p(x), p(out), p(partial), p(stats), b, n, c, phase_groups,
                splits, vec, bf16, int(relu), phases, float(eps),
                cuda_build.stream_of(x))
        cuda_build.check_launch(lib, err, "instance_norm_fused")

    return launch, out


def fused_max_clusters(plan: FusedPlan, dtype) -> int:
    """How many clusters of `plan`'s cluster path for x of `dtype` the
    current CUDA device runs at once."""
    return _max_clusters(plan.cluster, plan.smem_bytes,
                         dtype == torch.bfloat16, torch.cuda.current_device())


@functools.cache
def _max_clusters(cluster: int, smem: int, bf16: bool, device: int) -> int:
    lib = _fused_library()
    n = ctypes.c_int(0)
    cuda_build.check_launch(lib, lib.tsnet_in_fused_max_clusters(
        cluster, smem, int(bf16), ctypes.byref(n)),
        "instance_norm_fused occupancy")
    return n.value


def _fused_library() -> ctypes.CDLL:
    lib = cuda_build.load_library("in_fused")
    fn = lib.tsnet_in_fused
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        cl = lib.tsnet_in_fused_cluster
        cl.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 11
                       + [ctypes.c_float, ctypes.c_void_p])
        cl.restype = ctypes.c_int
        occ = lib.tsnet_in_fused_max_clusters
        occ.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        occ.restype = ctypes.c_int
    return lib
