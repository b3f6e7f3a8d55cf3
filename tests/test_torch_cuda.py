"""The CUDA kernels against their plain versions, on the GPU.

Skips where there is no CUDA device. It imports no JAX, so it also runs
where only PyTorch is installed; there, skip the JAX-pinning conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Small and ragged shapes here (the tile edges: T not a multiple of the
forward's 64-row and 128-column tiles, C not a multiple of its 16-channel
chunks or of 4 (the forward's 4-byte copies; also planes off a 16-byte
boundary), past the backward's 512-channel slab, and one full-width
T = 1024, C = 512 case of each forward form; for the
tensor-core convs K6 and K7, pixels past the 128-row tiles and channel
counts that are not powers of two, and for K6 rows wider than its
128-pixel tile, widths that do not divide it and the shortest reflect;
K7 at each cluster size on its path (1, 2, 4 and 8 tiles) and past it
(the two-pass path), the two paths' bits, and K6's bits; K2 past its
cluster, at ragged planes, on one-element loads and twice for the same
bits; for K5, T and S apart and off the
64-row tiles, real-valued masks; for K8, channel counts off the 16-byte
chunks, views off a 16-byte boundary, more than one 256-chunk slab, units
that fill a cluster of 16 blocks, N ragged across a cluster's blocks and a
unit past the cluster, on both its paths, its phase identity at 2 and 4
groups, and its cluster path as one kernel that gives the same bits),
and the train shape of the backward, with its own ragged edges, every
target on one source pixel (cell edges, corners off the canvas) and a
check that two calls give the same bits in all six cotangents; the toy
face (bit-parity and fast tier) and pose train steps twice for the same
bits; the pose train step's shapes
(K3-flow and K4 at G=10, K2 at (3, 10, 32, 32, 1024)), `crop_faces` with
no host sync, and the toy pose step's kernel path; the pose keypoint
rasterizer on the card against the CPU, and pose `push_keypoints` through
the kernels against the plain path; the `precision="high"` convs (bf16x3)
against a float64 oracle, grouped forms too; `ClipInference`'s frames
through its pinned slots against the plain copy back, bit for bit, and
on a source pack encoded once a job against `tsnet_forward_clip` chunk
by chunk at full width, bit for bit; `cli.profile_stages` reading each
clip span once a call at the toy config; the face config's bf16 decoder
with its eleven norms through K8 against the composition, 11 launches a
call, under grad none, and a `ClipInference` job with and without that
route; K8's two-pass form at the clip's trunk shapes against its plain
version, its one-pass form at FuseNet's pair norm, the one-pass entry's
bits as they were before the two-pass form, and `decode_with_sources`
with and without kernels in both clip tiers;
chip_smoke.py checks the main paths' shapes.
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wacv23_tsnet_tpu_torch.configs import toy_config
from wacv23_tsnet_tpu_torch.nn.blocks import conv2d
from wacv23_tsnet_tpu_torch.ops import cuda_build
from wacv23_tsnet_tpu_torch.ops.conv_kernels import (MAX_CLUSTER, conv3x3_in,
                                                     conv3x3_in_plain,
                                                     launcher, resblock_fused,
                                                     tiles)
from wacv23_tsnet_tpu_torch.ops.coords import normalized_grid
from wacv23_tsnet_tpu_torch.ops.dpconv import split_bf16
from wacv23_tsnet_tpu_torch.ops.flow_kernels import (
    masked_attention_flow, masked_attention_flow_fused)
from wacv23_tsnet_tpu_torch.ops.fuse_kernels import (fuse_pair_conv2,
                                                     fuse_pair_conv2_plain)
from wacv23_tsnet_tpu_torch.ops.norm_kernels import (
    fused_launcher, fused_plan, instance_norm_fused, instance_norm_fused_plain,
    instance_norm_mean, instance_norm_mean_plain, instance_norm_two_pass_plain,
    mean_tiles)
from wacv23_tsnet_tpu_torch.ops.norm_kernels import launcher as norm_launcher
from wacv23_tsnet_tpu_torch.ops.norms import l2_normalize
from wacv23_tsnet_tpu_torch.ops.similarity import transformation_warp
from wacv23_tsnet_tpu_torch.ops.warp import space_to_depth
from wacv23_tsnet_tpu_torch.ops.warp_kernels import (
    transform_warp_mean_plain, transform_warp_pairs,
    transform_warp_pairs_bwd, transform_warp_pairs_bwd_plain,
    transform_warp_pairs_fwd, transform_warp_pairs_mean,
    transform_warp_pairs_nf, transform_warp_pairs_nf_plain,
    transform_warp_pairs_plain)

pytestmark = pytest.mark.cuda

# sha256 of K6's output bits in test_fuse_pair_conv2_bits_are_unchanged
K6_SHA256 = "2217aaa72d6cb3bfd23154815262d7ad11def2cd23f1b913cc7520ba2473cbf6"


def _assert_close(got, want, atol=1e-4):
    """f32: 1e-4 absolute (summation order); bf16 out: also one bf16 step
    (2^-8 relative), since a value a rounding away from a tie may round
    the other way."""
    rtol = 0.0 if got.dtype == torch.float32 else 2.0 ** -8
    err = (got.float() - want.float()).abs()
    assert bool((err <= atol + rtol * want.float().abs()).all()), \
        err.max().item()


def _warp_atol(h, w):
    """Warped features at the full width (T = 1024, C = 512) get
    chip_smoke.py's 1e-3 for the same shapes: there 512-term dot products
    and the temp-100 softmax move the flow by ~1e-6 and a warped feature
    by that times its gradient (~50 per unit of flow)."""
    return 1e-3 if h * w >= 1024 else 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _off_16_bytes(x):
    """x as a contiguous view one float past a 16-byte boundary."""
    return torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape)


def _warp_inputs(dev, s, f, h, w, c, offset=False, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    t = h * w
    src = torch.randn(s, t, c, generator=g)
    tar = torch.randn(f, t, c, generator=g)
    sm = (torch.rand(s, t, generator=g) > 0.5).float()
    tm = (torch.rand(f, t, generator=g) > 0.5).float()
    args = [x.to(dev).contiguous() for x in (
        src, l2_normalize(tar), l2_normalize(src), tm, sm,
        normalized_grid(h, w).reshape(t, 2))]
    if offset:  # the normalised planes, which the logit tile reads
        args[1], args[2] = _off_16_bytes(args[1]), _off_16_bytes(args[2])
    return tuple(args)


# (S, F, H, W, C[, normalised planes off a 16-byte boundary]): T = 135 and
# 130 off the 64-row and 128-column tiles; C = 36 and 600 off the 16-channel
# chunks, C = 5 off the 16-byte copies; the clip's full width
SHAPES = [(3, 2, 16, 16, 32), (2, 3, 10, 10, 40), (1, 1, 9, 7, 5),
          (2, 2, 9, 15, 36), (1, 2, 10, 13, 600), (2, 3, 10, 13, 40, True),
          (3, 2, 32, 32, 512)]


@pytest.mark.parametrize("shape", SHAPES)
def test_warp_pairs_nf_kernel(dev, shape):
    s, f, h, w, c = shape[:5]
    args = _warp_inputs(dev, *shape)
    cuda_build.reset_launches()
    got = transform_warp_pairs_nf(*args, h, w)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["transform_warp_pairs_nf"] == 1
    _assert_close(got, transform_warp_pairs_nf_plain(*args, h, w),
                  _warp_atol(h, w))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_warp_mean_kernel(dev, shape, out_dtype):
    s, f, h, w, c = shape[:5]
    args = _warp_inputs(dev, *shape, seed=1)
    cuda_build.reset_launches()
    got = transform_warp_pairs_mean(*args, h, w, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype
    assert cuda_build.LAUNCHES["transform_warp_pairs_mean"] == 1
    _assert_close(got, transform_warp_mean_plain(*args, h, w),
                  _warp_atol(h, w))


@pytest.mark.parametrize("shape", [(3, 4, 8, 8, 64), (2, 3, 5, 7, 40)])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_instance_norm_mean_kernel(dev, shape, in_dtype, out_dtype):
    g = torch.Generator(device="cpu").manual_seed(2)
    x = (torch.randn(*shape, generator=g) * 2 + 1).to(dev, in_dtype)
    cuda_build.reset_launches()
    got = instance_norm_mean(x, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype
    assert cuda_build.LAUNCHES["instance_norm_mean"] == 1
    _assert_close(got, instance_norm_mean_plain(x, out_dtype=torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instance_norm_mean_at_the_pose_train_shape(dev, dtype):
    """K2 at the pose train step's (S, B, 32, 32, 2C) = (3, 10, 32, 32,
    1024): f32 in the bit-parity tier, bf16 in the fast tier."""
    g = torch.Generator(device="cpu").manual_seed(7)
    x = (torch.randn(3, 10, 32, 32, 1024, generator=g) * 2 + 1).to(dev, dtype)
    cuda_build.reset_launches()
    got = instance_norm_mean(x)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["instance_norm_mean"] == 1
    _assert_close(got, instance_norm_mean_plain(x, out_dtype=torch.float32))


def test_instance_norm_mean_degenerate_channel_is_finite(dev):
    x = 300.0 + torch.randn(1, 2, 8, 8, 16) * 1e-3
    assert torch.isfinite(instance_norm_mean(x.to(dev))).all()


def test_instance_norm_mean_takes_a_plane_past_the_cluster(dev):
    """A 64x64 plane is 32 tiles, past the 8-block cluster: it takes the
    two-pass path (statistics, then normalise and mean) and matches the
    plain version, as the JAX entry point takes such a plane."""
    assert mean_tiles(64, 64) == 32
    g = torch.Generator(device="cpu").manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(3, 2, 64, 64, 40, generator=g) * 2 + 1).to(dev, dtype)
        cuda_build.reset_launches()
        got = instance_norm_mean(x)
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES["instance_norm_mean"] == 1
        _assert_close(got, instance_norm_mean_plain(x, out_dtype=torch.float32))


@pytest.mark.parametrize("shape", [(1, 2, 5, 7, 40), (5, 2, 5, 7, 40),
                                   (3, 2, 32, 32, 64), (2, 3, 4, 4, 5)],
                         ids=["s1", "s5", "t8", "c5"])
def test_instance_norm_mean_kernel_is_deterministic(dev, shape):
    """Two calls give the same bits (the statistics are summed in a fixed
    order over the cluster), on the 16-byte copies and, at C = 5, on the
    one-element loads; the forced two-pass path, which sums in another
    order, matches the plain version too."""
    g = torch.Generator(device="cpu").manual_seed(4)
    x = (torch.randn(*shape, generator=g) * 2 + 1).to(dev)
    for xx in (x, x.to(torch.bfloat16)):
        got = instance_norm_mean(xx)
        assert torch.equal(got, instance_norm_mean(xx))
        launch, two = norm_launcher(xx, two_pass=True)
        launch()
        torch.cuda.synchronize()
        want = instance_norm_mean_plain(xx, out_dtype=torch.float32)
        _assert_close(got, want)
        _assert_close(two, want)


def test_instance_norm_mean_off_16_byte_boundary(dev):
    """A view that does not start on a 16-byte boundary takes the
    one-element loads."""
    x = torch.randn(2 * 2 * 8 * 8 * 16 + 1, device=dev)[1:].reshape(
        2, 2, 8, 8, 16)
    _assert_close(instance_norm_mean(x), instance_norm_mean_plain(x))


def _pairs_inputs(dev, g, ns, nf, h, w, c, seed=3):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    t = h * w
    src = torch.randn(g, ns, t, c, generator=gen)
    args = (src, l2_normalize(torch.randn(g, nf, t, c, generator=gen)),
            l2_normalize(src), (torch.rand(g, nf, t, generator=gen) > 0.5
                                ).float(),
            (torch.rand(g, ns, t, generator=gen) > 0.5).float(),
            normalized_grid(h, w).reshape(t, 2))
    return tuple(x.to(dev).contiguous() for x in args)


# (G, NS, NF, H, W, C); the forward's test adds T = 135 with C = 36,
# T = 130 with C = 5, and the train step's width at two groups
PAIRS = [(2, 2, 1, 16, 16, 64), (1, 3, 2, 10, 10, 40), (2, 1, 2, 9, 7, 600)]
FWD_PAIRS = PAIRS + [(2, 3, 1, 9, 15, 36), (1, 2, 1, 10, 13, 5),
                     (2, 3, 1, 32, 32, 512), (10, 3, 1, 32, 32, 512)]


@pytest.mark.parametrize("shape", FWD_PAIRS)
def test_warp_pairs_flow_kernel(dev, shape):
    """K3-flow: warped, flow and the row log-sum-exp."""
    g, ns, nf, h, w, c = shape
    args = _pairs_inputs(dev, *shape)
    cuda_build.reset_launches()
    got = transform_warp_pairs_fwd(*args, h, w)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["transform_warp_pairs"] == 1
    for a, b in zip(got, transform_warp_pairs_plain(*args, h, w)):
        _assert_close(a, b, _warp_atol(h, w))


def _assert_cotangents_close(got, want, rtol=2e-4):
    """Each cotangent within rtol * max(1, max |reference|): sums over T
    rows, sources and each source pixel's bucket in another order."""
    names = ("src_fea", "tar_fea_n", "src_fea_n", "tar_mask", "src_mask",
             "grid")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        scale = max(1.0, b.abs().max().item())
        err = (a - b).abs().max().item()
        assert err <= rtol * scale, (name, err, scale)


# K4 at both temps: PAIRS and the train shape. K4's own edges at temp 10:
# T = 135 and 130, off the 64-row and 128-column logit tiles and the
# 128-row GEMM tiles, with C = 37 and 5 (C % 4 != 0: the 4-byte copies),
# F > 1 (gsn sums over frames) with S > 1 (gtn's depth S * T concatenates
# the sources). At temp 100 the softmax over these few channels is near
# one-hot, and the tar_mask cotangent of any fp32 computation (the plain
# version's too) moves by 1e-4 to 5e-4 of its largest under a last-bit
# change of the logits (measured with the logits summed in another
# order): no 2e-4 check there says anything about the kernel.
BWD_SHAPES = dict(zip(("small", "ragged", "wide", "train", "pose_train"),
                      PAIRS + [(15, 3, 1, 32, 32, 512),
                               (10, 3, 1, 32, 32, 512)]))
BWD_EDGES = {"t135_c37": (1, 2, 3, 9, 15, 37), "t130_c5": (2, 3, 2, 10, 13, 5)}
BWD_CASES = ([pytest.param(shape, temp, id=f"{name}-{temp}")
              for temp in (10.0, 100.0) for name, shape in BWD_SHAPES.items()]
             + [pytest.param(shape, 10.0, id=f"{name}-10.0")
                for name, shape in BWD_EDGES.items()])


@pytest.mark.parametrize("shape,temp", BWD_CASES)
def test_warp_pairs_bwd_kernel(dev, shape, temp):
    """K4 against autograd through the plain forward, given the plain
    forward's own flow and log-sum-exp; at temp 10 also on K3-flow's
    flow, and against the plain version in float64. (At temp 100 the flow
    of random features sits near pixel centres, where the bilinear warp's
    gradient jumps, and two fp32 flows may fall in different cells;
    chip_smoke.py counts such rows.)"""
    g, ns, nf, h, w, c = shape
    args = _pairs_inputs(dev, *shape, seed=4)
    gen = torch.Generator(device="cpu").manual_seed(5)
    g_warped = torch.randn(g, ns, nf, h * w, c, generator=gen).to(dev)
    g_flow = torch.randn(g, ns, nf, h * w, 2, generator=gen).to(dev)
    want = transform_warp_pairs_bwd_plain(*args, g_warped, g_flow, h, w, temp)
    _, plain_flow, plain_lse = transform_warp_pairs_plain(*args, h, w, temp)
    _, flow, lse = transform_warp_pairs_fwd(*args, h, w, temp)
    flows = [(plain_flow, plain_lse)] + ([(flow, lse)] if temp == 10.0 else [])
    for fl, ls in flows:
        cuda_build.reset_launches()
        got = transform_warp_pairs_bwd(*args, fl, ls, g_warped, g_flow, h, w,
                                       temp)
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES["transform_warp_pairs_bwd"] == 1
        assert all(bool(torch.isfinite(x).all()) for x in got)
        _assert_cotangents_close(got, want)
    if temp == 10.0:
        _assert_cotangents_close(got, transform_warp_pairs_bwd_plain(
            *args, g_warped, g_flow, h, w, temp, dtype=torch.float64))


@pytest.mark.parametrize("shape", [(2, 2, 3, 9, 15, 40),
                                   (15, 3, 1, 32, 32, 512),
                                   (10, 3, 1, 32, 32, 512)],
                         ids=["ragged", "train", "pose_train"])
def test_warp_pairs_bwd_kernel_is_deterministic(dev, shape):
    """Every cotangent, da too (a stable counting sort by source pixel,
    then each pixel's sum in that order), is summed in a fixed order: two
    calls give the same bits."""
    g, ns, nf, h, w, c = shape
    args = _pairs_inputs(dev, *shape, seed=12)
    gen = torch.Generator(device="cpu").manual_seed(13)
    g_warped = torch.randn(g, ns, nf, h * w, c, generator=gen).to(dev)
    g_flow = torch.randn(g, ns, nf, h * w, 2, generator=gen).to(dev)
    _, flow, lse = transform_warp_pairs_fwd(*args, h, w)
    first, second = (transform_warp_pairs_bwd(*args, flow, lse, g_warped,
                                              g_flow, h, w)
                     for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_warp_pairs_bwd_kernel_counts_past_shared_memory(dev):
    """T = 96 x 96 = 9216, past the 8192 source pixels whose bucket
    counts da_sort keeps in shared memory: the counts and their scan go
    through the offsets array instead. da against the plain version, and
    all six cotangents the same bits twice. (The other five are not held
    to 2e-4 here: at a reduction depth of 9216 the 3xTF32 gtn product
    drifts past it from float64, where the plain fp32 version stays
    inside; at the model's T = 1024 both are within it.)"""
    g, ns, nf, h, w, c = 1, 1, 1, 96, 96, 8
    args = _pairs_inputs(dev, g, ns, nf, h, w, c, seed=16)
    gen = torch.Generator(device="cpu").manual_seed(17)
    g_warped = torch.randn(g, ns, nf, h * w, c, generator=gen).to(dev)
    g_flow = torch.randn(g, ns, nf, h * w, 2, generator=gen).to(dev)
    _, flow, lse = transform_warp_pairs_plain(*args, h, w, 10.0)
    want = transform_warp_pairs_bwd_plain(*args, g_warped, g_flow, h, w,
                                          10.0)
    first, second = (transform_warp_pairs_bwd(*args, flow, lse, g_warped,
                                              g_flow, h, w, 10.0)
                     for _ in range(2))
    _assert_cotangents_close(first[:1], want[:1])
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _one_pixel_inputs(dev, g, ns, nf, h, w, c, seed=14):
    """Pairs inputs whose every target row attends to one source pixel of
    its (group, source) alone: that pixel's normalised feature equals the
    targets' common one and every other pixel's is its negative, so at
    temp 100 the softmax is exactly one-hot and the flow is that pixel's
    grid point (integer sample positions: cell edges, wx = wy = 0). The
    pixels are on the last row or column, where corners fall off the
    canvas."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    t = h * w
    v = l2_normalize(torch.randn(g, 1, 1, c, generator=gen))
    src_n = -v.expand(g, ns, t, c).clone()
    for gi in range(g):
        for si in range(ns):
            u = (h - 1) * w + (gi + si) % w if (gi + si) % 2 else \
                ((gi + si) % h) * w + w - 1
            src_n[gi, si, u] = v[gi, 0, 0]
    args = (torch.randn(g, ns, t, c, generator=gen), v.expand(g, nf, t, c),
            src_n, torch.ones(g, nf, t), torch.ones(g, ns, t),
            normalized_grid(h, w).reshape(t, 2))
    return tuple(x.to(dev).contiguous() for x in args)


def test_warp_pairs_bwd_kernel_da_on_one_source_pixel(dev):
    """Every target on one source pixel, on a cell edge with corners off
    the canvas (F = 2, C % 4 != 0): one bucket of 4 F T items a (group,
    source), against the plain version, and the same bits twice."""
    g, ns, nf, h, w, c = 2, 2, 2, 8, 8, 37
    args = _one_pixel_inputs(dev, g, ns, nf, h, w, c)
    gen = torch.Generator(device="cpu").manual_seed(15)
    g_warped = torch.randn(g, ns, nf, h * w, c, generator=gen).to(dev)
    g_flow = torch.randn(g, ns, nf, h * w, 2, generator=gen).to(dev)
    _, flow, lse = transform_warp_pairs_plain(*args, h, w)
    want = transform_warp_pairs_bwd_plain(*args, g_warped, g_flow, h, w)
    first, second = (transform_warp_pairs_bwd(*args, flow, lse, g_warped,
                                              g_flow, h, w)
                     for _ in range(2))
    _assert_cotangents_close(first, want)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_warp_pairs_autograd_runs_both_kernels(dev):
    g, ns, nf, h, w, c = PAIRS[0]
    args = [x.requires_grad_(True) if i < 3 else x
            for i, x in enumerate(_pairs_inputs(dev, *PAIRS[0], seed=6))]
    cuda_build.reset_launches()
    warped, flow = transform_warp_pairs(*args, h, w, temp=10.0)
    (warped.square().sum() + flow.sin().sum()).backward()
    assert cuda_build.LAUNCHES["transform_warp_pairs"] == 1
    assert cuda_build.LAUNCHES["transform_warp_pairs_bwd"] == 1
    plain = [x.detach().clone().requires_grad_(True) for x in args[:3]]
    pw, pf, _ = transform_warp_pairs_plain(*plain, *args[3:], h, w, 10.0)
    (pw.square().sum() + pf.sin().sum()).backward()
    _assert_cotangents_close([x.grad for x in args[:3]],
                             [x.grad for x in plain])


def test_instance_norm_mean_gradient(dev):
    """K2's backward (the recomputed plain composition) against autograd
    through the plain version."""
    gen = torch.Generator(device="cpu").manual_seed(7)
    x = (torch.randn(3, 2, 8, 8, 64, generator=gen) * 2 + 1).to(dev)
    g = torch.randn(2, 8, 8, 64, generator=gen).to(dev)
    xk = x.clone().requires_grad_(True)
    cuda_build.reset_launches()
    instance_norm_mean(xk).backward(g)
    assert cuda_build.LAUNCHES["instance_norm_mean"] == 1
    xp = x.clone().requires_grad_(True)
    instance_norm_mean_plain(xp).backward(g)
    assert (xk.grad - xp.grad).abs().max().item() <= 1e-5


@pytest.mark.parametrize("stride,padding", [(1, 0), (2, 1)])
def test_bit_parity_conv_gradient_is_fp32(dev, stride, padding):
    """precision="highest": grad-input and grad-weight against a float64
    CPU reference at 1e-5 relative; a TF32 backward (~1e-3) fails this,
    and cuDNN's process default for fp32 convolutions is TF32."""
    assert torch.backends.cudnn.allow_tf32
    gen = torch.Generator(device="cpu").manual_seed(8)
    x = torch.randn(4, 32, 32, 256, generator=gen)
    wt = torch.randn(256, 256, 3, 3, generator=gen) * 0.05
    gy = torch.randn(4, (32 + 2 * padding - 3) // stride + 1,
                     (32 + 2 * padding - 3) // stride + 1, 256,
                     generator=gen)
    xs, ws = (v.to(dev).requires_grad_(True) for v in (x, wt))
    conv2d(xs, ws, None, stride, padding, precision="highest").backward(
        gy.to(dev))
    xd, wd = (v.double().requires_grad_(True) for v in (x, wt))
    F.conv2d(xd.permute(0, 3, 1, 2), wd, None, stride, padding).backward(
        gy.double().permute(0, 3, 1, 2))
    for got, want in ((xs.grad, xd.grad), (ws.grad, wd.grad)):
        rel = ((got.double().cpu() - want).norm() / want.norm()).item()
        assert rel <= 1e-5, rel


# precision="high" on the card: (x NHWC, w OIHW, stride, (row, column)
# padding, groups) of the model's conv forms at reduced batch: the 7x7
# stem after its reflect pad, a stride-2 down conv, a reflect band's (p,
# 0) conv at 256 channels, the phase decoder's grouped ring convs
HIGH_CASES = {
    "stem7x7": ((2, 70, 70, 5), (64, 5, 7, 7), 1, (0, 0), 1),
    "down_s2": ((2, 64, 64, 64), (128, 64, 3, 3), 2, (1, 1), 1),
    "band": ((2, 32, 34, 256), (256, 256, 3, 3), 1, (1, 0), 1),
    "ring_rows": ((2, 2, 32, 256), (512, 128, 2, 3), 1, (0, 0), 2),
    "ring_corners": ((2, 2, 2, 512), (1024, 128, 2, 2), 1, (0, 0), 4),
    # a ResNet-block conv at 512 channels: hi·hi in four channel pieces
    "wide": ((2, 18, 18, 512), (512, 512, 3, 3), 1, (0, 0), 1),
}


def _bf16x3_oracle(x, w, g, stride, padding, groups):
    """float64 on the inputs' device: an NCHW conv of x and w (OIHW) and its
    grad-input and grad-weight for cotangent g: each as the exact sum of
    the three bf16x3 products of the fp32 splits, and as the full
    product."""
    args = ([stride] * 2, list(padding), [1, 1], False, [0, 0], groups)

    def conv(a, b):
        return F.conv2d(a, b, None, stride, padding, 1, groups)

    def grad_input(gg, b):
        return torch.ops.aten.convolution_backward(
            gg, x64, b, None, *args, [True, False, False])[0]

    def grad_weight(a, gg):
        return torch.ops.aten.convolution_backward(
            gg, a, w64, None, *args, [False, True, False])[1]

    def three(f, a, b):
        return f(a[0], b[0]) + f(a[0], b[1]) + f(a[1], b[0])

    x64, w64, g64 = (t.double() for t in (x, w, g))
    xs, ws, gs = ([v.double() for v in split_bf16(t.float())]
                  for t in (x, w, g))
    return ((three(conv, xs, ws), three(grad_input, gs, ws),
             three(grad_weight, xs, gs)),
            (conv(x64, w64), grad_input(g64, w64), grad_weight(x64, g64)))


@pytest.mark.parametrize("case", list(HIGH_CASES))
def test_high_conv_is_bf16x3_on_the_card(dev, case):
    """precision="high" on a CUDA tensor, forward (with its fp32 bias),
    grad-input and grad-weight, against float64 of the exact bf16x3 sums
    at chip_smoke.py `--high`'s 1e-5 relative L2; TF32 (~3e-4) fails
    this, and so would a dropped product."""
    xs, ws, stride, padding, groups = HIGH_CASES[case]
    gen = torch.Generator(device="cpu").manual_seed(len(case))
    x = torch.randn(*xs, generator=gen)
    wt = torch.randn(*ws, generator=gen) / (ws[1] * ws[2] * ws[3]) ** 0.5
    b = torch.randn(ws[0], generator=gen)
    xd, wd = (v.to(dev).requires_grad_(True) for v in (x, wt))
    y = conv2d(xd, wd, b.to(dev), stride, padding, precision="high",
               groups=groups)
    gy = torch.randn(*y.shape, generator=gen)
    y.backward(gy.to(dev))
    three, full = _bf16x3_oracle(x.permute(0, 3, 1, 2).to(dev), wt.to(dev),
                                 gy.permute(0, 3, 1, 2).to(dev), stride,
                                 padding, groups)
    bias = b.double().to(dev)[:, None, None]
    for i, got in enumerate((y.permute(0, 3, 1, 2),
                             xd.grad.permute(0, 3, 1, 2), wd.grad)):
        got = got.detach().double() - (bias if i == 0 else 0)
        rel, rel_full = (((got - want).norm() / want.norm()).item()
                         for want in (three[i], full[i]))
        # bf16x3, not fp32 either: nearer the three products' sum than
        # the full product, which differs by the dropped lo·lo terms
        assert rel <= 1e-5 and rel < rel_full, (i, rel, rel_full)


def test_split_bf16_on_the_card_is_two_roundings(dev):
    """`split_bf16` on the card: hi = bf16(x) and lo = bf16(x - hi) taken
    in fp32, bit for bit over every binade, signed zeros, subnormals and
    infinities, NaN where they are NaN (whose sign the two forms need not
    share), on a channels-last view (whose layout it keeps)."""
    gen = torch.Generator(device="cpu").manual_seed(21)
    bits = torch.randint(-2 ** 31, 2 ** 31, (1 << 20,), generator=gen,
                         dtype=torch.int64).to(torch.int32)
    x = torch.cat([torch.tensor(
        [0.0, -0.0, 1e-40, -1e-45, float("inf"), -float("inf"),
         float("nan"), 3.3895e38]), bits.view(torch.float32)]).to(dev)
    x = x[:1 << 20].reshape(4, 64, 64, 64).permute(0, 3, 1, 2)
    hi, lo = split_bf16(x)
    want_hi = x.to(torch.bfloat16).float()
    want_lo = (x - want_hi).to(torch.bfloat16).float()
    for got, want in ((hi, want_hi), (lo, want_lo)):
        assert got.is_contiguous(memory_format=torch.channels_last)
        nan = want.isnan()
        assert torch.equal(got.isnan(), nan)
        assert torch.equal(got[~nan].view(torch.int32),
                           want[~nan].view(torch.int32))


# the encoders' 7x7 stems at the clip's shapes: (frames, input channels)
# of the label encoder's 64-frame chunk (label_nc 2 + 3 CoordConv) and
# the image encoder's 3 sources (3 + 2 + 3)
HIGH_STEMS = {"lbl_clip": (64, 5), "img_clip": (3, 8)}


@pytest.mark.parametrize("case", list(HIGH_STEMS))
def test_high_stem_route_is_bf16x3_on_the_card(dev, case):
    """The route `Encoder.forward` takes for its stem under "high" on the
    card (the folded conv), forward with its fp32 bias and the grad-weight,
    against float64 of the exact bf16x3 sums of the 7x7 conv of the
    reflect-padded input: within 1e-5 relative L2 and nearer them than
    cuDNN's single TF32 pass of the same conv."""
    from wacv23_tsnet_tpu_torch.nn.blocks import reflect_pad
    from wacv23_tsnet_tpu_torch.nn.encoder import folds_stem
    from wacv23_tsnet_tpu_torch.ops.precision import tf32
    from wacv23_tsnet_tpu_torch.ops.stemconv import (depth_to_space,
                                                     stem_conv7_fold4)
    assert folds_stem("high", torch.float32, dev.type)
    bs, ci = HIGH_STEMS[case]
    gen = torch.Generator(device="cpu").manual_seed(ci)
    x = torch.randn(bs, 256, 256, ci, generator=gen).to(dev)
    wt = (torch.randn(64, ci, 7, 7, generator=gen) / (ci * 49) ** 0.5).to(dev)
    b = torch.randn(64, generator=gen).to(dev)
    wd = wt.clone().requires_grad_(True)
    y = depth_to_space(stem_conv7_fold4(x, wd, b, "high"), 4)
    gy = torch.randn(*y.shape, generator=gen).to(dev)
    y.backward(gy)
    xp, gc = reflect_pad(x, 3).permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)
    three, _ = _bf16x3_oracle(xp, wt, gc, 1, (0, 0), 1)
    with tf32(True):
        single = (F.conv2d(xp, wt), torch.ops.aten.convolution_backward(
            gc, xp, wt, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1,
            [False, True, False])[1])
    got = (y.detach().permute(0, 3, 1, 2).double()
           - b.double()[:, None, None], wd.grad)
    for i, part in enumerate(("forward", "grad_weight")):
        want = three[2 * i]
        rel, rel_tf32 = (((v.double() - want).norm() / want.norm()).item()
                         for v in (got[i], single[i]))
        print(f"[high] stem {case} {part}: {rel:.3e} (tf32 {rel_tf32:.3e})")
        assert rel <= 1e-5 and rel < rel_tf32, (part, rel, rel_tf32)


def _face_clip_job(cfg, frames, seed):
    """`ClipInference.run`'s host arrays for a face job at full width: a
    disc of class 1 moving across the driving frames and the sources,
    random images."""
    rng = np.random.default_rng(seed)
    s, hw = cfg.n_source, cfg.image_size
    yy, xx = np.mgrid[:hw, :hw]

    def discs(n):
        cy, cx = rng.uniform(0.35, 0.65, (2, n, 1, 1)) * hw
        r = rng.uniform(0.15, 0.3, (n, 1, 1)) * hw
        return ((yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2).astype(np.uint8)

    return (rng.random((s, 3, hw, hw), np.float32) * 255.0, discs(s),
            np.ones((s, hw, hw), np.float32), discs(frames),
            np.ones((frames, hw, hw), np.float32))


def test_face_clip_chunk_high_stem_route_against_the_7x7(dev, monkeypatch):
    """A 64-frame `ClipInference` chunk of `face_config()` in
    `demo_face --fast-tail`'s tier ("high" encoders, `fast_tail`): the
    frames with the folded stems against the same engine with the 7x7
    stems, within the noise of the benchmark's `face.clip-high` cell
    (its frames' mean gap from the plain reference, 0.0056)."""
    from wacv23_tsnet_tpu_torch.configs import face_config
    from wacv23_tsnet_tpu_torch.infer import ClipInference
    from wacv23_tsnet_tpu_torch.models import TSNetModules
    from wacv23_tsnet_tpu_torch.nn import encoder as enc_mod

    cfg = dataclasses.replace(face_config(), precision="high",
                              fast_tail=True)
    engine = ClipInference(cfg, TSNetModules(cfg, device="cuda", seed=0),
                           chunk=64, device="cuda")
    job = _face_clip_job(cfg, 64, 5)
    got = engine.run(*job)
    monkeypatch.setattr(enc_mod, "folds_stem", lambda *a: False)
    want = engine.run(*job)
    gap = np.abs(got - want).mean(axis=(1, 2, 3))
    print(f"[high] face clip chunk, folded vs 7x7 stems: mean "
          f"{gap.mean():.3e}, worst frame {gap.max():.3e}")
    assert np.isfinite(got).all()
    assert gap.mean() <= 0.0056 and gap.max() <= 0.0056


@pytest.mark.parametrize("tier", [
    {"precision": "high", "fast_trunk": True, "fast_tail": True},
    {"precision": "high", "fast_tail": True}], ids=["bench", "fast-tail"])
def test_face_clip_encodes_the_sources_once_a_job(dev, tier):
    """A 130-frame `ClipInference` job of `face_config()` at chunk 64 (3
    chunks, the last wrapped) in the benchmark's clip tier and in
    `demo_face --fast-tail`'s: the frames, on a source pack encoded once
    a job, are the bits of `tsnet_forward_clip` run chunk by chunk, which
    encodes the sources again for every chunk."""
    from wacv23_tsnet_tpu_torch.configs import face_config
    from wacv23_tsnet_tpu_torch.infer import ClipInference
    from wacv23_tsnet_tpu_torch.models import TSNetModules
    from wacv23_tsnet_tpu_torch.models.tsnet import tsnet_forward_clip
    from wacv23_tsnet_tpu_torch.utils.profiling import CLIP_PACKS

    cfg = dataclasses.replace(face_config(), **tier)
    engine = ClipInference(cfg, TSNetModules(cfg, device="cuda", seed=0),
                           chunk=64, device="cuda")
    job = _face_clip_job(cfg, 130, 6)
    before = dict(CLIP_PACKS)
    got = engine.run(*job)
    assert CLIP_PACKS == {"encoded": before["encoded"] + 1,
                          "reused": before["reused"] + 2}
    src = engine.prepare_sources(*job[:3])
    tar_lbl = engine._onehot(job[3])
    tar_bbox = torch.as_tensor(job[4], device=dev)
    outs = []
    with torch.inference_mode():
        for lo in range(0, 130, 64):
            idx = torch.arange(lo, lo + 64, device=dev) % 130
            rec = tsnet_forward_clip(engine.mods, *src, tar_lbl[idx],
                                     tar_bbox[idx], device=dev)
            outs.append(rec[:min(64, 130 - lo)])
    want = torch.cat(outs).permute(0, 3, 1, 2).cpu().numpy()
    assert got.shape == want.shape == (130, 3, cfg.image_size,
                                       cfg.image_size)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


# the K8 route's gap from the composition at the decoder's tanh output: on
# average within a couple of bf16 steps at the top of its range (2^-8
# each below 1); at the worst pixel within twice what the composition
# itself moves when its batch is split in two (cuDNN picks its algorithms,
# and so its rounding, by batch size), which the random weights' eleven
# norms amplify alike
ROUTE_MEAN_GAP = 2 * 2.0 ** -8
ROUTE_MAX_OVER_DRIFT = 2.0


def _decoder_norms(cfg) -> int:
    """K8's launches in one call of `cfg`'s phase decoder at inference:
    one a norm, two a ResNet block and one an up stage."""
    return 2 * cfg.dec_n_blocks + cfg.n_downsampling


def _clip_norms(cfg, chunks: int, encodes: int = 1, pair: bool = True,
                blocks: bool = True) -> int:
    """K8's launches in a clip call at inference: each encode of the
    sources one a norm of the image encoder (stem, stride-2 convs, two a
    block); each chunk the label encoder's (stem, stride-2 convs),
    FuseNet's pair norm (none where K6 takes the pair block, `pair`) and
    the decoder's (its blocks' none where K7 takes them, `blocks`). A
    subnet's norms take K8 where it is bf16 or its fp32 convs run at
    "high": the encoders of "high" tiers without `fast_trunk`, the tail
    under `fast_tail` or at "high"."""
    trunk = not cfg.fast_trunk and cfg.precision == "high"
    tail = cfg.fast_tail or cfg.precision == "high"
    image = (1 + cfg.n_downsampling + 2 * cfg.enc_n_blocks) * trunk
    chunk = ((1 + cfg.n_downsampling) * trunk
             + (int(pair) + cfg.n_downsampling
                + (2 * cfg.dec_n_blocks if blocks else 0)) * tail)
    return encodes * image + chunks * chunk


def _route_gaps(got, want, drift) -> dict:
    """Max and mean gaps of the route (got - want) and of the
    composition's own batch drift (drift - want), as floats."""
    gap, own = np.abs(got - want), np.abs(drift - want)
    res = {"max": float(gap.max()), "mean": float(gap.mean()),
           "drift_max": float(own.max()), "drift_mean": float(own.mean())}
    print("[route] " + " ".join(f"{k}={v:.3e}" for k, v in res.items()))
    return res


def _face_decoder(dev, frames, seed=9):
    """The face config's bf16 decoder (4 blocks, 3 up stages) with
    normal(0, 0.02) weights and nonzero biases, and `frames` frames of
    seeded prop and syn features at 32x32x512."""
    from wacv23_tsnet_tpu_torch.configs import face_config
    from wacv23_tsnet_tpu_torch.nn import Decoder
    cfg = face_config()
    dec = Decoder(3, cfg.ngf, cfg.n_downsampling, cfg.dec_n_blocks,
                  dtype=torch.bfloat16, precision="default")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in dec.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    dec = dec.to(dev)
    h = cfg.image_size // 2 ** cfg.n_downsampling
    feats = [torch.randn((frames, h, h, cfg.feat_ch), generator=gen).to(dev)
             for _ in range(2)]
    return cfg, dec, feats


def test_decoder_norms_through_k8_at_full_width(dev):
    """A 64-frame chunk through the face config's bf16 decoder: the eleven
    norms (two in each of 4 blocks, one in each of 3 up stages) are eleven
    K8 launches, and the frames lie within a couple of bf16 steps of the
    composition's (`use_kernels=False`)."""
    from wacv23_tsnet_tpu_torch.nn import decoder_apply_fast
    from wacv23_tsnet_tpu_torch.utils.profiling import DECODER_NORMS
    cfg, dec, (prop, syn) = _face_decoder(dev, 64)
    norms = _decoder_norms(cfg)

    def run(lo, hi, use_kernels):
        return decoder_apply_fast(dec, prop[lo:hi], syn[lo:hi],
                                  return_fea=False, use_kernels=use_kernels)[0]

    with torch.inference_mode():
        want = run(0, 64, False)
        drift = torch.cat([run(0, 32, False), run(32, 64, False)])
        before = dict(DECODER_NORMS)
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        got = run(0, 64, True)
        torch.cuda.synchronize()
    launched = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    assert launched == {"instance_norm_fused": norms}, launched
    assert DECODER_NORMS == {"fused": before["fused"] + norms,
                             "plain": before["plain"]}
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    res = _route_gaps(*(t.float().cpu().numpy() for t in (got, want, drift)))
    assert res["mean"] <= ROUTE_MEAN_GAP
    assert res["max"] <= ROUTE_MAX_OVER_DRIFT * res["drift_max"]


def test_decoder_under_grad_keeps_the_composition(dev):
    """The fast train tier's bf16 decoder under grad: no K8 launch, the
    composition's bits, and a backward with finite gradients."""
    from wacv23_tsnet_tpu_torch.nn import decoder_apply_fast
    cfg, dec, (prop, syn) = _face_decoder(dev, 4)
    with torch.no_grad():
        want, _ = decoder_apply_fast(dec, prop, syn, return_fea=False,
                                     use_kernels=False)
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    got, _ = decoder_apply_fast(dec, prop, syn, return_fea=False)
    got.float().square().mean().backward()
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["instance_norm_fused"] == 0
    assert torch.equal(got.detach(), want)
    for p in (dec.map_conv.weight, dec.block0.conv1.weight, dec.up0.weight,
              dec.conv_out.weight):
        assert p.grad is not None and bool(torch.isfinite(p.grad).all())


def _close_route(monkeypatch, norms=None) -> None:
    """The norm route closed for the sites counted in `norms` (one of the
    `utils.profiling` counters; every site with None): they keep the
    composition."""
    from wacv23_tsnet_tpu_torch.ops import norm_kernels
    real = norm_kernels.fuses_norm

    def fuses(x, use_kernels=True, counter=None, *args, **kwargs):
        if norms is None or counter is norms:
            return real(x, False, counter, *args, **kwargs)
        return real(x, use_kernels, counter, *args, **kwargs)

    monkeypatch.setattr(norm_kernels, "fuses_norm", fuses)


def test_face_clip_high_job_with_and_without_the_trunk_route(dev,
                                                             monkeypatch):
    """A 64-frame `ClipInference` job of `face_config()` in
    `face.clip-high`'s tier ("high" encoders, `fast_tail`): its frames with
    the encoders' and FuseNet's norms through K8 against the same engine
    with that route closed (the decoder's open on both sides). bf16x3
    encoders are as accurate as fp32, so K8's two-pass sums, in another
    order than ATen's, move the label features by fp32 rounding only; the
    frames stay within the route's gaps of the closed route (the drift:
    the closed route at chunk 32)."""
    from wacv23_tsnet_tpu_torch.configs import face_config
    from wacv23_tsnet_tpu_torch.infer import ClipInference
    from wacv23_tsnet_tpu_torch.models import TSNetModules
    from wacv23_tsnet_tpu_torch.utils.profiling import TRUNK_NORMS

    cfg = dataclasses.replace(face_config(), precision="high",
                              fast_tail=True)
    mods = TSNetModules(cfg, device="cuda", seed=0)
    job = _face_clip_job(cfg, 64, 7)
    got = ClipInference(cfg, mods, chunk=64, device="cuda").run(*job)
    _close_route(monkeypatch, TRUNK_NORMS)
    before = dict(TRUNK_NORMS)
    want = ClipInference(cfg, mods, chunk=64, device="cuda").run(*job)
    assert TRUNK_NORMS["fused"] == before["fused"]
    drift = ClipInference(cfg, mods, chunk=32, device="cuda").run(*job)
    assert np.isfinite(got).all()
    res = _route_gaps(got, want, drift)
    assert res["mean"] <= ROUTE_MEAN_GAP
    assert res["max"] <= ROUTE_MAX_OVER_DRIFT * res["drift_max"]


def test_face_clip_job_with_and_without_the_norm_route(dev, monkeypatch):
    """A 64-frame `ClipInference` job of `face_config()` in the benchmark's
    clip tier: its frames with the norms through K8 (FuseNet's pair norm
    and the decoder's; the `fast_trunk` encoders keep the composition)
    against the same engine with the route closed, within the route's
    gaps (the drift: the closed route at chunk 32)."""
    from wacv23_tsnet_tpu_torch.configs import face_config
    from wacv23_tsnet_tpu_torch.infer import ClipInference
    from wacv23_tsnet_tpu_torch.models import TSNetModules

    cfg = dataclasses.replace(face_config(), precision="high",
                              fast_trunk=True, fast_tail=True)
    mods = TSNetModules(cfg, device="cuda", seed=0)
    engine = ClipInference(cfg, mods, chunk=64, device="cuda")
    job = _face_clip_job(cfg, 64, 7)
    cuda_build.reset_launches()
    got = engine.run(*job)
    assert cuda_build.LAUNCHES["instance_norm_fused"] == _clip_norms(cfg, 1)
    _close_route(monkeypatch)
    want = engine.run(*job)
    drift = ClipInference(cfg, mods, chunk=32, device="cuda").run(*job)
    assert np.isfinite(got).all()
    res = _route_gaps(got, want, drift)
    assert res["mean"] <= ROUTE_MEAN_GAP
    assert res["max"] <= ROUTE_MAX_OVER_DRIFT * res["drift_max"]


def _toy_batch(cfg, bs=2, seed=0):
    rng = np.random.default_rng(seed)
    s, hw, nl = cfg.n_source, cfg.image_size, cfg.label_nc
    return {"src_img": rng.random((bs, s, hw, hw, 3), np.float32),
            "src_lbl": rng.integers(0, 2, (bs, s, hw, hw, nl)).astype(
                np.float32),
            "src_bbox": rng.integers(0, 2, (bs, s, hw, hw)).astype(
                np.float32),
            "tar_img": rng.random((bs, hw, hw, 3), np.float32),
            "tar_lbl": rng.integers(0, 2, (bs, hw, hw, nl)).astype(
                np.float32),
            "tar_bbox": rng.integers(0, 2, (bs, hw, hw)).astype(np.float32)}


def test_toy_train_step_kernel_path_matches_plain_path(dev):
    from wacv23_tsnet_tpu_torch.train import (create_train_state,
                                              make_train_step)
    cfg = dataclasses.replace(toy_config(), image_size=128)
    batch = _toy_batch(cfg)
    results = []
    for use_kernels in (True, False):
        state = create_train_state(cfg, device="cuda", seed=0)
        step = make_train_step(state, use_kernels=use_kernels)
        cuda_build.reset_launches()
        _, metrics, _ = step(state, batch, 2e-4)
        torch.cuda.synchronize()
        launches = dict(cuda_build.LAUNCHES)
        grads = {name: torch.cat([p.grad.flatten() for p in
                                  getattr(state.mods, name).parameters()
                                  if p.grad is not None])
                 for name in ("img_enc", "lbl_enc", "fuse_net", "dec", "netD")}
        results.append(({k: v.item() for k, v in metrics.items()}, grads))
        if use_kernels:
            assert launches["transform_warp_pairs"] == 1
            assert launches["transform_warp_pairs_bwd"] == 1
            assert launches["instance_norm_mean"] == 1
        else:
            assert set(launches.values()) == {0}
    (mk, gk), (mp, gp) = results
    for k in mk:
        assert abs(mk[k] - mp[k]) <= 1e-4 * max(1.0, abs(mp[k])), k
    for name in gk:
        rel = ((gk[name] - gp[name]).norm() / gp[name].norm()).item()
        assert rel <= 1e-3, (name, rel)


def _step_bits(state, metrics, rec) -> dict:
    """Everything a train step leaves: each parameter, its gradient and
    its Adam moments, the metrics and the reconstruction."""
    out = {f"metric/{k}": v for k, v in metrics.items()}
    out["rec"] = rec
    for opt in (state.gen_opt, state.disc_opt):
        for group in opt.param_groups:
            for i, p in enumerate(group["params"]):
                name = f"{group['name']}/{i}"
                out[f"param/{name}"] = p.detach().clone()
                out[f"grad/{name}"] = p.grad.clone()
                for k in ("exp_avg", "exp_avg_sq"):
                    out[f"{k}/{name}"] = opt.state[p][k].clone()
    return out


def _step_twice(cfg, batch) -> list[str]:
    """Two train steps, each from the seeded initial state on `batch`:
    the names of what differs in bits."""
    from wacv23_tsnet_tpu_torch.train import (create_train_state,
                                              make_train_step)
    runs = []
    for _ in range(2):
        state = create_train_state(cfg, device="cuda", seed=0)
        state, metrics, rec = make_train_step(state)(state, batch, 2e-4)
        runs.append(_step_bits(state, metrics, rec))
    torch.cuda.synchronize()
    return [k for k in runs[0] if not torch.equal(runs[0][k], runs[1][k])]


@pytest.mark.parametrize("tier", ["bit-parity", "fast"])
def test_toy_train_step_gives_the_same_bits(dev, tier):
    """Face: every gradient, parameter, Adam moment, metric and the
    reconstruction bit-equal over two calls, in the bit-parity tier and
    the fast train tier ("high" + bwd_precision="default" + fast_tail)."""
    cfg = dataclasses.replace(toy_config(), image_size=128)
    if tier == "fast":
        cfg = dataclasses.replace(cfg, precision="high",
                                  bwd_precision="default", fast_tail=True)
    assert _step_twice(cfg, _toy_batch(cfg)) == []


def _pose_labels(n, hw, nl, seed=0):
    """One-hot pose label maps: body blocks of class 5 and, by sample
    i % 4, a face (class nl-1) in a head (class 2), a head only, neither,
    or a face in the top-left corner."""
    rng = np.random.default_rng(seed)
    cls = np.zeros((n, hw, hw), np.int64)
    u = hw // 16
    for i in range(n):
        y, x = rng.integers(u, 6 * u, 2)
        cls[i, 8 * u:14 * u, 6 * u:10 * u] = 5
        if i % 4 in (0, 1):
            cls[i, y:y + 3 * u, x:x + 3 * u] = 2
        if i % 4 == 0:
            cls[i, y + u:y + 2 * u, x + u:x + 2 * u] = nl - 1
        if i % 4 == 3:
            cls[i, :2 * u, :3 * u] = nl - 1
    return np.eye(nl, dtype=np.float32)[cls]


def test_crop_faces_on_the_card_makes_no_host_sync(dev):
    """`crop_faces` (the face box, the separable bilinear sampling and its
    gradient) runs on the card with the sync debug mode raising on any
    synchronizing call, and equals its CPU run within the rounding of its
    sample positions: the card's `arange / 63` differs from the CPU's in
    the last bit of some values, so a position below 256 may move by its
    ulp, 2^-16, which the bilinear weights multiply by the difference of
    two neighbouring pixels (up to ~10 for these unit normals)."""
    from wacv23_tsnet_tpu_torch.models.tsnet import crop_faces
    lbl = torch.from_numpy(_pose_labels(8, 256, 25))
    img = torch.randn(8, 256, 256, 3, generator=torch.Generator(
        device="cpu").manual_seed(8))
    want = crop_faces(img, lbl)
    lbl_d, img_d = lbl.to(dev), img.to(dev).requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = crop_faces(img_d, lbl_d)
        got.square().sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got.shape == (8, 64, 64, 3)
    assert (got.detach().cpu() - want).abs().max().item() <= 2e-4
    assert bool(torch.isfinite(img_d.grad).all())


def test_toy_pose_train_step_kernel_path_matches_plain_path(dev):
    """The pose variant's step (netDF on the face crops, compositing) at
    toy width with `d_n_layers=3` on 128^2 (32^2 crops): kernel path
    against plain path, netD and netDF gradients included."""
    from wacv23_tsnet_tpu_torch.configs import toy_pose_config
    from wacv23_tsnet_tpu_torch.train import (create_train_state,
                                              make_train_step)
    cfg = dataclasses.replace(toy_pose_config(), image_size=128,
                              d_n_layers=3)
    batch = _toy_batch(cfg)
    batch["tar_lbl"] = _pose_labels(2, 128, cfg.label_nc, seed=1)
    batch["src_lbl"] = _pose_labels(4, 128, cfg.label_nc, seed=2).reshape(
        2, 2, 128, 128, cfg.label_nc)
    results = []
    for use_kernels in (True, False):
        state = create_train_state(cfg, device="cuda", seed=0)
        step = make_train_step(state, use_kernels=use_kernels)
        cuda_build.reset_launches()
        _, metrics, _ = step(state, batch, 2e-4)
        torch.cuda.synchronize()
        launches = dict(cuda_build.LAUNCHES)
        grads = {name: torch.cat([p.grad.flatten() for p in
                                  getattr(state.mods, name).parameters()
                                  if p.grad is not None])
                 for name in ("img_enc", "lbl_enc", "fuse_net", "dec", "netD",
                              "netDF")}
        results.append(({k: v.item() for k, v in metrics.items()}, grads))
        assert sum(launches.values()) == 3 * int(use_kernels), launches
    (mk, gk), (mp, gp) = results
    assert len(mk) == 16
    for k in mk:
        assert abs(mk[k] - mp[k]) <= 1e-4 * max(1.0, abs(mp[k])), k
    for name in gk:
        rel = ((gk[name] - gp[name]).norm() / gp[name].norm()).item()
        assert rel <= 1e-3, (name, rel)


def test_toy_pose_train_step_gives_the_same_bits(dev):
    """Pose: the same bits over two calls, netDF on the face crops (whose
    gradient goes back through `sample_separable`) included."""
    from wacv23_tsnet_tpu_torch.configs import toy_pose_config
    cfg = dataclasses.replace(toy_pose_config(), image_size=128,
                              d_n_layers=3)
    batch = _toy_batch(cfg)
    batch["tar_lbl"] = _pose_labels(2, 128, cfg.label_nc, seed=1)
    batch["src_lbl"] = _pose_labels(4, 128, cfg.label_nc, seed=2).reshape(
        2, 2, 128, 128, cfg.label_nc)
    assert _step_twice(cfg, batch) == []


def _assert_bf16_close(got, want, atol=1e-3):
    """Both sides round an fp32 conv sum to bf16 once: one bf16 step
    (2^-7 relative) apart at most, plus `atol` for the fp32 sums taken in
    another order (K6: also hp values a rounding away from a tie, which
    round the other way where the statistics differ in their last bit;
    each moves an output by ulp(hp) * |w|, see chip_smoke.py K6_TOL)."""
    assert got.dtype == want.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs()
    assert bool((err <= atol + 2.0 ** -7 * want.float().abs()).all()), \
        err.max().item()


# (S, F, H, W, K, Co): one tile; ragged (144 pixels = a tile and 16 rows,
# 48 -> 40 channels); several channel tiles; W = 160 past the 128-pixel
# tile (a block covers part of a row); W = 24, which does not divide 128,
# with a ragged last tile of rows and 72 channels; H = 2, the shortest
# reflect; S = 5, two passes of the statistics over each frame
FUSE_SHAPES = [(2, 3, 8, 8, 64, 64), (1, 2, 12, 12, 48, 40),
               (3, 2, 16, 16, 256, 264), (1, 2, 3, 160, 32, 64),
               (2, 2, 20, 24, 64, 72), (2, 1, 2, 12, 32, 48),
               (5, 2, 4, 6, 16, 8)]


@pytest.mark.parametrize("shape", FUSE_SHAPES,
                         ids=["small", "ragged", "wide", "w160", "w24", "h2",
                              "s5"])
def test_fuse_pair_conv2_kernel(dev, shape):
    s, f, h, w, k, co = shape
    gen = torch.Generator(device="cpu").manual_seed(9)
    c1a = torch.randn(s, h, w, k, generator=gen).to(dev, torch.bfloat16)
    c1t = torch.randn(f, h, w, k, generator=gen).to(dev, torch.bfloat16)
    w2 = (torch.randn(co, k, 3, 3, generator=gen) * 0.05).to(dev)
    cuda_build.reset_launches()
    got = fuse_pair_conv2(c1a, c1t, w2)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["fuse_pair_conv2"] == 1
    assert tuple(got.shape) == (s, f, h, w, co)
    _assert_bf16_close(got, fuse_pair_conv2_plain(c1a, c1t, w2), atol=8e-3)


# (B, H, W, C, Co): one tile; ragged (6 x 10, 16 -> 48, as the JAX
# package's rectangular test); 400 pixels over four tiles (the last one
# ragged), 136 channels; two tiles with C = 40 (a part slice) and Co = 48;
# the decoder's plane, eight tiles (a full cluster), Co = 136; a 40 x 40
# plane, 14 tiles past the cluster (the two-pass path)
CONV_SHAPES = [(2, 8, 8, 32, 32), (1, 6, 10, 16, 48), (2, 20, 20, 136, 136),
               (2, 16, 16, 40, 48), (2, 32, 32, 64, 136), (1, 40, 40, 40, 48)]
CONV_IDS = ["small", "ragged", "wide", "c40", "t8", "two_pass"]


@pytest.mark.parametrize("variant", ["relu", "skip", "plain_norm"])
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=CONV_IDS)
def test_conv3x3_in_kernel(dev, shape, variant):
    b, h, w, c, co = shape
    gen = torch.Generator(device="cpu").manual_seed(10)
    x = torch.randn(b, h, w, c, generator=gen).to(dev, torch.bfloat16)
    wt = (torch.randn(co, c, 3, 3, generator=gen) * 0.1).to(dev)
    skip = (torch.randn(b, h, w, co, generator=gen).to(dev, torch.bfloat16)
            if variant == "skip" else None)
    relu = variant == "relu"
    cuda_build.reset_launches()
    got = conv3x3_in(x, wt, skip=skip, relu=relu)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["conv3x3_in"] == 1
    _assert_bf16_close(got, conv3x3_in_plain(x, wt, skip=skip, relu=relu))


@pytest.mark.parametrize("shape", CONV_SHAPES[2:5], ids=CONV_IDS[2:5])
def test_conv3x3_in_paths_give_the_same_bits(dev, shape):
    """On the cluster path two calls give the same bits (no atomics), and
    the two-pass path, which sums the tiles in the cluster's rank order,
    gives those bits too."""
    b, h, w, c, co = shape
    assert tiles(h, w) <= MAX_CLUSTER
    gen = torch.Generator(device="cpu").manual_seed(14)
    x = torch.randn(b, h, w, c, generator=gen).to(dev, torch.bfloat16)
    wt = (torch.randn(co, c, 3, 3, generator=gen) * 0.1).to(dev)
    skip = torch.randn(b, h, w, co, generator=gen).to(dev, torch.bfloat16)
    for kw in (dict(relu=True), dict(skip=skip, relu=False)):
        got = conv3x3_in(x, wt, **kw)
        assert torch.equal(got, conv3x3_in(x, wt, **kw))
        launch, two = launcher(x, wt, two_pass=True, **kw)
        launch()
        torch.cuda.synchronize()
        assert torch.equal(two, got)


def test_fuse_pair_conv2_bits_are_unchanged(dev):
    """K6 on the shared igemm_sm90.cuh depth loop gives the bits it gave
    before K7 came to share that loop (its sha256 on seeded inputs, as
    `chip_smoke.py` prints it)."""
    rng = np.random.default_rng(20)
    c1a = torch.from_numpy(rng.standard_normal((2, 12, 12, 64), np.float32))
    c1t = torch.from_numpy(rng.standard_normal((3, 12, 12, 64), np.float32))
    w2 = torch.from_numpy(rng.standard_normal((72, 64, 3, 3), np.float32))
    out = fuse_pair_conv2(c1a.to(dev, torch.bfloat16),
                          c1t.to(dev, torch.bfloat16), (w2 * 0.05).to(dev))
    digest = hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes())
    assert digest.hexdigest() == K6_SHA256


def test_resblock_fused_counts_two_launches(dev):
    """One block is two K7 calls; against the plain versions' block, which
    the two roundings to bf16 (the mid-block tensor and the output) may
    move by a step each."""
    gen = torch.Generator(device="cpu").manual_seed(11)
    x = torch.randn(2, 8, 8, 64, generator=gen).to(dev, torch.bfloat16)
    w1, w2 = ((torch.randn(64, 64, 3, 3, generator=gen) * 0.05).to(dev)
              for _ in range(2))
    cuda_build.reset_launches()
    got = resblock_fused(x, w1, w2)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["conv3x3_in"] == 2
    want = resblock_fused(x, w1, w2, use_kernels=False)
    assert (got.float() - want.float()).abs().max().item() <= 5e-2


def test_fused_kernels_refuse_what_they_do_not_take(dev):
    """f32 tensors, channel counts off the 8-channel chunks, views that do
    not start on a 16-byte boundary and strided views raise; nothing is
    launched."""
    x = torch.randn(2, 8, 8, 32, device=dev)
    wt = torch.randn(32, 32, 3, 3, device=dev)
    xb = x.to(torch.bfloat16)
    cuda_build.reset_launches()
    with pytest.raises(ValueError, match="bfloat16"):
        conv3x3_in(x, wt)
    with pytest.raises(ValueError, match="bfloat16"):
        fuse_pair_conv2(x, x, wt)
    with pytest.raises(ValueError, match="multiples of 8"):
        conv3x3_in(xb[..., :12].contiguous(), wt[:12, :12])
    with pytest.raises(ValueError, match="16-byte"):
        conv3x3_in(xb.reshape(-1)[4:4 + 8 * 8 * 32].reshape(1, 8, 8, 32), wt)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_in(xb.transpose(1, 2), wt)
    assert set(cuda_build.LAUNCHES.values()) == {0}


def test_fused_tail_toy_clip_kernel_path_matches_plain_path(dev,
                                                             monkeypatch):
    """The bench tier with both opt-ins at the toy config: one K6, K2 and
    K1, two K7 per block, one K8 per up stage in a decode call and one a
    norm of the encoders; the
    kernel path within the fast tiers' 0.01 mean-L1 budget of the plain
    path."""
    from wacv23_tsnet_tpu_torch.models import TSNetModules, tsnet_forward_clip
    monkeypatch.setenv("TSNET_FUSE_PAIR_KERNEL", "1")
    cfg = dataclasses.replace(toy_config(), precision="high", fast_tail=True,
                              fast_trunk=True)
    mods = TSNetModules(cfg, device="cuda", seed=0)
    rng = np.random.default_rng(12)
    s, hw, nl, f = cfg.n_source, cfg.image_size, cfg.label_nc, 5
    inputs = (rng.random((s, hw, hw, 3), np.float32),
              rng.integers(0, 2, (s, hw, hw, nl)).astype(np.float32),
              rng.integers(0, 2, (s, hw, hw)).astype(np.float32),
              rng.integers(0, 2, (f, hw, hw, nl)).astype(np.float32),
              rng.integers(0, 2, (f, hw, hw)).astype(np.float32))
    cuda_build.reset_launches()
    got = tsnet_forward_clip(mods, *inputs, fused_blocks=True)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    assert launches["fuse_pair_conv2"] == 1
    assert launches["instance_norm_mean"] == 1
    assert launches["transform_warp_pairs_mean"] == 1
    assert launches["conv3x3_in"] == 2 * cfg.dec_n_blocks
    assert launches["instance_norm_fused"] == _clip_norms(
        cfg, 1, pair=False, blocks=False)
    want = tsnet_forward_clip(mods, *inputs, fused_blocks=True,
                              use_kernels=False)
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().mean().item() <= 0.01


def _flow_inputs(dev, b, t, s, c, real_masks, seed=13):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    masks = [torch.rand(b, n, generator=gen) for n in (t, s)]
    if not real_masks:
        masks = [(m > 0.5).float() for m in masks]
    args = (l2_normalize(torch.randn(b, t, c, generator=gen)),
            l2_normalize(torch.randn(b, s, c, generator=gen)), *masks,
            torch.rand(s, 2, generator=gen) * 2 - 1)
    return tuple(x.to(dev).contiguous() for x in args)


# (B, T, S, C, real masks): one tile; T and S apart and off the tiles,
# C off the 16-channel chunks; a one-channel, one-row corner; T = 135 and
# S = 130 with C = 36, the other way round with C = 5 (4-byte copies);
# C = 600; the standalone phase's full width
FLOW_SHAPES = [(2, 64, 64, 32, False), (3, 100, 72, 40, True),
               (1, 1, 130, 1, True), (2, 135, 130, 36, True),
               (1, 130, 135, 5, False), (2, 70, 200, 600, True),
               (2, 1024, 1024, 512, False)]


@pytest.mark.parametrize("temp", [10.0, 100.0])
@pytest.mark.parametrize("shape", FLOW_SHAPES,
                         ids=["small", "ragged", "corner", "t135_c36",
                              "s135_c5", "c600", "full"])
def test_masked_attention_flow_kernel(dev, shape, temp):
    """K5 against its plain version, one launch a call."""
    b, t, s, c, real = shape
    args = _flow_inputs(dev, *shape)
    cuda_build.reset_launches()
    got = masked_attention_flow_fused(*args, temp=temp)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["masked_attention_flow_fused"] == 1
    assert sum(cuda_build.LAUNCHES.values()) == 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, t, 2)
    _assert_close(got, masked_attention_flow(*args, temp=temp))


def test_masked_attention_flow_gradients(dev):
    """K5's backward (the recomputed plain composition) gives all five
    input gradients as autograd through the plain version does."""
    args = _flow_inputs(dev, *FLOW_SHAPES[1])
    gen = torch.Generator(device="cpu").manual_seed(14)
    ct = torch.randn(3, 100, 2, generator=gen).to(dev)
    grads = []
    for fn in (masked_attention_flow_fused, masked_attention_flow):
        inputs = [x.clone().requires_grad_(True) for x in args]
        cuda_build.reset_launches()
        fn(*inputs, temp=10.0).backward(ct)
        grads.append([x.grad for x in inputs])
        assert cuda_build.LAUNCHES["masked_attention_flow_fused"] == int(
            fn is masked_attention_flow_fused)
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-6 * max(
            1.0, b.abs().max().item())


def test_transformation_warp_kernel_path(dev):
    """`transformation_warp(use_kernels=True)`: one K5 launch, then the
    warp; against the plain path."""
    gen = torch.Generator(device="cpu").manual_seed(15)
    b, h, w, c = 2, 9, 7, 24
    src = torch.randn(b, h, w, c, generator=gen)
    args = tuple(x.to(dev) for x in (
        src, l2_normalize(torch.randn(b, h, w, c, generator=gen)),
        l2_normalize(src), (torch.rand(b, h, w, generator=gen) > 0.5).float(),
        (torch.rand(b, h, w, generator=gen) > 0.5).float()))
    cuda_build.reset_launches()
    warped, flow = transformation_warp(*args, use_kernels=True)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["masked_attention_flow_fused"] == 1
    assert sum(cuda_build.LAUNCHES.values()) == 1
    plain_w, plain_f = transformation_warp(*args)
    _assert_close(flow, plain_f)
    _assert_close(warped, plain_w)


# (B, H, W, C, phase groups): one 16-byte chunk per 8 (bf16) or 4 (f32)
# channels; H*W off 8 with 24 channels; 12 channels (bf16 one at a time,
# the three-launch path); 2056 channels (bf16: 257 chunks, two slabs of
# the three-launch path); units past one block's registers and shared
# memory, so a cluster of 3 blocks (3072 and 768 pixels a block); N = 9075
# ragged across a cluster's blocks (bf16: 2 of 4538 and 4537, C/G = 24 in
# 16-byte slabs; f32: 3); a sample of K8_SHAPES[1] in chip_smoke.py (16
# blocks, a thread's chunks past its registers, 208 KiB of shared memory
# a block); a unit past 16 blocks (the three-launch path)
NORM_SHAPES = [(2, 8, 8, 64, 1), (2, 8, 8, 64, 4), (1, 5, 7, 24, 4),
               (2, 6, 10, 12, 1), (1, 9, 9, 2056, 4), (2, 96, 96, 64, 1),
               (2, 48, 48, 256, 4), (1, 75, 121, 48, 2), (1, 256, 256, 64, 1),
               (1, 512, 512, 16, 1)]
NORM_IDS = ["g1", "g4", "ragged", "narrow", "two_slabs", "cluster_g1",
            "cluster_g4", "ragged_cluster", "full_plane", "past_cluster"]


def _norm_input(dims, dtype, dev, seed=16):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn(*dims, generator=gen) * 2 + 1).to(dev, dtype)


@pytest.mark.parametrize("path", ["cluster", "three_launch"])
@pytest.mark.parametrize("relu", [False, True], ids=["norm", "relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", NORM_SHAPES, ids=NORM_IDS)
def test_instance_norm_fused_kernel(dev, shape, dtype, relu, path):
    """K8 on each path against its plain version in fp32 (before its one
    rounding); the entry point takes the planner's path in one launch,
    and a shape that no cluster covers is refused the cluster path."""
    *dims, groups = shape
    b, h, w, c = dims
    x = _norm_input(dims, dtype, dev)
    plan = fused_plan(h * w, c, groups, x.element_size())
    if path == "cluster" and plan.path != "cluster":
        with pytest.raises(ValueError, match="no cluster covers"):
            fused_launcher(x, relu=relu, phase_groups=groups, path=path)
        return
    want = instance_norm_fused_plain(x, relu=relu, phase_groups=groups,
                                     out_dtype=torch.float32)
    launch, got = fused_launcher(x, relu=relu, phase_groups=groups,
                                 path=path)
    cuda_build.reset_launches()
    launch()
    torch.cuda.synchronize()
    assert sum(cuda_build.LAUNCHES.values()) == 0
    _assert_close(got, want)
    if path == plan.path:
        got = instance_norm_fused(x, relu=relu, phase_groups=groups)
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES["instance_norm_fused"] == 1
        assert sum(cuda_build.LAUNCHES.values()) == 1
    assert got.dtype == dtype and got.shape == x.shape
    _assert_close(got, want)


@pytest.mark.parametrize("shape", [(2, 48, 48, 256, 4), (1, 75, 121, 48, 2)],
                         ids=["cluster_g4", "ragged_cluster"])
def test_instance_norm_fused_cluster_path_is_one_kernel(dev, shape):
    """The cluster path is one CUDA kernel a call (a profiler trace of
    the device), and two calls give the same bits: the statistics are
    summed in a fixed order over the cluster, with no atomics."""
    *dims, groups = shape
    for dtype in (torch.float32, torch.bfloat16):
        x = _norm_input(dims, dtype, dev, seed=17)
        assert fused_plan(dims[1] * dims[2], dims[3], groups,
                          x.element_size()).path == "cluster"
        first = instance_norm_fused(x, relu=True, phase_groups=groups)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            again = instance_norm_fused(x, relu=True, phase_groups=groups)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert [e.count for e in kernels] == [1], [e.key for e in kernels]
        assert "in_fused_cluster_kernel" in kernels[0].key
        assert torch.equal(first, again)


def test_instance_norm_fused_off_16_byte_boundary(dev):
    """A view that does not start on a 16-byte boundary takes one channel
    at a time, with the same result."""
    x = torch.randn(1 + 2 * 6 * 6 * 32, device=dev).to(torch.bfloat16)
    view = x[1:].view(2, 6, 6, 32)
    assert view.data_ptr() % 16
    _assert_close(instance_norm_fused(view, relu=True),
                  instance_norm_fused_plain(view, relu=True,
                                            out_dtype=torch.float32))


def _phase_fold(x, groups):
    """x (B, H, W, C) in a layout of `groups` phase groups: the 2x2 phases
    of `space_to_depth` (4), or the column parities (2)."""
    if groups == 4:
        return space_to_depth(x, 2)
    b, h, w, c = x.shape
    return x.reshape(b, h, w // 2, 2 * c)


@pytest.mark.parametrize("groups", [2, 4])
def test_instance_norm_fused_phase_identity(dev, groups):
    """The phase layout of x normalises as x does, on the cluster path."""
    x = torch.randn(2, 16, 12, 32, device=dev) * 3 - 1
    folded = _phase_fold(x, groups)
    assert fused_plan(folded.shape[1] * folded.shape[2], folded.shape[3],
                      groups, 4).path == "cluster"
    _assert_close(instance_norm_fused(folded, phase_groups=groups),
                  _phase_fold(instance_norm_fused(x), groups))


def test_instance_norm_fused_refuses_a_tensor_that_requires_grad(dev):
    x = torch.randn(2, 4, 4, 16, device=dev, requires_grad=True)
    cuda_build.reset_launches()
    with pytest.raises(ValueError, match="inference only"):
        instance_norm_fused(x)
    assert cuda_build.LAUNCHES["instance_norm_fused"] == 0
    with torch.no_grad():
        _assert_close(instance_norm_fused(x), instance_norm_fused_plain(x))


# the clip's fp32 trunk norms at a 64-frame chunk (B, H, W, C, phase
# groups): the label encoder's 7x7 stem, its folded stem under "high"
# (4x4 phases), its three stride-2 convs, and the image encoder's block
# norm (3 sources)
TRUNK_SHAPES = [(64, 256, 256, 64, 1), (64, 64, 64, 1024, 16),
                (64, 128, 128, 128, 1), (64, 64, 64, 256, 1),
                (64, 32, 32, 512, 1), (3, 32, 32, 512, 1)]
TRUNK_IDS = ["stem", "folded_stem", "down0", "down1", "down2",
             "image_block"]


@pytest.mark.parametrize("relu", [False, True], ids=["norm", "relu"])
@pytest.mark.parametrize("shape", TRUNK_SHAPES, ids=TRUNK_IDS)
def test_instance_norm_fused_two_pass_at_the_trunk_shapes(dev, shape, relu):
    """K8's two-pass form, one launch on the cluster path, against its
    plain version (the port's fp32 `instance_norm` statistics) within
    fp32 summation order, on activations whose channels sit far from 0
    (a mean 10x their spread), where the one-pass form loses digits."""
    *dims, groups = shape
    x = _norm_input(dims, torch.float32, dev, seed=18) + 20.0
    assert fused_plan(dims[1] * dims[2], dims[3], groups, 4).path == "cluster"
    want = instance_norm_two_pass_plain(x, relu=relu, phase_groups=groups)
    cuda_build.reset_launches()
    got = instance_norm_fused(x, relu=relu, phase_groups=groups,
                              two_pass=True)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["instance_norm_fused"] == 1
    _assert_close(got, want)
    again = instance_norm_fused(x, relu=relu, phase_groups=groups,
                                two_pass=True)
    assert torch.equal(got, again)


def test_instance_norm_fused_pair_norm_at_fusenet_shape(dev):
    """FuseNet's per-pair norm of a 64-frame chunk, (S·F, 32, 32, 1024)
    bf16 with S = 3: K8's one-pass form against its plain version."""
    x = _norm_input((192, 32, 32, 1024), torch.bfloat16, dev, seed=19)
    _assert_close(instance_norm_fused(x, relu=True),
                  instance_norm_fused_plain(x, relu=True,
                                            out_dtype=torch.float32))


def test_instance_norm_fused_two_pass_refuses_the_three_launch_path(dev):
    """The three-launch path has no two-pass form: a shape no cluster
    covers, or the path forced, is refused before any launch."""
    x = torch.randn(1, 512, 512, 64, device=dev)
    cuda_build.reset_launches()
    with pytest.raises(ValueError, match="cluster path only"):
        instance_norm_fused(x, two_pass=True)
    with pytest.raises(ValueError, match="cluster path only"):
        fused_launcher(x[:, :8].contiguous(), two_pass=True,
                       path="three_launch")
    assert cuda_build.LAUNCHES["instance_norm_fused"] == 0


def _integer_input(shape, dtype, dev):
    """Values made by integer arithmetic, the same on any PyTorch."""
    i = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=dev)
    v = ((i * 2654435761 + 12345) % 65521).float() / 65521.0
    return (v * 6.0 - 2.5).reshape(shape).to(dtype)


# K8's one-pass entry before its two-pass form was added: sha256 of the
# output's bytes, (shape, groups, dtype, relu) -> digest, on an H100
ONE_PASS_DIGESTS = {
    ((64, 32, 32, 512), 1, torch.bfloat16, True):
        "6a654d415d0844a304334d0d1a221cdcdd45692a710d5303bdc8fb5bbc793b3f",
    ((64, 32, 32, 1024), 4, torch.bfloat16, True):
        "dea34ac0799edc2dfde27745bf7b72eaa7ed9364854b0bee2cd75e4e7706bc03",
    ((8, 64, 64, 256), 1, torch.float32, False):
        "026d404bf742fef2da73f7361168b40ce74339f26c4523a746adf6273b56bade",
    ((4, 64, 64, 1024), 16, torch.float32, True):
        "69767135c1460ff3c4b9c6864e66ad498f8b774be48aafa02ed221e40bbd7e6f",
    ((2, 40, 24, 96), 4, torch.bfloat16, False):
        "f59b35b7b6d49d05219f7009a3848c5360a96caa690e3057a57448c2427cd399",
    ((2, 40, 24, 12), 1, torch.bfloat16, True):
        "db14e6bd1d9d81b7dd351343a4c89a5c08dfa4dba0bb547392fc35dbffad9c57",
}


@pytest.mark.parametrize("case", list(ONE_PASS_DIGESTS),
                         ids=lambda c: f"{c[0][3]}c_g{c[1]}_{str(c[2])[6:]}")
def test_instance_norm_fused_one_pass_keeps_its_bits(dev, case):
    """The one-pass entry (the TPU kernel's formula) gives the bits it
    gave before the two-pass form came in, on both paths."""
    shape, groups, dtype, relu = case
    y = instance_norm_fused(_integer_input(shape, dtype, dev), relu=relu,
                            phase_groups=groups)
    raw = y.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
    digest = hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()
    assert digest == ONE_PASS_DIGESTS[case]


# `decode_with_sources` with kernels against `use_kernels=False` at full
# width in each clip cell's tier: the mean |gap| of the frames within the
# 0.01 mean-L1 budget of the fast tiers' kernel paths against their plain
# paths (QUIRKS.md "Numerics decisions"; chip_smoke.py holds the bench
# tier's clip to it too)
DECODE_TIERS = {"clip": dict(precision="high", fast_trunk=True,
                             fast_tail=True),
                "clip-high": dict(precision="high", fast_tail=True)}
DECODE_MEAN_GAP = 0.01


@pytest.mark.parametrize("tier", list(DECODE_TIERS))
def test_decode_with_sources_with_and_without_kernels(dev, tier):
    """A 64-frame chunk of `face_config()` in each clip tier: every norm
    of the generator that the tier sends to K8 (and K1, K2) against the
    all-plain path, which launches nothing; the frames within the fast
    tiers' budget."""
    from wacv23_tsnet_tpu_torch.configs import face_config
    from wacv23_tsnet_tpu_torch.models import TSNetModules
    from wacv23_tsnet_tpu_torch.models.tsnet import (decode_with_sources,
                                                     encode_sources)
    from wacv23_tsnet_tpu_torch.utils.profiling import TRUNK_NORMS
    cfg = dataclasses.replace(face_config(), **DECODE_TIERS[tier])
    mods = TSNetModules(cfg, device="cuda", seed=4)
    img, lbl, box, tlbl, tbox = _face_clip_job(cfg, 64, 8)
    onehot = lambda a: F.one_hot(torch.as_tensor(a, device=dev).long(),
                                 cfg.label_nc).float()
    src = (torch.as_tensor(img, device=dev).permute(0, 2, 3, 1) / 255.0,
           onehot(lbl), torch.as_tensor(box, device=dev))
    tar = (onehot(tlbl), torch.as_tensor(tbox, device=dev))
    frames = {}
    for use_kernels in (True, False):
        before = dict(TRUNK_NORMS)
        cuda_build.reset_launches()
        pack = encode_sources(mods, *src, use_kernels=use_kernels)
        frames[use_kernels] = decode_with_sources(
            mods, pack, *tar, use_kernels=use_kernels)
        torch.cuda.synchronize()
        launched = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
        fused = TRUNK_NORMS["fused"] - before["fused"]
        if use_kernels:
            assert launched["instance_norm_fused"] == _clip_norms(cfg, 1)
            assert fused == _clip_norms(cfg, 1) - _decoder_norms(cfg)
        else:
            assert launched == {} and fused == 0
    gap = (frames[True] - frames[False]).abs()
    print(f"[decode] {tier}: mean {gap.mean():.3e} max {gap.max():.3e}")
    assert bool(torch.isfinite(frames[True]).all())
    assert gap.mean().item() <= DECODE_MEAN_GAP


def _write_face_pair(root, frames, hw=96, seed=3):
    """A toy subject/driving pair: ramp-plus-noise PNG frames and
    68-landmark files, the two faces of different sizes."""
    import os

    from wacv23_tsnet_tpu_torch.data.image_io import write_png
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw, :hw]
    t = np.linspace(np.pi * 0.1, np.pi * 0.9, 17)
    for clip, r in (("subject", 22.0), ("driving", 16.0)):
        os.makedirs(os.path.join(root, "labels", clip))
        os.makedirs(os.path.join(root, "images", clip))
        for f in range(frames):
            cx, cy = 48 + f % 3, 50 - f % 2
            jaw = np.stack([cx + r * np.cos(t + np.pi / 2) * 1.2,
                            cy + r * np.sin(t)], 1)
            rest = rng.uniform(-r / 2, r / 2, (51, 2)) + [cx, cy - r / 5]
            np.savetxt(os.path.join(root, "labels", clip, f"{f:05d}.txt"),
                       np.concatenate([jaw, rest]), delimiter=",")
            img = np.stack([xx + 2 * f, yy + int(r), xx + yy], -1)
            img = (img + rng.integers(0, 32, img.shape)) % 256
            write_png(os.path.join(root, "images", clip, f"{f:05d}.png"),
                      img.astype(np.uint8))


@pytest.mark.parametrize("tier", ["default", "fast-tail"])
def test_demo_face_toy_on_the_card(dev, tmp_path, tier):
    """`cli.demo_face.main` at the toy config on the card: 40 frames in
    two 32-frame chunks launch one warp kernel (K3-nf, or K1 with
    --fast-tail) and one K2 a chunk, and one K8 a norm of the generator
    (the sources encoded once), as chip_smoke.py's [demo] does; the
    reconstruction within the 0.01 mean-L1 budget of the same run on the
    CPU, and the GIF byte for byte what the writer makes of its montage
    PNGs."""
    import os

    from wacv23_tsnet_tpu_torch.cli import demo_face
    from wacv23_tsnet_tpu_torch.data.gif import encode_gif
    from wacv23_tsnet_tpu_torch.data.image_io import read_png
    root = str(tmp_path / "data")
    _write_face_pair(root, 40)
    args = ["--data-root", root, "--subject", "subject", "--driving",
            "driving", "--max-frames", "40", "--chunk", "32",
            "--n-source", "2"] + (["--fast-tail"] if tier == "fast-tail"
                                  else [])
    warp = {"default": "transform_warp_pairs_nf",
            "fast-tail": "transform_warp_pairs_mean"}[tier]
    cuda_build.reset_launches()
    res = demo_face.main(args + ["--out-dir", str(tmp_path / "card")],
                         base_config=toy_config())
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    tier_cfg = dataclasses.replace(toy_config(), precision="high",
                                   fast_tail=tier == "fast-tail")
    want = {warp: 2, "instance_norm_mean": 2,
            "instance_norm_fused": _clip_norms(tier_cfg, 2)}
    assert launches == want
    cpu = demo_face.main(args + ["--out-dir", str(tmp_path / "cpu")],
                         base_config=toy_config(), device="cpu")
    assert cpu["names"] == res["names"] and cpu["ref_idx"] == res["ref_idx"]
    assert np.abs(res["rec"] - cpu["rec"]).mean() <= 0.01
    frames = [read_png(os.path.join(tmp_path / "card", name))
              for name in res["names"]]
    with open(res["gif"], "rb") as f:
        assert f.read() == encode_gif(frames)


def test_profile_stages_toy_on_the_card(dev, tmp_path, monkeypatch):
    """`cli.profile_stages` at the toy config on the card reads every clip
    span of `tsnet_forward_clip` once a call, in device ms."""
    from wacv23_tsnet_tpu_torch.cli import profile_stages
    monkeypatch.chdir(tmp_path)
    cfg = toy_config()
    res = profile_stages.main(["--frames", "8", "--size",
                               str(cfg.image_size), "--n-source",
                               str(cfg.n_source)], base_config=cfg)
    assert tuple(res["stage_ms"]) == profile_stages.CLIP_SPANS
    assert all(n == 1 for n in res["count"].values()), res["count"]
    assert all(ms > 0 for ms in res["stage_ms"].values()), res["stage_ms"]


def _clip_job(cfg, frames, seed):
    """`ClipInference.run`'s host arrays for one toy job."""
    rng = np.random.default_rng(seed)
    s, hw, nl = cfg.n_source, cfg.image_size, cfg.label_nc
    return (rng.random((s, 3, hw, hw), np.float32) * 255.0,
            rng.integers(0, nl, (s, hw, hw)).astype(np.uint8),
            np.ones((s, hw, hw), np.float32),
            rng.integers(0, nl, (frames, hw, hw)).astype(np.uint8),
            np.ones((frames, hw, hw), np.float32))


@pytest.mark.parametrize("frames", [8, 7, 3, 13],
                         ids=["multiple", "ragged", "below", "four-chunks"])
@pytest.mark.parametrize("method", ["run", "run_renormalized"])
def test_clip_inference_stages_frames_through_pinned_slots(
        dev, monkeypatch, method, frames):
    """On the card `ClipInference` copies each 4-frame chunk back through
    its two pinned slots on its copy stream: the frames are the plain
    path's bits (the same chunks kept on the card, `torch.cat` and
    `.cpu()`), every chunk is counted as staged, more chunks than slots
    pass through them intact, and a second job leaves the first one's
    array as it was."""
    from wacv23_tsnet_tpu_torch.infer import pipeline
    from wacv23_tsnet_tpu_torch.models import TSNetModules
    from wacv23_tsnet_tpu_torch.utils.profiling import CLIP_COPIES

    cfg = toy_config()
    engine = pipeline.ClipInference(cfg, TSNetModules(cfg, device="cuda"),
                                    chunk=4, device="cuda")
    run = getattr(engine, method)
    chunks = -(-frames // 4)
    before = dict(CLIP_COPIES)
    got = [run(*_clip_job(cfg, frames, seed)) for seed in (1, 2)]
    assert CLIP_COPIES == {"staged": before["staged"] + 2 * chunks,
                           "plain": before["plain"]}
    kept = got[0].copy()
    third = run(*_clip_job(cfg, frames, 3))
    np.testing.assert_array_equal(got[0], kept)
    assert not np.shares_memory(got[0], got[1])
    assert not np.shares_memory(got[1], third)
    monkeypatch.setattr(pipeline, "_StagedFrames",
                        lambda *a: pipeline._PlainFrames())
    want = [run(*_clip_job(cfg, frames, seed)) for seed in (1, 2)]
    assert CLIP_COPIES["plain"] == before["plain"] + 2 * chunks
    hw = cfg.image_size
    for g, w in zip(got, want):
        assert g.shape == (frames, 3, hw, hw) and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0], got[1])


def test_clip_inference_pinned_slots_follow_the_chunk(dev):
    """One engine run at chunk 4, then 2, then 4 again: the slots are
    remade for each new frame shape and the frames stay those of an
    engine made at that chunk."""
    from wacv23_tsnet_tpu_torch.infer import ClipInference
    from wacv23_tsnet_tpu_torch.models import TSNetModules

    cfg = toy_config()
    mods = TSNetModules(cfg, device="cuda")
    engine = ClipInference(cfg, mods, chunk=4, device="cuda")
    job = _clip_job(cfg, 7, 4)
    for chunk in (4, 2, 4):
        engine.chunk = chunk
        got = engine.run(*job)
        assert engine._staging.slots[0].shape[0] == chunk
        assert engine._staging.slots[0].is_pinned()
        want = ClipInference(cfg, mods, chunk=chunk, device="cuda").run(*job)
        np.testing.assert_array_equal(got, want)


def _pose_keypoints(f, hw, seed=4):
    """f frames of (137, 2) OpenPose points in an hw^2 crop (pose 25 |
    face 70 | hand_l 21 | hand_r 21), a tenth of them undetected (0)."""
    rng = np.random.default_rng(seed)
    kp = rng.uniform(hw * 0.1, hw * 0.9, (f, 137, 2)).astype(np.float32)
    kp[rng.random((f, 137)) < 0.1] = 0.0
    return kp


def test_rasterize_pose_clip_on_the_card(dev):
    """The pose rasterizer's torch ops on the card give the CPU's label
    maps at 256^2 (chip_smoke.py [pose_data] holds a 32-frame chunk)."""
    from wacv23_tsnet_tpu_torch.data.rasterize_device import (
        rasterize_pose_clip)
    kp = torch.from_numpy(_pose_keypoints(6, 256))
    bw = torch.tensor([1.0, 2.0, 3.0, 1.0, 4.0, 2.0])
    hbw = torch.clamp(bw / 3.0, min=1.0)

    def parts(k, a, b):
        return (k[:, :25], k[:, 25:95], k[:, 95:116], k[:, 116:137], a, b)

    want = rasterize_pose_clip(*parts(kp, bw, hbw))
    got = rasterize_pose_clip(*(x.to(dev) for x in parts(kp, bw, hbw)))
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)
    assert len(torch.unique(want)) > 10


@pytest.mark.parametrize("fast_tail", [False, True], ids=["nf", "mean"])
def test_pose_push_keypoints_kernels_match_plain(dev, fast_tail):
    """Pose `push_keypoints` at the toy pose config (25 classes) on the
    card: 40 frames in chunks of 32 launch one warp kernel (K3-nf, or K1
    with fast_tail) and one K2 a chunk, and with fast_tail one K8 a norm
    of the bf16 tail (FuseNet's pair norm, the decoder's), and the frames
    agree with the
    plain path's (1e-3 max abs in model space; 0.01 mean L1 with the
    bf16 tail)."""
    from wacv23_tsnet_tpu_torch.configs import toy_pose_config
    from wacv23_tsnet_tpu_torch.infer import RetargetSession
    from wacv23_tsnet_tpu_torch.models import TSNetModules
    cfg = dataclasses.replace(toy_pose_config(), label_nc=25,
                              fast_tail=fast_tail)
    mods = TSNetModules(cfg, device=dev, seed=2)
    hw, s = cfg.image_size, cfg.n_source
    rng = np.random.default_rng(1)
    src = (rng.random((s, hw, hw, 3)).astype(np.float32),
           np.eye(25, dtype=np.float32)[rng.integers(0, 25, (s, hw, hw))],
           rng.integers(0, 2, (s, hw, hw)).astype(np.float32))
    kp = _pose_keypoints(40, hw)
    frames = {}
    for use_kernels in (True, False):
        sess = RetargetSession(mods, *src, chunk=32, device=dev,
                               use_kernels=use_kernels)
        cuda_build.reset_launches()
        frames[use_kernels] = sess.push_keypoints(kp)
        torch.cuda.synchronize()
        launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
        warp = ("transform_warp_pairs_mean" if fast_tail
                else "transform_warp_pairs_nf")
        want = ({warp: 2, "instance_norm_mean": 2, "instance_norm_fused":
                 _clip_norms(cfg, 2, encodes=0)} if use_kernels else {})
        assert launches == {k: v for k, v in want.items() if v}
    err = np.abs(frames[True] - frames[False])
    assert frames[True].shape == (40, hw, hw, 3)
    if fast_tail:
        assert err.mean() <= 0.01
    else:
        assert err.max() <= 1e-3


def _toy_clip_inputs(cfg, frames=8, seed=5):
    rng = np.random.default_rng(seed)
    s, hw, nl = cfg.n_source, cfg.image_size, cfg.label_nc
    return (rng.random((s, hw, hw, 3), np.float32),
            rng.integers(0, 2, (s, hw, hw, nl)).astype(np.float32),
            rng.integers(0, 2, (s, hw, hw)).astype(np.float32),
            rng.integers(0, 2, (frames, hw, hw, nl)).astype(np.float32),
            rng.integers(0, 2, (frames, hw, hw)).astype(np.float32))


@pytest.mark.parametrize("fast_tail", [False, True], ids=["nf", "mean"])
def test_parallel_clip_one_rank_nccl_is_the_clip(dev, tmp_path, fast_tail):
    """A (1, 1) mesh over NCCL: `make_parallel_clip_infer` on the kernel
    path gives `tsnet_forward_clip`'s bits, one warp kernel and one K2,
    and with `fast_tail` one K8 for each norm of the bf16 tail (FuseNet's
    pair norm, the decoder's)."""
    import torch.distributed as dist

    from wacv23_tsnet_tpu_torch.models import TSNetModules, tsnet_forward_clip
    from wacv23_tsnet_tpu_torch.parallel import (init_distributed, make_mesh,
                                                 make_parallel_clip_infer)

    cfg = dataclasses.replace(toy_config(), fast_tail=fast_tail)
    mods = TSNetModules(cfg, device="cuda")
    args = _toy_clip_inputs(cfg)
    want = tsnet_forward_clip(mods, *args)
    init_distributed(0, 1, f"file://{tmp_path / 'store'}")
    try:
        mesh = make_mesh()
        cuda_build.reset_launches()
        got = make_parallel_clip_infer(mods, mesh, use_kernels=True)(*args)
        torch.cuda.synchronize()
        launched = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
        calls = dict(mesh.calls)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, want)
    warp = ("transform_warp_pairs_mean" if fast_tail
            else "transform_warp_pairs_nf")
    want = {warp: 1, "instance_norm_mean": 1,
            "instance_norm_fused": _clip_norms(cfg, 1)}
    assert launched == {k: v for k, v in want.items() if v}, launched
    assert calls == {("all_gather", "data", "nccl", "cuda"): 1}, calls


def test_parallel_train_step_one_rank_nccl(dev, tmp_path):
    """A (1, 1) mesh over NCCL: the DP step's reconstruction is the
    single-process step's bits from the same state, its metrics within
    the CPU bar, one K3-flow, one K4 and one K2."""
    import torch.distributed as dist

    from wacv23_tsnet_tpu_torch.parallel import (init_distributed, make_mesh,
                                                 make_parallel_train_step,
                                                 shard_batch)
    from wacv23_tsnet_tpu_torch.train import (create_train_state,
                                              make_train_step)

    rng = np.random.default_rng(0)
    cfg = toy_config()
    s, hw, nl, bs = cfg.n_source, cfg.image_size, cfg.label_nc, 4
    batch = {"src_img": rng.random((bs, s, hw, hw, 3), np.float32),
             "src_lbl": rng.integers(0, 2, (bs, s, hw, hw, nl)).astype(
                 np.float32),
             "src_bbox": rng.integers(0, 2, (bs, s, hw, hw)).astype(
                 np.float32),
             "tar_img": rng.random((bs, hw, hw, 3), np.float32),
             "tar_lbl": rng.integers(0, 2, (bs, hw, hw, nl)).astype(
                 np.float32),
             "tar_bbox": rng.integers(0, 2, (bs, hw, hw)).astype(np.float32)}
    state = create_train_state(cfg, seed=0)
    _, want_m, want_rec = make_train_step(state)(state, batch, 2e-4)
    state = create_train_state(cfg, seed=0)
    init_distributed(0, 1, f"file://{tmp_path / 'store'}")
    try:
        mesh = make_mesh()
        step = make_parallel_train_step(state, mesh)
        cuda_build.reset_launches()
        state, got_m, got_rec = step(state, shard_batch(batch, mesh), 2e-4)
        torch.cuda.synchronize()
        launched = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    finally:
        dist.destroy_process_group()
    assert state.step == 1
    assert torch.equal(got_rec, want_rec)
    for k, v in want_m.items():
        assert abs(float(got_m[k]) - float(v)) < 5e-3, k
    assert launched == {"transform_warp_pairs": 1,
                        "transform_warp_pairs_bwd": 1,
                        "instance_norm_mean": 1}, launched


def test_zoo_on_the_card_matches_the_cpu(dev):
    """The zoo's generators and discriminators and the WGAN-GP penalty on
    the card against the CPU, from one seed."""
    from wacv23_tsnet_tpu_torch.losses import gradient_penalty
    from wacv23_tsnet_tpu_torch.nn import define_D, define_G

    x = torch.from_numpy(np.random.default_rng(1).random(
        (2, 128, 128, 3), np.float32))

    def seed():
        return torch.Generator().manual_seed(0)

    for make in (lambda d: define_G(3, 3, 16, "resnet_6blocks", device=d,
                                   generator=seed()),
                 lambda d: define_G(3, 3, 16, "unet_128", device=d,
                                   generator=seed()),
                 lambda d: define_D(3, 8, "pixel", device=d,
                                   generator=seed())):
        cpu, card = make("cpu"), make("cuda")
        with torch.no_grad():
            want, got = cpu(x), card(x.to(dev))
        assert (got.cpu() - want).abs().max().item() <= 1e-4
    d_cpu = define_D(3, 8, "pixel", device="cpu",
                     generator=torch.Generator().manual_seed(0))
    d_card = define_D(3, 8, "pixel", device="cuda",
                      generator=torch.Generator().manual_seed(0))
    alpha = torch.tensor([0.25, 0.75])
    want = gradient_penalty(d_cpu, x, x * 0.5, alpha=alpha)
    got = gradient_penalty(d_card, x.to(dev), x.to(dev) * 0.5, alpha=alpha)
    assert abs(got.item() - want.item()) <= 1e-4 * abs(want.item())


def test_bench_sweep_toy_on_the_card(dev, capsys):
    """`bench_sweep` at the toy config on the card: the card line, eight
    JSON lines, and one K1, one K2 and one K8 a generator norm a clip
    call (one warm-up and five timed calls a config)."""
    from wacv23_tsnet_tpu_torch.cli import bench_sweep

    cuda_build.reset_launches()
    lines = bench_sweep.main([], base_config=toy_config())
    torch.cuda.synchronize()
    launched = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    err = capsys.readouterr().err.splitlines()
    assert err[0] and err[0] != "cpu"
    assert len(lines) == 8 and all(line["value"] > 0 for line in lines)
    assert launched == {"transform_warp_pairs_mean": 48,
                        "instance_norm_mean": 48,
                        "instance_norm_fused": 48 * _clip_norms(
                            dataclasses.replace(toy_config(), precision="high",
                                                fast_tail=True), 1)}, launched
