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
and the train shape of the backward, with its own ragged edges and a
check that two calls give the same bits; the pose train step's shapes
(K3-flow and K4 at G=10, K2 at (3, 10, 32, 32, 1024)), `crop_faces` with
no host sync, and the toy pose step's kernel path; chip_smoke.py checks
the main paths' shapes.
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
from wacv23_tsnet_tpu_torch.ops.flow_kernels import (
    masked_attention_flow, masked_attention_flow_fused)
from wacv23_tsnet_tpu_torch.ops.fuse_kernels import (fuse_pair_conv2,
                                                     fuse_pair_conv2_plain)
from wacv23_tsnet_tpu_torch.ops.norm_kernels import (
    fused_launcher, fused_plan, instance_norm_fused, instance_norm_fused_plain,
    instance_norm_mean, instance_norm_mean_plain, mean_tiles)
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
    rows and sources in another order (and da's scatter by atomics)."""
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
                                   (15, 3, 1, 32, 32, 512)],
                         ids=["ragged", "train"])
def test_warp_pairs_bwd_kernel_is_deterministic(dev, shape):
    """Every cotangent but da (a scatter by atomics) is summed in a fixed
    order: two calls give the same bits."""
    g, ns, nf, h, w, c = shape
    args = _pairs_inputs(dev, *shape, seed=12)
    gen = torch.Generator(device="cpu").manual_seed(13)
    g_warped = torch.randn(g, ns, nf, h * w, c, generator=gen).to(dev)
    g_flow = torch.randn(g, ns, nf, h * w, 2, generator=gen).to(dev)
    _, flow, lse = transform_warp_pairs_fwd(*args, h, w)
    first, second = (transform_warp_pairs_bwd(*args, flow, lse, g_warped,
                                              g_flow, h, w)
                     for _ in range(2))
    for a, b in zip(first[1:], second[1:]):
        assert torch.equal(a, b)
    _assert_cotangents_close(first, second)


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
    `chip_smoke.py --parts` prints it)."""
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
    K1 and two K7 per block in a decode call; the kernel path within the
    fast tiers' 0.01 mean-L1 budget of the plain path."""
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
# the three-launch path); units that fill a cluster of 16 blocks (256 and
# 64 pixels a block); N = 1000 ragged across 16 blocks of 63 pixels, with
# C/G = 24 (bf16: 16-byte slabs); a sample of K8_SHAPES[1] in chip_smoke.py
# (a thread's chunks past its registers, 208 KiB of shared memory a
# block); a unit past 16 blocks (the three-launch path)
NORM_SHAPES = [(2, 8, 8, 64, 1), (2, 8, 8, 64, 4), (1, 5, 7, 24, 4),
               (2, 6, 10, 12, 1), (1, 9, 9, 2056, 4), (2, 64, 64, 64, 1),
               (2, 32, 32, 256, 4), (1, 25, 40, 48, 2), (1, 256, 256, 64, 1),
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


@pytest.mark.parametrize("shape", [(2, 32, 32, 256, 4), (1, 25, 40, 48, 2)],
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
    --fast-tail) and one K2 a chunk, as chip_smoke.py's [demo] does; the
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
    assert launches == {warp: 2, "instance_norm_mean": 2}
    cpu = demo_face.main(args + ["--out-dir", str(tmp_path / "cpu")],
                         base_config=toy_config(), device="cpu")
    assert cpu["names"] == res["names"] and cpu["ref_idx"] == res["ref_idx"]
    assert np.abs(res["rec"] - cpu["rec"]).mean() <= 0.01
    frames = [read_png(os.path.join(tmp_path / "card", name))
              for name in res["names"]]
    with open(res["gif"], "rb") as f:
        assert f.read() == encode_gif(frames)
