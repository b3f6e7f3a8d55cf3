"""The CUDA kernels against their plain versions, on the GPU.

Skips where there is no CUDA device. It imports no JAX, so it also runs
where only PyTorch is installed; there, skip the JAX-pinning conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Small and ragged shapes here (the tile edges: T not a multiple of 64,
C not a multiple of 32, and past the backward's 512-channel slab; for the
tensor-core convs K6 and K7, pixels past the 128-row tiles and channel
counts that are not powers of two), and the train shape of the backward;
chip_smoke.py checks the main path's shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wacv23_tsnet_tpu_torch.configs import toy_config
from wacv23_tsnet_tpu_torch.nn.blocks import conv2d
from wacv23_tsnet_tpu_torch.ops import cuda_build
from wacv23_tsnet_tpu_torch.ops.conv_kernels import (conv3x3_in,
                                                     conv3x3_in_plain,
                                                     resblock_fused)
from wacv23_tsnet_tpu_torch.ops.coords import normalized_grid
from wacv23_tsnet_tpu_torch.ops.fuse_kernels import (fuse_pair_conv2,
                                                     fuse_pair_conv2_plain)
from wacv23_tsnet_tpu_torch.ops.norm_kernels import (instance_norm_mean,
                                                     instance_norm_mean_plain)
from wacv23_tsnet_tpu_torch.ops.norms import l2_normalize
from wacv23_tsnet_tpu_torch.ops.warp_kernels import (
    transform_warp_mean_plain, transform_warp_pairs,
    transform_warp_pairs_bwd, transform_warp_pairs_bwd_plain,
    transform_warp_pairs_fwd, transform_warp_pairs_mean,
    transform_warp_pairs_nf, transform_warp_pairs_nf_plain,
    transform_warp_pairs_plain)

pytestmark = pytest.mark.cuda


def _assert_close(got, want):
    """f32: 1e-4 absolute (summation order); bf16 out: also one bf16 step
    (2^-8 relative), since a value a rounding away from a tie may round
    the other way."""
    rtol = 0.0 if got.dtype == torch.float32 else 2.0 ** -8
    err = (got.float() - want.float()).abs()
    assert bool((err <= 1e-4 + rtol * want.float().abs()).all()), \
        err.max().item()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _warp_inputs(dev, s, f, h, w, c, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    t = h * w
    src = torch.randn(s, t, c, generator=g)
    tar = torch.randn(f, t, c, generator=g)
    sm = (torch.rand(s, t, generator=g) > 0.5).float()
    tm = (torch.rand(f, t, generator=g) > 0.5).float()
    args = (src, l2_normalize(tar), l2_normalize(src), tm, sm,
            normalized_grid(h, w).reshape(t, 2))
    return tuple(x.to(dev).contiguous() for x in args)


SHAPES = [(3, 2, 16, 16, 32), (2, 3, 10, 10, 40), (1, 1, 9, 7, 5)]


@pytest.mark.parametrize("shape", SHAPES)
def test_warp_pairs_nf_kernel(dev, shape):
    s, f, h, w, c = shape
    args = _warp_inputs(dev, *shape)
    cuda_build.reset_launches()
    got = transform_warp_pairs_nf(*args, h, w)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["transform_warp_pairs_nf"] == 1
    _assert_close(got, transform_warp_pairs_nf_plain(*args, h, w))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_warp_mean_kernel(dev, shape, out_dtype):
    s, f, h, w, c = shape
    args = _warp_inputs(dev, *shape, seed=1)
    cuda_build.reset_launches()
    got = transform_warp_pairs_mean(*args, h, w, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype
    assert cuda_build.LAUNCHES["transform_warp_pairs_mean"] == 1
    _assert_close(got, transform_warp_mean_plain(*args, h, w))


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


def test_instance_norm_mean_degenerate_channel_is_finite(dev):
    x = 300.0 + torch.randn(1, 2, 8, 8, 16) * 1e-3
    assert torch.isfinite(instance_norm_mean(x.to(dev))).all()


def test_instance_norm_mean_refuses_a_plane_past_shared_memory(dev):
    """A 64x64 plane needs a 512 KB slab: the launch is refused with an
    error, and the next launch still runs and reports its own status."""
    with pytest.raises(RuntimeError, match="shared memory"):
        instance_norm_mean(torch.randn(1, 1, 64, 64, 32, device=dev))
    x = torch.randn(2, 2, 8, 8, 32, device=dev)
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


PAIRS = [(2, 2, 1, 16, 16, 64), (1, 3, 2, 10, 10, 40), (2, 1, 2, 9, 7, 600)]


@pytest.mark.parametrize("shape", PAIRS)
def test_warp_pairs_flow_kernel(dev, shape):
    """K3-flow: warped, flow and the row log-sum-exp."""
    g, ns, nf, h, w, c = shape
    args = _pairs_inputs(dev, *shape)
    cuda_build.reset_launches()
    got = transform_warp_pairs_fwd(*args, h, w)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["transform_warp_pairs"] == 1
    for a, b in zip(got, transform_warp_pairs_plain(*args, h, w)):
        _assert_close(a, b)


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


@pytest.mark.parametrize("temp", [10.0, 100.0])
@pytest.mark.parametrize("shape", PAIRS + [(15, 3, 1, 32, 32, 512)],
                         ids=["small", "ragged", "wide", "train"])
def test_warp_pairs_bwd_kernel(dev, shape, temp):
    """K4 against autograd through the plain forward, given the plain
    forward's own flow and log-sum-exp; at temp 10 also on K3-flow's
    flow. (At temp 100 the flow of random features sits near pixel
    centres, where the bilinear warp's gradient jumps, and two fp32 flows
    may fall in different cells; chip_smoke.py counts such rows.)"""
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
# 48 -> 40 channels); several channel tiles
FUSE_SHAPES = [(2, 3, 8, 8, 64, 64), (1, 2, 12, 12, 48, 40),
               (3, 2, 16, 16, 256, 264)]


@pytest.mark.parametrize("shape", FUSE_SHAPES, ids=["small", "ragged", "wide"])
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
# package's rectangular test); 400 pixels over four tiles, 136 channels
CONV_SHAPES = [(2, 8, 8, 32, 32), (1, 6, 10, 16, 48), (2, 20, 20, 136, 136)]


@pytest.mark.parametrize("variant", ["relu", "skip", "plain_norm"])
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=["small", "ragged", "wide"])
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
