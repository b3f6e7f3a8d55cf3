"""The CUDA kernels against their plain versions, on the GPU.

Skips where there is no CUDA device. It imports no JAX, so it also runs
where only PyTorch is installed; there, skip the JAX-pinning conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Small and ragged shapes here (the tile edges: T not a multiple of 64,
C not a multiple of 32); chip_smoke.py checks the main path's shapes.
"""

import pytest
import torch

from wacv23_tsnet_tpu_torch.ops import cuda_build
from wacv23_tsnet_tpu_torch.ops.coords import normalized_grid
from wacv23_tsnet_tpu_torch.ops.norm_kernels import (instance_norm_mean,
                                                     instance_norm_mean_plain)
from wacv23_tsnet_tpu_torch.ops.norms import l2_normalize
from wacv23_tsnet_tpu_torch.ops.warp_kernels import (
    transform_warp_mean_plain, transform_warp_pairs_mean,
    transform_warp_pairs_nf, transform_warp_pairs_plain)

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
    _assert_close(got, transform_warp_pairs_plain(*args, h, w))


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
