"""K6 and K7's plain versions against the JAX package's Pallas kernels.

On the CPU the port's wrappers `fuse_pair_conv2` (K6) and `conv3x3_in` /
`resblock_fused` (K7) run their plain versions; the JAX side runs its
Pallas kernels in interpret mode, as the JAX package's own tests do, at
their shapes (tests/test_pallas_fuse.py, tests/test_pallas_conv.py).
Tolerances are the JAX package's own for the same functions. The CUDA
kernels themselves are held against these plain versions on the GPU
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wacv23_tsnet_tpu.ops.pallas_conv import conv3x3_in as j_conv3x3_in
from wacv23_tsnet_tpu.ops.pallas_conv import resblock_fused as j_resblock
from wacv23_tsnet_tpu.ops.pallas_fuse import fuse_pair_conv2 as j_fuse_pair
from wacv23_tsnet_tpu_torch.ops import cuda_build
from wacv23_tsnet_tpu_torch.ops.conv_kernels import (conv3x3_in,
                                                     conv3x3_in_plain,
                                                     resblock_fused)
from wacv23_tsnet_tpu_torch.ops.fuse_kernels import (fuse_pair_conv2,
                                                     fuse_pair_conv2_plain)

torch.set_num_threads(2)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _oihw(k_hwio: np.ndarray) -> torch.Tensor:
    """The JAX package's HWIO kernel as the port's OIHW weight."""
    return torch.from_numpy(np.ascontiguousarray(k_hwio.transpose(3, 2, 0, 1)))


def _torch(a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(a).to(dtype)


def _max_err(got, want) -> float:
    err = float(np.max(np.abs(got.float().numpy()
                              - np.asarray(jnp.asarray(want, jnp.float32)))))
    # the measured error, shown by `pytest -s`
    print(f"[parity] {os.environ.get('PYTEST_CURRENT_TEST', '').split()[0]}: "
          f"max_abs_err={err:.3e}")
    return err


def _assert_close(got, want, tol):
    _max_err(got, want)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-3), ("bf16", 5e-2)])
def test_fuse_pair_conv2_plain_matches_pallas(dtype, tol):
    """K6 at the JAX test's shape (s=2, f=3, 8x8, k=128, two co tiles);
    tolerances of tests/test_pallas_fuse.py:37 (f32 1e-3, bf16 5e-2)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    s, f, h, w, k = 2, 3, 8, 8, 128
    c1a = rng.standard_normal((s, h, w, k)).astype(np.float32)
    c1t = rng.standard_normal((f, h, w, k)).astype(np.float32)
    k2 = (rng.standard_normal((3, 3, k, k)) * 0.05).astype(np.float32)
    want = j_fuse_pair(jnp.asarray(c1a, jdt), jnp.asarray(c1t, jdt),
                       jnp.asarray(k2, jdt), co_tile=64)
    got = fuse_pair_conv2(_torch(c1a, tdt), _torch(c1t, tdt), _oihw(k2))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    _assert_close(got, want, tol)


def _conv_inputs(seed, b=2, h=8, w=8, c=32, co=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, co)) * 0.1).astype(np.float32)
    skip = rng.standard_normal((b, h, w, co)).astype(np.float32)
    return x, k, skip


# f32: 1e-4, tests/test_pallas_conv.py:38. bf16: both sides round an fp32
# result of order 1 to bf16 once, so they may sit one bf16 step apart
# (2^-7 relative; 1.6e-2 at |y| = 2): 2e-2.
CONV_CASES = {
    "relu": dict(relu=True, skip=False, dtype="f32", tol=1e-4),
    "no_relu": dict(relu=False, skip=False, dtype="f32", tol=1e-4),
    "skip": dict(relu=False, skip=True, dtype="f32", tol=1e-4),
    "relu_bf16": dict(relu=True, skip=False, dtype="bf16", tol=2e-2),
    "skip_bf16": dict(relu=False, skip=True, dtype="bf16", tol=2e-2),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv3x3_in_plain_matches_pallas(case):
    """K7 (relu on and off, skip; f32 and bf16) at the JAX test's shape
    (2, 8, 8, 32)."""
    conf = CONV_CASES[case]
    jdt, tdt = DTYPES[conf["dtype"]]
    x, k, skip = _conv_inputs(1)
    jskip = jnp.asarray(skip, jdt) if conf["skip"] else None
    want = j_conv3x3_in(jnp.asarray(x, jdt), jnp.asarray(k, jdt), skip=jskip,
                        relu=conf["relu"])
    got = conv3x3_in(_torch(x, tdt), _oihw(k),
                     skip=_torch(skip, tdt) if conf["skip"] else None,
                     relu=conf["relu"])
    assert got.dtype == tdt
    _assert_close(got, want, conf["tol"])


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-4), ("bf16", 2e-2)])
def test_resblock_fused_plain_matches_pallas(dtype, tol):
    """One ResnetBlock as two K7 calls, against the JAX package's
    `resblock_fused` (b=3, as tests/test_pallas_conv.py:53)."""
    jdt, tdt = DTYPES[dtype]
    x, k1, _ = _conv_inputs(2, b=3)
    _, k2, _ = _conv_inputs(3)
    want = j_resblock(jnp.asarray(x, jdt), jnp.asarray(k1, jdt),
                      jnp.asarray(k2, jdt))
    got = resblock_fused(_torch(x, tdt), _oihw(k1), _oihw(k2))
    _assert_close(got, want, tol)


def test_conv3x3_in_rect_and_ragged_width():
    """6 x 10 pixels, 16 -> 48 channels (a width that is not a power of
    two), as tests/test_pallas_conv.py:63, f32 at 1e-4."""
    x, k, _ = _conv_inputs(4, b=1, h=6, w=10, c=16, co=48)
    want = j_conv3x3_in(jnp.asarray(x), jnp.asarray(k), relu=True)
    got = conv3x3_in(torch.from_numpy(x), _oihw(k), relu=True)
    assert tuple(got.shape) == (1, 6, 10, 48)
    _assert_close(got, want, 1e-4)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    rng = np.random.default_rng(5)
    c1a = torch.from_numpy(rng.standard_normal((2, 6, 6, 16)).astype(
        np.float32)).to(torch.bfloat16)
    c1t = torch.from_numpy(rng.standard_normal((3, 6, 6, 16)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((16, 16, 3, 3)).astype(
        np.float32)) * 0.1
    cuda_build.reset_launches()
    assert torch.equal(fuse_pair_conv2(c1a, c1t, w),
                       fuse_pair_conv2_plain(c1a, c1t, w))
    assert torch.equal(conv3x3_in(c1a, w, skip=c1a, relu=False),
                       conv3x3_in_plain(c1a, w, skip=c1a, relu=False))
    assert torch.equal(resblock_fused(c1t, w, w),
                       resblock_fused(c1t, w, w, use_kernels=False))
    assert set(cuda_build.LAUNCHES.values()) == {0}


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, device="meta", dtype=dtype)


REFUSALS = {
    "k6_not_cuda": (lambda: fuse_pair_conv2(
        _meta(2, 4, 4, 16), _meta(3, 4, 4, 16), _meta(16, 16, 3, 3)),
        "CUDA tensors"),
    "k6_f32": (lambda: fuse_pair_conv2(
        _meta(2, 4, 4, 16, dtype=torch.float32),
        _meta(3, 4, 4, 16, dtype=torch.float32), _meta(16, 16, 3, 3)),
        "bfloat16"),
    "k6_channels": (lambda: fuse_pair_conv2(
        _meta(2, 4, 4, 12), _meta(3, 4, 4, 12), _meta(12, 12, 3, 3)),
        "multiples of 8"),
    "k6_weight_shape": (lambda: fuse_pair_conv2(
        _meta(2, 4, 4, 16), _meta(3, 4, 4, 16), _meta(16, 8, 3, 3)),
        r"\(Co, K, 3, 3\)"),
    "k7_not_cuda": (lambda: conv3x3_in(_meta(2, 4, 4, 16),
                                       _meta(16, 16, 3, 3)), "CUDA tensors"),
    "k7_f32": (lambda: conv3x3_in(_meta(2, 4, 4, 16, dtype=torch.float32),
                                  _meta(16, 16, 3, 3)), "bfloat16"),
    "k7_not_contiguous": (lambda: conv3x3_in(
        _meta(2, 4, 4, 16).transpose(1, 2), _meta(16, 16, 3, 3)),
        "contiguous"),
    "k7_channels": (lambda: conv3x3_in(_meta(2, 4, 4, 16),
                                       _meta(20, 16, 3, 3)),
                    "multiples of 8"),
    "k7_one_row": (lambda: conv3x3_in(_meta(2, 1, 4, 16),
                                      _meta(16, 16, 3, 3)), "at least 2"),
    "k7_skip_shape": (lambda: conv3x3_in(_meta(2, 4, 4, 16),
                                         _meta(16, 16, 3, 3),
                                         skip=_meta(2, 4, 4, 8)), "skip"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    """Off the CPU a wrapper launches its kernel or raises: a tensor on a
    device with no kernel, another dtype than bf16, a strided view, a
    channel count off the 8-channel chunks, a plane too small to reflect,
    or mismatched shapes are refused, never sent to the plain version."""
    call, match = REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        call()


def test_gemm_weight_repacks_once_and_follows_in_place_changes():
    """The kernels' (Co, 3, 3, C) bf16 weight is repacked once per weight
    tensor and again only after the weight changes in place."""
    w = torch.nn.Parameter(torch.randn(16, 8, 3, 3))
    packed = cuda_build.gemm_weight(w)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert torch.equal(packed, w.detach().to(torch.bfloat16).permute(0, 2, 3, 1))
    assert cuda_build.gemm_weight(w) is packed
    with torch.no_grad():
        w.mul_(-1)
    again = cuda_build.gemm_weight(w)
    assert again is not packed and torch.equal(again, -packed)
