"""The port's tensor ops against their JAX counterparts (CPU).

Same inputs, made with numpy from fixed seeds, go through the JAX
package's op and the port's; both are fp32 on the CPU, so the tolerance
is 1e-5 absolute (float rounding of a different summation order), and
one bf16 step where the op's output is bf16.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wacv23_tsnet_tpu import ops as jops
from wacv23_tsnet_tpu.nn.blocks import reflect_pad as j_reflect_pad
from wacv23_tsnet_tpu_torch import ops
from wacv23_tsnet_tpu_torch.nn.blocks import reflect_pad

torch.set_num_threads(2)
ATOL = 1e-5
BF16_STEP = 2.0 ** -8      # relative spacing of bf16 values


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, atol=ATOL, rtol=0.0):
    got = np.asarray(got.float() if torch.is_tensor(got) else got, np.float32)
    want = np.asarray(want, np.float32)
    # the measured error, shown by `pytest -s`
    print(f"[parity] {os.environ.get('PYTEST_CURRENT_TEST', '').split()[0]}: "
          f"max_abs_err={np.abs(got - want).max():.3e} "
          f"atol={atol} rtol={rtol}")
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("h,w", [(32, 32), (5, 9)])
def test_coords(h, w):
    _close(ops.normalized_grid(h, w), jops.normalized_grid(h, w))
    x = _rng(0).standard_normal((2, h, w, 4)).astype(np.float32)
    _close(ops.coord_channels(torch.from_numpy(x)),
           jops.coord_channels(jnp.asarray(x)))


def test_instance_norm_fp32_two_pass():
    x = (_rng(1).standard_normal((3, 8, 8, 16)) * 3 + 2).astype(np.float32)
    _close(ops.instance_norm(torch.from_numpy(x)),
           jops.instance_norm(jnp.asarray(x)))


def test_instance_norm_bf16_one_pass():
    x = (_rng(2).standard_normal((3, 8, 8, 16)) * 3 + 2).astype(np.float32)
    got = ops.instance_norm(torch.from_numpy(x).to(torch.bfloat16))
    want = jops.instance_norm(jnp.asarray(x).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    # same fp32 statistics; the bf16 output may round one step apart
    _close(got, want.astype(jnp.float32), rtol=BF16_STEP)


def test_instance_norm_degenerate_channel_is_finite():
    # a near-constant channel with a large mean cancels E[x^2]-E[x]^2
    # below zero in the one-pass form; the clamp keeps it finite
    x = 300.0 + _rng(3).standard_normal((2, 8, 8, 16)) * 1e-3
    got = ops.instance_norm(torch.from_numpy(x.astype(np.float32))
                            .to(torch.bfloat16))
    assert torch.isfinite(got.float()).all()


def test_l2_normalize():
    x = _rng(4).standard_normal((2, 7, 32)).astype(np.float32)
    x[0, 0] = 0.0                                   # eps branch
    _close(ops.l2_normalize(torch.from_numpy(x)),
           jops.l2_normalize(jnp.asarray(x)))


@pytest.mark.parametrize("hw,out", [(64, 16), (10, 4), (8, 12)])
def test_resize_nearest(hw, out):
    from wacv23_tsnet_tpu.ops.resize import resize_nearest
    x = _rng(5).random((2, hw, hw, 1)).astype(np.float32)
    _close(ops.resize_nearest(torch.from_numpy(x), (out, out)),
           resize_nearest(jnp.asarray(x), (out, out)))


def test_upsample_bilinear_2x():
    from wacv23_tsnet_tpu.ops.resize import upsample_bilinear_2x
    x = _rng(6).standard_normal((2, 6, 5, 3)).astype(np.float32)
    _close(ops.upsample_bilinear_2x(torch.from_numpy(x)),
           upsample_bilinear_2x(jnp.asarray(x)))


@pytest.mark.parametrize("p", [1, 3])
def test_reflect_pad(p):
    x = _rng(7).standard_normal((2, 8, 7, 3)).astype(np.float32)
    _close(reflect_pad(torch.from_numpy(x), p),
           j_reflect_pad(jnp.asarray(x), p))


def test_grid_sample_zero_padding():
    rng = _rng(8)
    img = rng.standard_normal((2, 6, 7, 5)).astype(np.float32)
    # reaches past the canvas so corners fall outside (weight 0)
    grid = rng.uniform(-1.3, 1.3, (2, 4, 3, 2)).astype(np.float32)
    _close(ops.grid_sample(torch.from_numpy(img), torch.from_numpy(grid)),
           jops.grid_sample(jnp.asarray(img), jnp.asarray(grid)))


def test_masked_attention_flow():
    rng = _rng(9)
    b, t, s, c = 2, 24, 20, 16
    tar = np.array(jops.l2_normalize(jnp.asarray(
        rng.standard_normal((b, t, c)), jnp.float32)))
    src = np.array(jops.l2_normalize(jnp.asarray(
        rng.standard_normal((b, s, c)), jnp.float32)))
    mt = (rng.random((b, t)) > 0.5).astype(np.float32)
    ms = (rng.random((b, s)) > 0.5).astype(np.float32)
    grid = rng.uniform(-1, 1, (s, 2)).astype(np.float32)
    args = (tar, src, mt, ms, grid)
    _close(ops.masked_attention_flow(*map(torch.from_numpy, args), temp=100.0),
           jops.masked_attention_flow(*map(jnp.asarray, args), temp=100.0))


def test_transformation_warp_plain():
    from wacv23_tsnet_tpu.ops.similarity import transformation_warp
    rng = _rng(10)
    b, h, w, c = 2, 6, 6, 8
    fea = rng.standard_normal((b, h, w, c)).astype(np.float32)
    fea_n = np.array(jops.l2_normalize(jnp.asarray(fea)))
    tar_n = np.array(jops.l2_normalize(jnp.asarray(
        rng.standard_normal((b, h, w, c)), jnp.float32)))
    tm = (rng.random((b, h, w)) > 0.5).astype(np.float32)
    sm = (rng.random((b, h, w)) > 0.5).astype(np.float32)
    args = (fea, tar_n, fea_n, tm, sm)
    got_w, got_f = ops.transformation_warp(*map(torch.from_numpy, args))
    want_w, want_f = transformation_warp(*map(jnp.asarray, args),
                                         use_pallas=False)
    _close(got_f, want_f)
    _close(got_w, want_w, atol=1e-4)   # flow error x feature gradient
