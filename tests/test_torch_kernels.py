"""The kernels' plain versions against the JAX package's Pallas kernels.

On the CPU each wrapper of the port runs its kernel's plain version; the
JAX side runs its Pallas kernel in interpret mode, as the JAX package's
own tests do. Tolerances are the JAX package's own for the same
functions (tests/test_ops_core.py:256-312, tests/test_fuse_clip.py).
The CUDA kernels themselves are held against these plain versions on the
GPU (tests/test_torch_cuda.py, chip_smoke.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wacv23_tsnet_tpu import ops as jops
from wacv23_tsnet_tpu.ops import pallas_similarity as ps
from wacv23_tsnet_tpu.ops.pallas_norms import instance_norm_mean as j_in_mean
from wacv23_tsnet_tpu.ops.similarity import (
    transformation_warp_clip as j_warp_clip,
    transformation_warp_clip_mean as j_warp_clip_mean)
from wacv23_tsnet_tpu_torch.ops import cuda_build, warp_kernels
from wacv23_tsnet_tpu_torch.ops.norm_kernels import (instance_norm_mean,
                                                     launcher,
                                                     mean_cluster_size,
                                                     mean_tiles)
from wacv23_tsnet_tpu_torch.ops.similarity import (
    transformation_warp_clip, transformation_warp_clip_mean)

torch.set_num_threads(2)


def _clip_inputs(seed, s=3, f=4, h=16, w=16, c=32):
    """Source/target features and masks of one clip (t = 256 pixels,
    which tiles the Pallas kernels)."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((s, h, w, c)).astype(np.float32)
    src_n = np.array(jops.l2_normalize(jnp.asarray(src)))
    sm = (rng.random((s, h, w)) > 0.5).astype(np.float32)
    tar_n = np.array(jops.l2_normalize(jnp.asarray(
        rng.standard_normal((f, h, w, c)), jnp.float32)))
    tm = (rng.random((f, h, w)) > 0.5).astype(np.float32)
    return src, src_n, sm, tar_n, tm


def _max_err(got, want):
    err = float(np.max(np.abs(got.float().numpy()
                              - np.asarray(want, np.float32))))
    # the measured error, shown by `pytest -s`
    print(f"[parity] {os.environ.get('PYTEST_CURRENT_TEST', '').split()[0]}: "
          f"max_abs_err={err:.3e}")
    return err


@pytest.mark.parametrize("resident_budget", [None, 0],
                         ids=["resident", "bigt"])
def test_warp_mean_f32_matches_pallas(monkeypatch, resident_budget):
    """K1, f32 out, against both TPU forms: the all-sources-resident
    kernel and the big-T kernel (forced by a zero resident budget)."""
    if resident_budget is not None:
        monkeypatch.setattr(ps, "MEAN_KERNEL_RESIDENT_BUDGET", resident_budget)
    args = _clip_inputs(0, f=2 if resident_budget == 0 else 4)
    want = j_warp_clip_mean(*map(jnp.asarray, args))
    got = transformation_warp_clip_mean(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32
    assert _max_err(got, want) <= 1e-4


@pytest.mark.parametrize("resident_budget", [None, 0],
                         ids=["resident", "bigt"])
def test_warp_mean_bf16_matches_pallas_fast_warp(monkeypatch, resident_budget):
    """K1 with bf16 out against the JAX fast tier (bf16x3 logits, one
    bf16 pass of the tent matmul): 0.05, the JAX package's bound."""
    if resident_budget is not None:
        monkeypatch.setattr(ps, "MEAN_KERNEL_RESIDENT_BUDGET", resident_budget)
    args = _clip_inputs(1, f=2)
    want = j_warp_clip_mean(*map(jnp.asarray, args), fast_warp=True,
                            out_dtype=jnp.bfloat16)
    got = transformation_warp_clip_mean(*map(torch.from_numpy, args),
                                        out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert _max_err(got, want.astype(jnp.float32)) <= 0.05


def test_warp_pairs_nf_matches_pallas():
    """K3-nf: every (source, frame) pair in f32."""
    args = _clip_inputs(2)
    want = j_warp_clip(*map(jnp.asarray, args), use_pallas=True)
    got = transformation_warp_clip(*map(torch.from_numpy, args))
    assert tuple(got.shape) == want.shape
    assert _max_err(got, want) <= 1e-4


def test_warp_ragged_t_matches_einsum_reference():
    """T = 10 x 10 tiles neither the TPU kernels nor the CUDA kernel's
    64-row tiles; the JAX einsum composition is the reference."""
    args = _clip_inputs(3, s=2, f=3, h=10, w=10, c=16)
    want = j_warp_clip(*map(jnp.asarray, args), use_pallas=False)
    got = transformation_warp_clip(*map(torch.from_numpy, args))
    assert _max_err(got, want) <= 1e-4
    got_mean = transformation_warp_clip_mean(*map(torch.from_numpy, args))
    assert _max_err(got_mean, jnp.mean(want, axis=0)) <= 1e-4


def test_instance_norm_mean_f32_matches_pallas():
    x = np.random.default_rng(4).standard_normal((3, 4, 8, 8, 16)).astype(
        np.float32)
    want = j_in_mean(jnp.asarray(x))
    got = instance_norm_mean(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _max_err(got, want)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_instance_norm_mean_bf16_out_matches_pallas():
    x = np.random.default_rng(5).standard_normal((2, 3, 8, 8, 16)).astype(
        np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = j_in_mean(xb, out_dtype=jnp.bfloat16)
    got = instance_norm_mean(torch.from_numpy(x).to(torch.bfloat16),
                             out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _max_err(got, want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


def test_instance_norm_mean_degenerate_channel_is_finite():
    x = 300.0 + np.random.default_rng(6).standard_normal((1, 2, 8, 8, 16)) \
        * 1e-3
    got = instance_norm_mean(torch.from_numpy(x.astype(np.float32)))
    assert torch.isfinite(got).all()


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    cuda_build.reset_launches()
    src, src_n, sm, tar_n, tm = map(torch.from_numpy, _clip_inputs(7, f=2))
    transformation_warp_clip(src, src_n, sm, tar_n, tm)
    transformation_warp_clip_mean(src, src_n, sm, tar_n, tm,
                                  out_dtype=torch.bfloat16)
    instance_norm_mean(torch.randn(2, 2, 4, 4, 8))
    assert set(cuda_build.LAUNCHES.values()) == {0}


def test_wrappers_refuse_other_devices():
    """Off the CPU a wrapper launches its kernel or raises; a tensor on a
    device with no kernel is refused, never sent to the plain version."""
    meta = dict(device="meta", dtype=torch.float32)
    s, f, t, c = 2, 3, 16, 8
    with pytest.raises(ValueError, match="CUDA tensors"):
        warp_kernels.transform_warp_pairs_mean(
            torch.empty(s, t, c, **meta), torch.empty(f, t, c, **meta),
            torch.empty(s, t, c, **meta), torch.empty(f, t, **meta),
            torch.empty(s, t, **meta), torch.empty(t, 2, **meta), 4, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        instance_norm_mean(torch.empty(s, f, 4, 4, c, **meta))


# (H, W) -> K2's tiles of 128 pixels and its cluster (0: the two-pass path)
K2_PLANES = {(32, 32): (8, 8), (5, 7): (1, 1), (16, 16): (2, 2),
             (8, 128): (8, 8), (33, 32): (9, 0), (64, 64): (32, 0)}


@pytest.mark.parametrize("plane", list(K2_PLANES), ids=str)
def test_instance_norm_mean_path_follows_the_plane(plane):
    """A plane of at most 8 tiles of 128 pixels takes the one-launch
    cluster path (x read once) with a cluster of its tiles (FuseNet's
    32x32: 8); a larger one the two-pass path, so no plane is refused."""
    assert (mean_tiles(*plane), mean_cluster_size(*plane)) == K2_PLANES[plane]


@pytest.mark.parametrize("device", ["meta", "cpu"])
@pytest.mark.parametrize("two_pass", [None, True], ids=["auto", "two_pass"])
def test_instance_norm_mean_launcher_takes_only_cuda_tensors(device,
                                                             two_pass):
    """K2's launcher (its launches) refuses a tensor off CUDA on either
    path; only the wrapper sends CPU tensors to the plain version."""
    x = torch.empty(3, 2, 4, 4, 8, device=device)
    with pytest.raises(ValueError, match="CUDA tensors"):
        launcher(x, two_pass=two_pass)
