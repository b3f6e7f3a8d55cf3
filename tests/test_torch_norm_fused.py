"""K8's plain version against the JAX package's `instance_norm_fused`.

On the CPU the port's wrapper `instance_norm_fused` runs its plain
version; the JAX side runs its two Pallas kernels (`_stats_kernel`,
`_norm_kernel`) in interpret mode, or its fallback (`instance_norm` /
`instance_norm_phase`) where H*W is not a multiple of 8. Also the port's
`instance_norm_phase` against the JAX package's (`ops/upconv.py`), the
phase identity with `ops/warp.py:space_to_depth`, the degenerate-channel
case of tests/test_fuse_clip.py:49-61 and the wrapper's refusals. The
CUDA kernel itself is held against the plain version on the GPU
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wacv23_tsnet_tpu.ops.pallas_norms import \
    instance_norm_fused as j_in_fused
from wacv23_tsnet_tpu.ops.upconv import instance_norm_phase as j_in_phase
from wacv23_tsnet_tpu_torch.ops import cuda_build
from wacv23_tsnet_tpu_torch.ops.norm_kernels import (instance_norm_fused,
                                                     instance_norm_fused_plain)
from wacv23_tsnet_tpu_torch.ops.norms import (instance_norm,
                                              instance_norm_phase)
from wacv23_tsnet_tpu_torch.ops.warp import space_to_depth

torch.set_num_threads(2)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _x(seed, shape) -> np.ndarray:
    """Activations with a per-channel offset, so the mean matters."""
    rng = np.random.default_rng(seed)
    offset = rng.standard_normal(shape[-1]) * 2
    return (rng.standard_normal(shape) * 1.5 + offset).astype(np.float32)


def _check(got: torch.Tensor, want, dtype: str, atol: float = 1e-5):
    """f32 within `atol`; bf16 within one bf16 step of the JAX value
    (2^-7 relative): both round an fp32 result once, and the two sides'
    fp32 sums, taken in another order, may put a value a rounding away
    from a tie on the other side of it."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    err = np.abs(got - want)
    # the measured error, shown by `pytest -s`
    print(f"[parity] {os.environ.get('PYTEST_CURRENT_TEST', '').split()[0]}: "
          f"max_abs_err={err.max():.3e}")
    rtol = 2.0 ** -7 if dtype == "bf16" else 0.0
    assert (err <= atol + rtol * np.abs(want)).all(), err.max()


# (B, H, W, C): square, and a non-square plane (H*W a multiple of 8, so
# JAX runs its Pallas kernels)
SHAPES = {"square": (2, 8, 8, 32), "rect": (1, 4, 16, 64)}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("relu", [False, True], ids=["norm", "relu"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_in_fused_plain_matches_jax_pallas(dtype, relu, groups, shape):
    jdt, tdt = DTYPES[dtype]
    x = _x(0, SHAPES[shape])
    want = j_in_fused(jnp.asarray(x, jdt), relu=relu, phase_groups=groups)
    cuda_build.reset_launches()
    got = instance_norm_fused(torch.from_numpy(x).to(tdt), relu=relu,
                              phase_groups=groups)
    assert set(cuda_build.LAUNCHES.values()) == {0}
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    _check(got, want, dtype)


@pytest.mark.parametrize("groups", [1, 4])
def test_in_fused_plain_matches_jax_fallback(groups):
    """H*W = 35, not a multiple of 8: JAX takes `instance_norm` /
    `instance_norm_phase` (two-pass in f32), the port its one-pass plain
    version; within 1e-4."""
    x = _x(1, (2, 5, 7, 16))
    want = j_in_fused(jnp.asarray(x), relu=True, phase_groups=groups)
    got = instance_norm_fused(torch.from_numpy(x), relu=True,
                              phase_groups=groups)
    _check(got, want, "f32", atol=1e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_instance_norm_phase_matches_jax(dtype):
    """f32 within 1e-5 (two-pass on both sides); bf16 one-pass on both,
    within one bf16 step."""
    jdt, tdt = DTYPES[dtype]
    x = _x(2, (2, 6, 4, 4 * 12))
    want = j_in_phase(jnp.asarray(x, jdt))
    got = instance_norm_phase(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    _check(got, want, dtype)


def test_phase_groups_match_the_interleaved_norm():
    """The phase layout of `space_to_depth(x, 2)` with `phase_groups=4`
    normalises as the interleaved tensor does, for the fused norm and for
    `instance_norm_phase`."""
    x = torch.from_numpy(_x(3, (2, 8, 12, 16)))
    want = space_to_depth(instance_norm_fused(x, relu=True), 2)
    got = instance_norm_fused(space_to_depth(x, 2), relu=True,
                              phase_groups=4)
    assert (got - want).abs().max().item() <= 1e-5
    phase = instance_norm_phase(space_to_depth(x, 2))
    assert (phase - space_to_depth(instance_norm(x), 2)).abs().max() <= 1e-5


def test_degenerate_channel_is_finite():
    """A near-constant channel with a large mean makes the one-pass
    variance cancel below 0 in fp32; clamped, the output stays finite
    (tests/test_fuse_clip.py:49-61)."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy((300.0 + rng.standard_normal((2, 8, 8, 16)) * 1e-3)
                         .astype(np.float32)).to(torch.bfloat16)
    for y in (instance_norm_phase(x), instance_norm_fused(x),
              instance_norm_fused(x, phase_groups=4),
              instance_norm_fused_plain(x.float(), phase_groups=4)):
        assert bool(torch.isfinite(y.float()).all())


def _meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(*shape, device="meta", dtype=dtype,
                       requires_grad=grad)


REFUSALS = {
    "not_cuda": (lambda: instance_norm_fused(_meta(2, 4, 4, 16)),
                 "CUDA tensors"),
    "requires_grad": (lambda: instance_norm_fused(
        _meta(2, 4, 4, 16, dtype=torch.float32, grad=True)),
        "inference only"),
    "rank": (lambda: instance_norm_fused(_meta(4, 4, 16)),
             r"\(B, H, W, C\)"),
    "groups": (lambda: instance_norm_fused(_meta(2, 4, 4, 18),
                                           phase_groups=4), "multiple"),
    "float16": (lambda: instance_norm_fused(
        _meta(2, 4, 4, 16, dtype=torch.float16)), "bfloat16"),
    "not_contiguous": (lambda: instance_norm_fused(
        _meta(2, 4, 4, 16).transpose(1, 2)), "contiguous"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_in_fused_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Off the CPU the wrapper launches its kernel or raises: a tensor
    that requires grad while grad mode is on (the kernel has no
    gradient), a wrong rank, C off the phase groups, another dtype, a
    strided view or a device with no kernel; nothing is sent to the plain
    version."""
    call, match = REFUSALS[case]
    cuda_build.reset_launches()
    with pytest.raises(ValueError, match=match):
        call()
    assert set(cuda_build.LAUNCHES.values()) == {0}


def test_in_fused_grad_refusal_follows_grad_mode():
    """Under no_grad a tensor that requires grad is no reason to refuse:
    the call goes on to the device check."""
    x = _meta(2, 4, 4, 16, dtype=torch.float32, grad=True)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        instance_norm_fused(x)
