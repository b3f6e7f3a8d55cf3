"""K5's plain version against the JAX package's `masked_attention_flow_fused`.

On the CPU the port's wrapper `masked_attention_flow_fused` runs its plain
version; the JAX side runs its Pallas kernel in interpret mode, as the
JAX package's own tests do (tests/test_ops_core.py:209-253), or its einsum
fallback where T does not tile by 256. Gradients of all five inputs are
held against `jax.vjp` of the JAX entry (its einsum VJP), and
`transformation_warp(use_kernels=True)` against the JAX package's
`transformation_warp(use_pallas=True)`. The CUDA kernel itself is held
against this plain version on the GPU (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wacv23_tsnet_tpu.ops import similarity as jsim
from wacv23_tsnet_tpu.ops.pallas_similarity import \
    masked_attention_flow_fused as j_flow_fused
from wacv23_tsnet_tpu_torch.ops import cuda_build
from wacv23_tsnet_tpu_torch.ops.flow_kernels import (
    masked_attention_flow, masked_attention_flow_fused)
from wacv23_tsnet_tpu_torch.ops.similarity import transformation_warp

torch.set_num_threads(2)


def _unit(a: np.ndarray) -> np.ndarray:
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def _flow_inputs(seed, b, t, s, c, real_masks=False):
    """L2-normalised features, masks (binary, or real values in [0, 1])
    and a random grid in [-1, 1], as numpy f32."""
    rng = np.random.default_rng(seed)
    tar = _unit(rng.standard_normal((b, t, c)))
    src = _unit(rng.standard_normal((b, s, c)))
    if real_masks:
        mt = rng.random((b, t)).astype(np.float32)
        ms = rng.random((b, s)).astype(np.float32)
    else:
        mt = (rng.random((b, t)) > 0.5).astype(np.float32)
        ms = (rng.random((b, s)) > 0.5).astype(np.float32)
    grid = (rng.random((s, 2)) * 2 - 1).astype(np.float32)
    return tar, src, mt, ms, grid


def _report(got, want) -> float:
    err = float(np.max(np.abs(np.asarray(got, np.float64)
                              - np.asarray(want, np.float64))))
    # the measured error, shown by `pytest -s`
    print(f"[parity] {os.environ.get('PYTEST_CURRENT_TEST', '').split()[0]}: "
          f"max_abs_err={err:.3e}")
    return err


# (B, T, S, C, real masks): the JAX test's shape (T = 256 tiles once);
# T = S = 100 (one 100-row tile in JAX); T = 300, S = 200 (T does not
# tile by 256: JAX takes its einsum fallback), real-valued masks
FLOW_CASES = {"tiled": (2, 256, 256, 32, False),
              "small_tile": (2, 100, 100, 16, True),
              "ragged_fallback": (1, 300, 200, 24, True)}


@pytest.mark.parametrize("case", list(FLOW_CASES))
def test_flow_plain_matches_jax_fused(case):
    """Temp 100, within 1e-5 (tests/test_ops_core.py:225)."""
    args = _flow_inputs(0, *FLOW_CASES[case])
    want = j_flow_fused(*map(jnp.asarray, args), 100.0)
    cuda_build.reset_launches()
    got = masked_attention_flow_fused(*map(torch.from_numpy, args),
                                      temp=100.0)
    assert set(cuda_build.LAUNCHES.values()) == {0}
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _report(got.numpy(), want) <= 1e-5
    assert torch.equal(got, masked_attention_flow(
        *map(torch.from_numpy, args), temp=100.0))


@pytest.mark.parametrize("shape", [(1, 64, 64, 8, False),
                                   (2, 100, 72, 16, True)],
                         ids=["jax_test", "ragged_real_masks"])
def test_flow_gradients_match_jax(shape):
    """All five input gradients under one fixed cotangent of the flow, at
    temp 10, against `jax.vjp` of the JAX entry, within 1e-5
    (tests/test_ops_core.py:228-253)."""
    args = _flow_inputs(1, *shape)
    ct = np.random.default_rng(2).standard_normal(
        (shape[0], shape[1], 2)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: j_flow_fused(*a, 10.0),
                     *map(jnp.asarray, args))
    want = vjp(jnp.asarray(ct))
    inputs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    flow = masked_attention_flow_fused(*inputs, temp=10.0)
    got = torch.autograd.grad(flow, inputs, torch.from_numpy(ct))
    for name, g, w in zip(("tar_fea", "src_fea", "tar_mask", "src_mask",
                           "grid"), got, want):
        assert tuple(g.shape) == w.shape, name
        assert _report(g.numpy(), w) <= 1e-5, name


def test_transformation_warp_kernel_path_matches_jax_pallas():
    """`transformation_warp(use_kernels=True)` against the JAX package's
    `transformation_warp(use_pallas=True)` at temp 100: flow within 2e-5,
    warped features within 1e-4 (tests/test_ops_core.py:204-206)."""
    rng = np.random.default_rng(3)
    b, h, w, c = 2, 16, 16, 32
    fea = rng.standard_normal((b, h, w, c)).astype(np.float32)
    args = (fea, _unit(rng.standard_normal((b, h, w, c))), _unit(fea),
            (rng.random((b, h, w)) > 0.5).astype(np.float32),
            (rng.random((b, h, w)) > 0.5).astype(np.float32))
    want_w, want_f = jsim.transformation_warp(*map(jnp.asarray, args),
                                              temp=100.0, use_pallas=True)
    got_w, got_f = transformation_warp(*map(torch.from_numpy, args),
                                       temp=100.0, use_kernels=True)
    assert _report(got_f.numpy(), want_f) <= 2e-5
    assert _report(got_w.numpy(), want_w) <= 1e-4
    plain_w, plain_f = transformation_warp(*map(torch.from_numpy, args),
                                           temp=100.0)
    assert torch.equal(plain_f, got_f) and torch.equal(plain_w, got_w)


def _meta(*shape):
    return torch.empty(*shape, device="meta")


def _flow_call(tar=(2, 16, 8), src=(2, 12, 8), mt=(2, 16), ms=(2, 12),
               grid=(12, 2)):
    return lambda: masked_attention_flow_fused(
        _meta(*tar), _meta(*src), _meta(*mt), _meta(*ms), _meta(*grid))


REFUSALS = {
    "not_cuda": (_flow_call(), "CUDA tensors"),
    "tar_rank": (_flow_call(tar=(16, 8)), r"tar_fea \(B, T, C\)"),
    "src_rank": (_flow_call(src=(2, 12, 8, 1)), r"tar_fea \(B, T, C\)"),
    "batch": (_flow_call(src=(3, 12, 8)), "src_fea must be"),
    "channels": (_flow_call(src=(2, 12, 4)), "src_fea must be"),
    "tar_mask": (_flow_call(mt=(2, 12)), "tar_mask must be"),
    "src_mask": (_flow_call(ms=(2, 16)), "src_mask must be"),
    "grid_rows": (_flow_call(grid=(16, 2)), "grid must be"),
    "grid_cols": (_flow_call(grid=(12, 3)), "grid must be"),
    "empty": (_flow_call(tar=(2, 0, 8), mt=(2, 0)), "empty"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_flow_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Off the CPU the wrapper launches its kernel or raises: a tensor on
    a device with no kernel, a wrong rank, mismatched B, C or S, a grid
    that is not (S, 2) or an empty input is refused, never sent to the
    plain version."""
    call, match = REFUSALS[case]
    cuda_build.reset_launches()
    with pytest.raises(ValueError, match=match):
        call()
    assert set(cuda_build.LAUNCHES.values()) == {0}
