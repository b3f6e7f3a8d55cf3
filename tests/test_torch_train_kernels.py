"""The training kernels' plain versions against the JAX package (CPU).

K3-flow (the forward of `transform_warp_pairs` with the flow output), K4
(its flash backward: six cotangents) and K2's gradient. On the CPU the
port's wrappers run their plain versions; the JAX side runs its Pallas
kernels in interpret mode and its real custom VJPs (at T=100, which does
not tile, the JAX package takes its `_pairs_ref` VJP). The CUDA kernels
are held against the same plain versions on the GPU
(tests/test_torch_cuda.py, chip_smoke.py). `pytest -s` prints each
measured error.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wacv23_tsnet_tpu.ops.pallas_norms import instance_norm_mean as j_in_mean
from wacv23_tsnet_tpu.ops.pallas_similarity import (
    transform_warp_pairs as j_warp_pairs)
from wacv23_tsnet_tpu_torch.ops.norm_kernels import instance_norm_mean
from wacv23_tsnet_tpu_torch.ops.warp_kernels import (
    bwd_launcher, transform_warp_pairs, transform_warp_pairs_bwd,
    transform_warp_pairs_fwd)

torch.set_num_threads(2)
NAMES = ("src_fea", "tar_fea_n", "src_fea_n", "tar_mask", "src_mask", "grid")


def _report(**errors):
    name = os.environ.get("PYTEST_CURRENT_TEST", "").split()[0]
    print(f"[parity] {name}: " + " ".join(
        f"{k}={v:.3e}" for k, v in errors.items()))


def _inputs(seed, g=2, ns=2, nf=2, h=16, w=16, c=64):
    """The inputs of tests/test_pallas_backward.py, from a numpy seed."""
    rng = np.random.default_rng(seed)
    t = h * w
    src_fea = rng.standard_normal((g, ns, t, c)).astype(np.float32)
    tar_fea = rng.standard_normal((g, nf, t, c)).astype(np.float32)

    def norm(x):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                              1e-12)
    ys, xs = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    grid = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    return (src_fea, norm(tar_fea), norm(src_fea),
            rng.integers(0, 2, (g, nf, t)).astype(np.float32),
            rng.integers(0, 2, (g, ns, t)).astype(np.float32), grid), (h, w)


@pytest.mark.parametrize("nf", [1, 2])
def test_warp_pairs_flow_forward_matches_pallas(nf):
    """K3-flow: warped and flow, and the row log-sum-exp the backward
    reads (against float64 numpy)."""
    args, (h, w) = _inputs(10 + nf, nf=nf)
    temp = 10.0
    want_w, want_f = jax.jit(functools.partial(
        j_warp_pairs, h=h, w=w, temp=temp))(*map(jnp.asarray, args))
    got_w, got_f, got_lse = transform_warp_pairs_fwd(
        *map(torch.from_numpy, args), h, w, temp)
    src, tn, sn, tm, sm, _ = (a.astype(np.float64) for a in args)
    logits = np.einsum("gftc,gsuc->gsftu", tn, sn)
    coeff = (tm[:, None, :, :, None] * sm[:, :, None, None, :]
             + (1 - tm[:, None, :, :, None]) * (1 - sm[:, :, None, None, :]))
    z = temp * logits * coeff
    zmax = z.max(-1)
    want_lse = zmax + np.log(np.exp(z - zmax[..., None]).sum(-1))
    errs = {"warped": np.abs(got_w.numpy() - np.asarray(want_w)).max(),
            "flow": np.abs(got_f.numpy() - np.asarray(want_f)).max(),
            "lse": np.abs(got_lse.numpy() - want_lse).max()}
    _report(**errs)
    assert got_w.shape == want_w.shape and got_f.shape == want_f.shape
    assert max(errs.values()) <= 1e-5, errs


@pytest.mark.parametrize("nf,hw", [(1, (16, 16)), (2, (16, 16)),
                                   (2, (10, 10))],
                         ids=["nf1", "nf2", "ragged_t100"])
def test_warp_pairs_backward_matches_jax_vjp(nf, hw):
    """K4's plain version (autograd through the plain forward) against
    `jax.vjp(transform_warp_pairs)`, all six cotangents, at temp 10 (at
    temp 100 random features saturate the softmax to one-hot and both
    sides give ~zero logit gradients), within 2e-4 * max(1, max |ref|)."""
    h, w = hw
    args, _ = _inputs(20 + nf + h, nf=nf, h=h, w=w)
    temp = 10.0
    g, ns, t, c = args[0].shape
    rng = np.random.default_rng(30 + nf + h)
    gw = rng.standard_normal((g, ns, nf, t, c)).astype(np.float32)
    gf = rng.standard_normal((g, ns, nf, t, 2)).astype(np.float32)
    _, vjp = jax.vjp(functools.partial(j_warp_pairs, h=h, w=w, temp=temp),
                     *map(jnp.asarray, args))
    want = vjp((jnp.asarray(gw), jnp.asarray(gf)))
    targs = [torch.from_numpy(a) for a in args]
    _, flow, lse = transform_warp_pairs_fwd(*targs, h, w, temp)
    got = transform_warp_pairs_bwd(*targs, flow, lse, torch.from_numpy(gw),
                                   torch.from_numpy(gf), h, w, temp)
    # the differentiable entry point gives the same cotangents
    leaves = [x.clone().requires_grad_(True) for x in targs]
    warped, flow2 = transform_warp_pairs(*leaves, h, w, temp)
    torch.autograd.backward((warped, flow2),
                            (torch.from_numpy(gw), torch.from_numpy(gf)))
    errs = {}
    for name, a, auto, b in zip(NAMES, got, leaves, want):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, name
        scale = max(1.0, np.abs(b).max())
        errs[name] = np.abs(a.numpy() - b).max() / scale
        assert torch.allclose(auto.grad, a, atol=1e-6, rtol=1e-5), name
    _report(**errs)
    assert max(errs.values()) <= 2e-4, errs


def test_instance_norm_mean_gradient_matches_jax_vjp():
    """K2's gradient: the port's autograd against the JAX custom VJP
    (which backpropagates through the recomputed XLA composition)."""
    rng = np.random.default_rng(40)
    x = (rng.standard_normal((3, 2, 8, 8, 64)) * 2 + 1).astype(np.float32)
    ct = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    want_y, vjp = jax.vjp(j_in_mean, jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = instance_norm_mean(xt)
    y.backward(torch.from_numpy(ct))
    errs = {"value": np.abs(y.detach().numpy() - np.asarray(want_y)).max(),
            "grad": np.abs(xt.grad.numpy() - np.asarray(want_g)).max()}
    _report(**errs)
    assert max(errs.values()) <= 1e-5, errs


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_warp_pairs_bwd_launcher_takes_only_cuda_tensors(device):
    """K4's launcher (the wrapper's launches) runs no plain version: CPU
    and meta tensors are refused before anything is allocated or built."""
    (src, tn, sn, tm, sm, grid), (h, w) = _inputs(0, g=1, ns=1, nf=1, h=4,
                                                 w=4, c=8)
    args = [torch.from_numpy(x).to(device) for x in (src, tn, sn, tm, sm,
                                                     grid)]
    flow = torch.zeros(1, 1, 1, h * w, 2, device=device)
    lse = torch.zeros(1, 1, 1, h * w, device=device)
    gw = torch.zeros(1, 1, 1, h * w, 8, device=device)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bwd_launcher(*args, flow, lse, gw, flow, h, w)
