"""The port's `precision="high"` (`ops/dpconv.py`) against the JAX
package's `Precision.HIGH`: three bf16 passes (CPU).

- `split_bf16` bit for bit against the JAX package's `_split_bf16` on
  seeded fp32 bit patterns of every binade, signed zeros, subnormals,
  ties and values that round up into the next binade or past bf16's
  largest value; lo differs only where x or x - hi is subnormal, which
  XLA's CPU backend flushes to zero and torch keeps.
- `conv_bf16x3` against a JAX oracle, three `jax.lax.conv_general_dilated`
  calls on the bf16 splits with fp32 accumulation summed in the order of
  the JAX package's fused kernels (`ops/pallas_similarity.py`): hi·hi +
  (hi·lo + lo·hi), within 1e-6 relative L2, at the model's strides,
  paddings and groups (3x3 after a reflect pad and its thin band
  convs, the 7x7 stem, the stride-2 down conv, the phase decoder's bulk
  conv and its grouped ring convs), and where the hi·hi product is
  summed in pieces (wide channels, grouped, batch slices).
- `conv_bf16x3_backward` against `jax.vjp` of the same oracle, the
  cotangent split as the operands are, within 1e-6 relative L2.
- `conv2d(..., precision="high")` on a CPU tensor is the fp32 conv, bit
  for bit, forward and backward, as XLA's CPU backend computes HIGH.

`pytest -s` prints each measured error. The card's route, cuDNN with
TF32 on over the splits, is held against a float64 oracle in
tests/test_torch_cuda.py and chip_smoke.py `--high`.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wacv23_tsnet_tpu.ops.pallas_similarity import _split_bf16
from wacv23_tsnet_tpu_torch.ops import dpconv
from wacv23_tsnet_tpu_torch.ops.dpconv import (conv2d, conv_bf16x3,
                                               conv_bf16x3_backward,
                                               split_bf16)

torch.set_num_threads(2)
REL_L2 = 1e-6

# (x NCHW, w OIHW, stride, (row, column) padding, groups)
CASES = {
    "reflect3x3": ((2, 6, 12, 10), (8, 6, 3, 3), 1, (0, 0), 1),
    "reflect_band": ((2, 4, 8, 10), (5, 4, 3, 3), 1, (1, 0), 1),
    "stem7x7": ((2, 5, 22, 22), (8, 5, 7, 7), 1, (0, 0), 1),
    "down_s2": ((2, 8, 16, 16), (16, 8, 3, 3), 2, (1, 1), 1),
    "phase_bulk": ((2, 8, 9, 11), (12, 8, 3, 3), 1, (1, 1), 1),
    "ring_rows": ((2, 12, 2, 9), (24, 6, 2, 3), 1, (0, 0), 2),
    "ring_cols": ((2, 12, 9, 2), (24, 6, 3, 2), 1, (0, 0), 2),
    "ring_corners": ((2, 24, 2, 2), (48, 6, 2, 2), 1, (0, 0), 4),
    # hi·hi summed in pieces (ops.dpconv.CHAIN): input channels 128,
    # 128, 64 and output channels 128, 128, 4; per group 192, 8 and 192,
    # 192, 16; the batch 2, 2, 1 for grad-weight
    "pieces_wide": ((2, 320, 7, 8), (260, 320, 3, 3), 1, (1, 1), 1),
    "pieces_grouped": ((2, 400, 2, 9), (800, 200, 2, 3), 1, (0, 0), 2),
    "pieces_batch": ((5, 4, 26, 26), (6, 4, 3, 3), 1, (0, 0), 1),
}


def _report(**errors):
    name = os.environ.get("PYTEST_CURRENT_TEST", "").split()[0]
    print(f"[high] {name}: " + " ".join(f"{k}={v:.3e}"
                                       for k, v in errors.items()))


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _j_conv(a, b, stride, padding, groups):
    return jax.lax.conv_general_dilated(
        a, b, (stride, stride), [(padding[0],) * 2, (padding[1],) * 2],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=groups, preferred_element_type=jnp.float32)


def _j_bf16x3(xh, xl, wh, wl, stride, padding, groups):
    """The JAX oracle: three convs of the split operands, fp32 results,
    summed as the JAX package's fused kernels sum their products."""
    conv = functools.partial(_j_conv, stride=stride, padding=padding,
                             groups=groups)
    return conv(xh, wh) + (conv(xh, wl) + conv(xl, wh))


def _inputs(case, seed):
    xs, ws, stride, padding, groups = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) / np.sqrt(np.prod(ws[1:]))).astype(
        np.float32)
    return x, w, stride, padding, groups


def _split_values(rng) -> np.ndarray:
    """fp32 values for the split: random bit patterns of every finite
    binade, plus the edges by hand."""
    bits = rng.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(np.uint32)
    x = bits.view(np.float32)
    x = x[np.isfinite(x)]
    edges = np.array([
        0.0, -0.0,
        1e-45, -1e-45, 1e-40, -3e-39, 2.0 ** -126, -(2.0 ** -126) * 1.5,
        2.0 ** -120 * (1 + 2.0 ** -10),          # lo a subnormal
        2.0 ** -133, 2.0 ** -134, 3 * 2.0 ** -135,
        np.nextafter(np.float32(2.0), np.float32(0)),  # rounds up to 2
        -np.nextafter(np.float32(1.0), np.float32(0)),
        1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8,        # ties to even, down and up
        1 + 2.0 ** -8 + 2.0 ** -23,
        np.finfo(np.float32).max, -np.finfo(np.float32).max,  # past bf16
        3.3895314e38, 65504.0, 1.0, -1.0, 0.1, np.pi,
    ], np.float32)
    return np.concatenate([edges, x, -x])


def test_split_is_the_jax_split_bit_for_bit():
    x = _split_values(np.random.default_rng(0))
    hi, lo = split_bf16(torch.from_numpy(x))
    j_hi, j_lo = (np.asarray(v.astype(jnp.float32))
                  for v in _split_bf16(jnp.asarray(x)))
    assert hi.dtype == lo.dtype == torch.float32
    np.testing.assert_array_equal(hi.numpy().view(np.uint32),
                                  j_hi.view(np.uint32))
    # XLA's CPU backend computes x - hi with subnormals flushed to zero,
    # inputs and result (as the TPU does); torch keeps them, on the CPU
    # and on the card. The lo halves differ there and only there: where
    # x or x - hi is subnormal, by at most 2^-126
    got, want = lo.numpy(), j_lo
    differ = got.view(np.uint32) != want.view(np.uint32)
    tiny = 2.0 ** -126
    residual = x.astype(np.float64) - hi.numpy().astype(np.float64)
    _report(flushed=float(differ.sum()))
    assert ((np.abs(x) < tiny) | (np.abs(residual) < tiny))[differ].all()
    assert (np.abs(got[differ] - want[differ]) <= tiny).all()
    assert differ.sum() < 0.05 * x.size
    # both halves hold bf16 values, and hi + lo is x to 2^-16 relative
    # wherever hi is finite and x is normal
    for v in (hi, lo):
        assert torch.equal(v, v.to(torch.bfloat16).float())
    ok = torch.isfinite(hi) & (torch.from_numpy(np.abs(x)) >= 2.0 ** -100)
    xt = torch.from_numpy(x)[ok].double()
    err = ((hi[ok].double() + lo[ok].double()) - xt).abs() / xt.abs()
    _report(max_rel_residual=err.max().item())
    assert err.max().item() <= 2.0 ** -16


@pytest.mark.parametrize("case", list(CASES))
def test_three_pass_conv_matches_the_jax_oracle(case):
    x, w, stride, padding, groups = _inputs(case, seed=len(case))
    want = _j_bf16x3(*_split_bf16(jnp.asarray(x)), *_split_bf16(
        jnp.asarray(w)), stride, padding, groups)
    got = conv_bf16x3(torch.from_numpy(x), torch.from_numpy(w), stride,
                      padding, groups)
    full = F.conv2d(torch.from_numpy(x).double(), torch.from_numpy(w).double(),
                    None, stride, padding, 1, groups)
    errs = {"vs_jax_oracle": _rel_l2(got, want),
            "vs_float64_product": _rel_l2(got, full)}
    _report(**errs)
    assert got.shape == want.shape
    assert errs["vs_jax_oracle"] <= REL_L2


@pytest.mark.parametrize("case", list(CASES))
def test_three_pass_gradients_match_the_jax_vjp(case):
    x, w, stride, padding, groups = _inputs(case, seed=len(case) + 1)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    y_shape = conv_bf16x3(xt, wt, stride, padding, groups).shape
    g = np.random.default_rng(len(case)).standard_normal(y_shape).astype(
        np.float32)
    gx, gw = conv_bf16x3_backward(torch.from_numpy(g), xt, wt, stride,
                                  padding, groups)

    def f32(v):
        return v.astype(jnp.float32)

    splits = [f32(v) for a in (x, w) for v in _split_bf16(jnp.asarray(a))]
    _, vjp = jax.vjp(functools.partial(_j_bf16x3, stride=stride,
                                       padding=padding, groups=groups),
                     *splits)
    g_hi, g_lo = (f32(v) for v in _split_bf16(jnp.asarray(g)))
    # the oracle is linear in each of (x_hi, x_lo, w_hi, w_lo), so the
    # three-pass products of the cotangent are the hi cotangent's
    # x_hi / w_hi parts plus the lo cotangent's x_lo / w_lo parts
    by_hi, by_lo = vjp(g_hi), vjp(g_lo)
    want_gx, want_gw = by_hi[0] + by_lo[1], by_hi[2] + by_lo[3]
    errs = {"grad_input": _rel_l2(gx, want_gx),
            "grad_weight": _rel_l2(gw, want_gw)}
    _report(**errs)
    assert max(errs.values()) <= REL_L2
    # a mask leaves out what was not asked for
    masked = {need: conv_bf16x3_backward(torch.from_numpy(g), xt, wt,
                                         stride, padding, groups, need=need)
              for need in ((True, False), (False, True), (False, False))}
    assert masked[(True, False)][1] is None
    assert torch.equal(masked[(True, False)][0], gx)
    assert masked[(False, True)][0] is None
    assert torch.equal(masked[(False, True)][1], gw)
    assert masked[(False, False)] == (None, None)


@pytest.mark.parametrize("case,pieces", [
    ("reflect3x3", [6]), ("stem7x7", [5]), ("pieces_wide", [128, 128, 64]),
    ("pieces_grouped", [192, 8])])
def test_hi_hi_is_summed_in_pieces(case, pieces, monkeypatch):
    """The forward's hi·hi product takes one conv per slice of each
    group's input channels, of at most CHAIN products (32 channels at
    least), and the two lo products one conv each."""
    x, w, stride, padding, groups = _inputs(case, seed=5)
    calls = []
    conv = F.conv2d

    def counted(*args, **kwargs):
        calls.append(args[1].shape)
        return conv(*args, **kwargs)

    monkeypatch.setattr(dpconv.F, "conv2d", counted)
    conv_bf16x3(torch.from_numpy(x), torch.from_numpy(w), stride, padding,
                groups)
    assert [s[1] for s in calls] == pieces + [w.shape[1]] * 2
    taps = w.shape[2] * w.shape[3]
    assert all(s[1] * taps <= max(dpconv.CHAIN, 32 * taps)
               for s in calls[:-2])


@pytest.mark.parametrize("case", ["reflect_band", "down_s2", "ring_rows"])
def test_high_on_a_cpu_tensor_is_the_fp32_conv(case):
    x, w, stride, padding, groups = _inputs(case, seed=3)
    b = np.random.default_rng(4).standard_normal(w.shape[0]).astype(
        np.float32)

    def run(high):
        xs = torch.from_numpy(x).permute(0, 2, 3, 1).requires_grad_()
        ws = torch.from_numpy(w).requires_grad_()
        bs = torch.from_numpy(b).requires_grad_()
        if high:
            y = conv2d(xs, ws, bs, stride, padding, precision="high",
                       groups=groups)
        else:
            y = F.conv2d(xs.permute(0, 3, 1, 2), ws, bs, stride, padding, 1,
                         groups).permute(0, 2, 3, 1)
        torch.sin(y).sum().backward()
        return [t.detach().numpy() for t in (y, xs.grad, ws.grad, bs.grad)]

    for got, want in zip(run(True), run(False)):
        np.testing.assert_array_equal(got, want)
