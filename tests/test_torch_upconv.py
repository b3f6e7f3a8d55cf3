"""The port's phase-decomposed decoder ops (`ops/upconv.py`) and
`nn.decoder.decoder_apply_fast` against the JAX package's (CPU).

The cases of tests/test_upconv.py with its tolerances, each on the same
seeded numpy inputs through both packages: the exact ops at atol 2e-5 /
rtol 1e-5, `upconv_in_relu` at 5e-5 / 1e-4 with `phase_out` both ways,
`decoder_apply_fast` at 1e-5 (f32) and 6e-2 (bf16, with and without
K7's blocks, whose plain version runs on the CPU), against the JAX
function with flax weights carried over by `compat.flax_params`. Then the
decoder's parameter gradients against `jax.grad` of the JAX
`decoder_apply_fast` (as tests/test_torch_train_step.py holds them, max
error over the subnet's largest gradient, 1e-3), and the port's plain
`Decoder` against its own `decoder_apply_fast`. `pytest -s` prints each
measured error.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wacv23_tsnet_tpu.nn.decoder import Decoder as JDecoder
from wacv23_tsnet_tpu.nn.decoder import decoder_apply_fast as j_decoder_fast
from wacv23_tsnet_tpu.ops import upconv as jup
from wacv23_tsnet_tpu_torch.compat import load_flax_params, state_dict_to_flax
from wacv23_tsnet_tpu_torch.nn import Decoder, decoder_apply_fast
from wacv23_tsnet_tpu_torch.ops import upconv

torch.set_num_threads(2)
RNG = np.random.default_rng(7)


def _report(**values):
    name = os.environ.get("PYTEST_CURRENT_TEST", "").split()[0]
    print(f"[upconv] {name}: " + " ".join(f"{k}={v:.3e}"
                                          for k, v in values.items()))


def _oihw(k: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(k).permute(3, 2, 0, 1).contiguous()


def _close(got, want, atol, rtol=0.0, what="max_abs_err"):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    _report(**{what: float(np.abs(got - want).max())})
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("h,w,ci,co", [(8, 8, 6, 4), (5, 9, 3, 5)])
def test_upsample2x_reflect_conv3_exact(h, w, ci, co):
    x = RNG.standard_normal((2, h, w, ci)).astype(np.float32)
    k = (RNG.standard_normal((3, 3, ci, co)) * 0.3).astype(np.float32)
    b = RNG.standard_normal((co,)).astype(np.float32)
    want = jup.upsample2x_reflect_conv3(jnp.asarray(x), jnp.asarray(k),
                                        jnp.asarray(b), precision="highest")
    got = upconv.upsample2x_reflect_conv3(torch.from_numpy(x), _oihw(k),
                                          torch.from_numpy(b))
    _close(got, want, 2e-5, 1e-5)


@pytest.mark.parametrize("phase_out", [False, True])
def test_upconv_in_relu_matches_jax(phase_out):
    h, w, ci, co = 7, 10, 5, 6
    x = RNG.standard_normal((2, h, w, ci)).astype(np.float32)
    k = (RNG.standard_normal((3, 3, ci, co)) * 0.3).astype(np.float32)
    want = jup.upconv_in_relu(jnp.asarray(x), jnp.asarray(k),
                              precision="highest", phase_out=phase_out)
    got = upconv.upconv_in_relu(torch.from_numpy(x), _oihw(k),
                                phase_out=phase_out)
    assert got.shape == want.shape
    _close(got, want, 5e-5, 1e-4)


def _decoder_pair(dtype, seed=1):
    jdt = jnp.dtype(dtype)
    prec = "highest" if dtype == "float32" else "default"
    jdec = JDecoder(output_nc=3, ngf=8, n_downsampling=3, n_blocks=2,
                    dtype=jdt, precision=prec)
    rng = np.random.default_rng(42)
    prop = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    syn = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    params = jdec.init(jax.random.PRNGKey(seed), jnp.asarray(prop),
                       jnp.asarray(syn))["params"]
    dec = Decoder(output_nc=3, ngf=8, n_downsampling=3, n_blocks=2,
                  dtype=torch.bfloat16 if dtype == "bfloat16"
                  else torch.float32, precision=prec)
    load_flax_params(dec, jax.tree.map(np.asarray, params))
    return jdec, params, dec, prop, syn


@pytest.mark.parametrize("dtype,fused", [("float32", False),
                                         ("bfloat16", False),
                                         ("bfloat16", True)],
                         ids=["f32", "bf16", "bf16-fused_blocks"])
def test_decoder_apply_fast_matches_jax(dtype, fused):
    """The port's decoder_apply_fast against the JAX one (image and
    penultimate features); with `fused_blocks` the ResNet blocks run K7's
    plain version against the JAX Pallas blocks in interpret mode."""
    jdec, params, dec, prop, syn = _decoder_pair(dtype)
    want_img, want_fea = j_decoder_fast(jdec, params, jnp.asarray(prop),
                                        jnp.asarray(syn), return_fea=True,
                                        use_pallas_blocks=fused)
    with torch.no_grad():
        got_img, got_fea = decoder_apply_fast(
            dec, torch.from_numpy(prop), torch.from_numpy(syn),
            return_fea=True, fused_blocks=fused)
    tol = 1e-5 if dtype == "float32" else 6e-2
    assert got_img.dtype == dec.dtype
    _close(got_img, want_img, tol, what="img_err")
    _close(got_fea, want_fea, tol, what="fea_err")
    with torch.no_grad():
        img, fea = decoder_apply_fast(dec, torch.from_numpy(prop),
                                      torch.from_numpy(syn),
                                      return_fea=False, fused_blocks=fused)
    assert fea is None and torch.equal(img, got_img)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_plain_module_matches_decoder_apply_fast(dtype):
    """The port's two forms of one decoder, same weights."""
    _, _, dec, prop, syn = _decoder_pair(dtype, seed=3)
    with torch.no_grad():
        fast, _ = decoder_apply_fast(dec, torch.from_numpy(prop),
                                     torch.from_numpy(syn))
        plain = dec(torch.from_numpy(prop), torch.from_numpy(syn))
    _close(fast, plain.float().numpy(),
           1e-5 if dtype == "float32" else 6e-2)


def test_decoder_apply_fast_gradients_match_jax():
    """d sum(rgb * ct) / d params through both packages' phase decoder."""
    jdec, params, dec, prop, syn = _decoder_pair("float32", seed=5)
    ct = np.random.default_rng(8).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(j_decoder_fast(
        jdec, p, jnp.asarray(prop), jnp.asarray(syn))[0] * ct))(params)
    rgb, _ = decoder_apply_fast(dec, torch.from_numpy(prop),
                                torch.from_numpy(syn), return_fea=False)
    (rgb * torch.from_numpy(ct)).sum().backward()
    got = state_dict_to_flax({
        n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in dec.named_parameters()})
    got_l = jax.tree_util.tree_leaves(got)
    want_l = jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    scale = max(float(np.abs(w).max()) for w in want_l)
    err = max(float(np.abs(g - np.asarray(w)).max())
              for g, w in zip(got_l, want_l)) / scale
    _report(grad_err_over_max=err)
    assert err <= 1e-3, err


def test_conv7x7_phase_exact():
    h, w, ci, co = 12, 14, 4, 3
    x = RNG.standard_normal((2, h, w, 4 * ci)).astype(np.float32)
    k7 = (RNG.standard_normal((7, 7, ci, co)) * 0.2).astype(np.float32)
    b = RNG.standard_normal((co,)).astype(np.float32)
    want = jup.conv7x7_phase(jnp.asarray(x), jnp.asarray(k7), jnp.asarray(b),
                             precision="highest")
    got = upconv.conv7x7_phase(torch.from_numpy(x), _oihw(k7),
                               torch.from_numpy(b))
    _close(got, want, 2e-5, 1e-5)
    # the phase identity: interleaved, the port's own padded 7x7 conv
    from wacv23_tsnet_tpu_torch.nn.blocks import conv2d, reflect_pad
    inter = upconv.depth_to_space(torch.from_numpy(x))
    direct = conv2d(reflect_pad(inter, 3), _oihw(k7), torch.from_numpy(b))
    _close(upconv.depth_to_space(got), direct.numpy(), 2e-5, 1e-5,
           what="vs_direct")
