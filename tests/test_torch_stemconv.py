"""The port's folded stem (`ops/stemconv.py`) and
`nn.encoder.encoder_apply_fast` against the JAX package's (CPU).

The five cases of tests/test_stemconv.py with its tolerances, on the
same seeded numpy inputs and flax weights (`compat.flax_params`) through
both packages: the space-to-depth round trip, the folded kernel (a
scatter, and bit-equal to the JAX one), the stem conv (atol 2e-5 / rtol
1e-5, also against the port's own padded 7x7 conv), `encoder_apply_fast`
in f32 (2e-5) and bf16 (3e-2) against the JAX function and the port's
`Encoder`, and the label encoder at the shipped 256² shape. `pytest -s`
prints each measured error.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wacv23_tsnet_tpu.nn.encoder import Encoder as JEncoder
from wacv23_tsnet_tpu.nn.encoder import encoder_apply_fast as j_encoder_fast
from wacv23_tsnet_tpu.ops import stemconv as jstem
from wacv23_tsnet_tpu_torch.compat import load_flax_params
from wacv23_tsnet_tpu_torch.nn import Encoder, encoder_apply_fast
from wacv23_tsnet_tpu_torch.nn.blocks import conv2d, reflect_pad
from wacv23_tsnet_tpu_torch.ops import stemconv
from wacv23_tsnet_tpu_torch.ops.norms import l2_normalize

torch.set_num_threads(2)
RNG = np.random.default_rng(0)


def _close(got, want, atol, rtol=0.0, what="max_abs_err"):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    name = os.environ.get("PYTEST_CURRENT_TEST", "").split()[0]
    print(f"[stemconv] {name}: {what}={np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _oihw(k: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(k).permute(3, 2, 0, 1).contiguous()


def test_space_depth_roundtrip():
    x = RNG.standard_normal((2, 16, 16, 3)).astype(np.float32)
    folded = stemconv.space_to_depth(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(
        folded.numpy(), np.asarray(jstem.space_to_depth(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(
        stemconv.depth_to_space(folded, 4).numpy(), x)


def test_fold_kernel_is_a_scatter():
    """Every original tap value appears, 16 times; no arithmetic is done
    on them; the kernel is the JAX package's, transposed to OIHW."""
    k = RNG.standard_normal((7, 7, 2, 3)).astype(np.float32)
    kf = stemconv.fold_kernel(_oihw(k), 4).numpy()
    np.testing.assert_array_equal(
        kf.transpose(2, 3, 1, 0), np.asarray(jstem.fold_kernel(
            jnp.asarray(k), 4)))
    vals = np.sort(np.abs(kf[np.abs(kf) > 0]))
    want = np.sort(np.abs(k).ravel())
    assert vals.size == want.size * 16
    np.testing.assert_array_equal(vals.reshape(-1, 16)[:, 0], want)


@pytest.mark.parametrize("hw,ci", [(32, 5), (64, 28)])
def test_stem_conv7_fold4_exact(hw, ci):
    x = RNG.standard_normal((2, hw, hw, ci)).astype(np.float32)
    k = (RNG.standard_normal((7, 7, ci, 16)) * 0.1).astype(np.float32)
    b = RNG.standard_normal((16,)).astype(np.float32)
    got = stemconv.stem_conv7_fold4(torch.from_numpy(x), _oihw(k),
                                    torch.from_numpy(b))
    want = jstem.stem_conv7_fold4(jnp.asarray(x), jnp.asarray(k),
                                  jnp.asarray(b), precision="highest")
    _close(got, want, 2e-5, 1e-5)
    direct = conv2d(reflect_pad(torch.from_numpy(x), 3), _oihw(k),
                    torch.from_numpy(b))
    _close(stemconv.depth_to_space(got, 4), direct.numpy(), 2e-5, 1e-5,
           what="vs_direct")


def _encoders(ngf, n_down, n_blocks, in_ch, dtype, hw, seed):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    prec = "default" if dtype == "bfloat16" else "highest"
    jenc = JEncoder(ngf=ngf, n_downsampling=n_down, n_blocks=n_blocks,
                    addcoords=True, normalization=True, dtype=jdt,
                    precision=prec)
    x = RNG.standard_normal((2 if hw <= 64 else 1, hw, hw, in_ch)).astype(
        np.float32)
    params = jenc.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    enc = Encoder(in_ch, ngf=ngf, n_downsampling=n_down, n_blocks=n_blocks,
                  addcoords=True, dtype=torch.bfloat16 if dtype == "bfloat16"
                  else torch.float32, precision=prec)
    load_flax_params(enc, jax.tree.map(np.asarray, params))
    return jenc, params, enc, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_apply_fast_matches_jax(dtype):
    """The JAX encoder normalises its output (`normalization=True`); the
    port's applies `l2_normalize` after, as its callers do."""
    jenc, params, enc, x = _encoders(8, 2, 1, 2, dtype, 32, 0)
    want = j_encoder_fast(jenc, params, jnp.asarray(x))
    with torch.no_grad():
        got = l2_normalize(encoder_apply_fast(enc, torch.from_numpy(x))
                           .float())
        plain = l2_normalize(enc(torch.from_numpy(x)).float())
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    _close(got, want, tol)
    _close(got, plain.numpy(), tol, what="vs_module")


def test_encoder_apply_fast_shipped_shape():
    """lbl_enc at the shipped 256² config shape (thin widths)."""
    jenc, params, enc, x = _encoders(4, 3, 0, 2, "float32", 256, 1)
    want = j_encoder_fast(jenc, params, jnp.asarray(x))
    with torch.no_grad():
        got = l2_normalize(encoder_apply_fast(enc, torch.from_numpy(x)))
    _close(got, want, 2e-5)
