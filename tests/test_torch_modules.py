"""The port's modules against the JAX package's flax modules (CPU, f32).

Weights are made by flax and carried into the port with
`compat.flax_params`; inputs come from numpy with fixed seeds. The
tolerance is 1e-4 max abs: fp32 convolutions summed in another order
through several layers of instance norm.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wacv23_tsnet_tpu.configs import toy_config as j_toy_config
from wacv23_tsnet_tpu.models import TSNetModules as JTSNetModules
from wacv23_tsnet_tpu.nn import Decoder as JDecoder
from wacv23_tsnet_tpu.nn import Encoder as JEncoder
from wacv23_tsnet_tpu.nn import FuseNet as JFuseNet
from wacv23_tsnet_tpu.nn.blocks import ResnetBlock as JResnetBlock
from wacv23_tsnet_tpu.nn.decoder import decoder_apply_fast
from wacv23_tsnet_tpu.nn.fusenet import fuse_clip as j_fuse_clip
from wacv23_tsnet_tpu_torch.compat import export_flax_params, load_flax_params
from wacv23_tsnet_tpu_torch.configs import toy_config
from wacv23_tsnet_tpu_torch.models import TSNetModules
from wacv23_tsnet_tpu_torch.nn import (Decoder, Encoder, FuseNet, ResnetBlock,
                                       fuse_clip)

torch.set_num_threads(2)
ATOL = 1e-4


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _port(module, params):
    load_flax_params(module, _np_tree(params))
    return module


def _check(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    # the measured error, shown by `pytest -s`
    print(f"[parity] {os.environ.get('PYTEST_CURRENT_TEST', '').split()[0]}: "
          f"max_abs_err={np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("in_ch,n_blocks", [(5, 2), (2, 0)],
                         ids=["img_enc", "lbl_enc"])
def test_encoder(in_ch, n_blocks):
    x = np.random.default_rng(0).standard_normal((2, 32, 32, in_ch)).astype(
        np.float32)
    jenc = JEncoder(ngf=8, n_downsampling=2, n_blocks=n_blocks, addcoords=True)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    enc = _port(Encoder(in_ch, ngf=8, n_downsampling=2, n_blocks=n_blocks,
                        addcoords=True), params)
    _check(enc(torch.from_numpy(x)),
           jenc.apply({"params": params}, jnp.asarray(x)))


def test_resnet_block():
    x = np.random.default_rng(1).standard_normal((2, 8, 8, 16)).astype(
        np.float32)
    jblk = JResnetBlock(16)
    params = jblk.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    blk = _port(ResnetBlock(16), params)
    _check(blk(torch.from_numpy(x)),
           jblk.apply({"params": params}, jnp.asarray(x)))


def _fuse_setup(seed, s=3, f=5, hw=8, c=16):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((s, hw, hw, c)).astype(np.float32)
    tar = rng.standard_normal((f, hw, hw, c)).astype(np.float32)
    jnet = JFuseNet(ngf=2 * c, n_blocks=1)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.asarray(src[:1]),
                       jnp.asarray(src[:1]))["params"]
    return src, tar, jnet, params, _port(FuseNet(ngf=2 * c), params)


def test_fusenet():
    src, tar, jnet, params, net = _fuse_setup(2, f=3)
    _check(net(torch.from_numpy(src), torch.from_numpy(tar)),
           jnet.apply({"params": params}, jnp.asarray(src),
                      jnp.asarray(tar)))


def test_fuse_clip():
    """Split form with K2 (plain on the CPU) against the JAX split form
    with its Pallas instance_norm_mean (interpret mode)."""
    src, tar, _, params, net = _fuse_setup(3)
    _check(fuse_clip(net, torch.from_numpy(src), torch.from_numpy(tar)),
           j_fuse_clip(params, jnp.asarray(src), jnp.asarray(tar),
                       use_pallas=True))


def test_decoder_plain_form_matches_decoder_apply_fast():
    """The port's plain decoder against the JAX clip path's
    phase-decomposed rewrite of the same math."""
    rng = np.random.default_rng(4)
    prop = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    syn = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    jdec = JDecoder(output_nc=3, ngf=8, n_downsampling=2, n_blocks=1)
    params = jdec.init(jax.random.PRNGKey(4), jnp.asarray(prop),
                       jnp.asarray(syn))["params"]
    dec = _port(Decoder(output_nc=3, ngf=8, n_downsampling=2, n_blocks=1),
                params)
    want, _ = decoder_apply_fast(jdec, params, jnp.asarray(prop),
                                 jnp.asarray(syn), return_fea=False)
    _check(dec(torch.from_numpy(prop), torch.from_numpy(syn)), want)


def test_weight_round_trip_is_exact():
    params = _np_tree(JTSNetModules(j_toy_config()).init_generator_params(
        jax.random.PRNGKey(5)))
    mods = TSNetModules(toy_config(), device="cpu", seed=1)
    load_flax_params(mods, params)
    back = export_flax_params(mods)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert np.array_equal(flat_b[path], leaf), path
    again = TSNetModules(toy_config(), device="cpu", seed=2)
    load_flax_params(again, back)
    for (ka, va), (kb, vb) in zip(mods.state_dict().items(),
                                  again.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_seeded_init_is_reproducible_and_shaped_like_flax():
    a = TSNetModules(toy_config(), device="cpu", seed=3)
    b = TSNetModules(toy_config(), device="cpu", seed=3)
    for va, vb in zip(a.state_dict().values(), b.state_dict().values()):
        assert torch.equal(va, vb)
    ours = jax.tree_util.tree_map(np.shape, export_flax_params(a))
    flax = jax.tree_util.tree_map(np.shape, _np_tree(
        JTSNetModules(j_toy_config()).init_generator_params(
            jax.random.PRNGKey(0))))
    assert ours == flax
    w = a.img_enc.block0.conv1.weight
    assert abs(float(w.std()) - 0.02) < 2e-3
    assert float(a.dec.map_conv.bias.abs().max()) == 0.0
