"""The bench-tier clip with the fused tail against the JAX package (CPU).

"Fused tail": FuseNet's per-pair block through K6 (`TSNET_FUSE_PAIR_KERNEL=1`,
the JAX package's opt-in) and the decoder's ResNet blocks through K7
(`fused_blocks=True`, the port's counterpart of the JAX package's
`decoder_apply_fast(use_pallas_blocks=True)`). Weights are made by flax and
carried into the port with `compat.flax_params`; inputs come from numpy.
The JAX package reads the variable at trace time, so each test sets it
before it calls or traces a JAX function, and traces afresh.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wacv23_tsnet_tpu.configs import toy_config as j_toy_config
from wacv23_tsnet_tpu.models import TSNetModules as JTSNetModules
from wacv23_tsnet_tpu.models import tsnet_forward_clip as j_forward_clip
from wacv23_tsnet_tpu.nn import Decoder as JDecoder
from wacv23_tsnet_tpu.nn import FuseNet as JFuseNet
from wacv23_tsnet_tpu.nn import decoder as j_decoder
from wacv23_tsnet_tpu.nn.fusenet import fuse_clip as j_fuse_clip
from wacv23_tsnet_tpu.ops import pallas_conv as j_pallas_conv
from wacv23_tsnet_tpu.ops import pallas_fuse as j_pallas_fuse
from wacv23_tsnet_tpu_torch.compat import load_flax_params
from wacv23_tsnet_tpu_torch.configs import toy_config
from wacv23_tsnet_tpu_torch.models import TSNetModules, tsnet_forward_clip
from wacv23_tsnet_tpu_torch.nn import Decoder, FuseNet, ResnetBlock, fuse_clip
from wacv23_tsnet_tpu_torch.nn import decoder as decoder_mod
from wacv23_tsnet_tpu_torch.nn import fusenet as fusenet_mod
from wacv23_tsnet_tpu_torch.ops.conv_kernels import resblock_fused

torch.set_num_threads(2)
FUSE_ENV = "TSNET_FUSE_PAIR_KERNEL"


def _report(**errors):
    """The measured errors, shown by `pytest -s`."""
    name = os.environ.get("PYTEST_CURRENT_TEST", "").split()[0]
    print(f"[parity] {name}: " + " ".join(
        f"{k}={v:.3e}" for k, v in errors.items()))


def _spy(monkeypatch, module, name):
    """Count the calls of `module.name`, which still runs."""
    calls = []
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("env", ["1", None], ids=["kernel_on", "kernel_off"])
def test_fuse_clip_pair_kernel_matches_jax(monkeypatch, env):
    """bf16 FuseNet, precision "default", the shapes of
    tests/test_pallas_fuse.py:56 (s=2, f=3, 8x8, C=64): the port against
    the JAX `fuse_clip` under the same variable, at that test's 5e-2. With
    the variable set both take the K6 branch; unset, neither does."""
    if env is None:
        monkeypatch.delenv(FUSE_ENV, raising=False)
    else:
        monkeypatch.setenv(FUSE_ENV, env)
    rng = np.random.default_rng(0)
    s, f, hw, c = 2, 3, 8, 64
    src = rng.standard_normal((s, hw, hw, c)).astype(np.float32)
    tar = rng.standard_normal((f, hw, hw, c)).astype(np.float32)
    jnet = JFuseNet(ngf=2 * c, n_blocks=1, dtype=jnp.bfloat16,
                    precision="default")
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(src),
                       jnp.asarray(np.broadcast_to(tar[:1], src.shape))
                       )["params"]
    want = j_fuse_clip(params, jnp.asarray(src), jnp.asarray(tar),
                       dtype=jnp.bfloat16, precision="default",
                       use_pallas=True)
    net = FuseNet(ngf=2 * c, dtype=torch.bfloat16, precision="default")
    load_flax_params(net, _np_tree(params))
    calls = _spy(monkeypatch, fusenet_mod, "fuse_pair_conv2")
    with torch.inference_mode():
        got = fuse_clip(net, torch.from_numpy(src), torch.from_numpy(tar))
    assert len(calls) == (1 if env == "1" else 0)
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    _report(max_abs_err=err.max())
    assert err.max() <= 5e-2


def _decoder_setup(seed=42):
    """The bf16 decoder of tests/test_upconv.py:68 (ngf 8, 3 upsamplings,
    2 blocks) with flax weights, in both packages."""
    jdec = JDecoder(output_nc=3, ngf=8, n_downsampling=3, n_blocks=2,
                    dtype=jnp.bfloat16, precision="default")
    rng = np.random.default_rng(seed)
    prop = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    syn = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    params = jdec.init(jax.random.PRNGKey(1), jnp.asarray(prop),
                       jnp.asarray(syn))["params"]
    dec = Decoder(output_nc=3, ngf=8, n_downsampling=3, n_blocks=2,
                  dtype=torch.bfloat16, precision="default")
    load_flax_params(dec, _np_tree(params))
    return jdec, params, dec, prop, syn


def test_fused_decoder_matches_jax_pallas_blocks(monkeypatch):
    """Decoder(fused_blocks=True) against `decoder_apply_fast(
    use_pallas_blocks=True)` (K7 in interpret mode), bf16, at the 6e-2 of
    tests/test_upconv.py:78."""
    jdec, params, dec, prop, syn = _decoder_setup()
    want, _ = jax.jit(lambda p, a, b: j_decoder.decoder_apply_fast(
        jdec, p, a, b, return_fea=False, use_pallas_blocks=True))(
            params, jnp.asarray(prop), jnp.asarray(syn))
    calls = _spy(monkeypatch, decoder_mod, "resblock_fused")
    with torch.inference_mode():
        got = dec(torch.from_numpy(prop), torch.from_numpy(syn),
                  fused_blocks=True)
    assert len(calls) == 2
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    _report(max_abs_err=err.max())
    assert err.max() <= 6e-2


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_blocks_drop_biases_that_cancel(dtype):
    """Non-zero conv biases: the fused block, which does not take them,
    equals the plain block, which adds them before each instance norm. In
    f32 one ResnetBlock at 1e-4 (tests/test_pallas_conv.py:50); in bf16 the
    whole fused decoder against the unfused one at 6e-2 (the bf16 tier's
    bound, tests/test_upconv.py:78)."""
    gen = torch.Generator().manual_seed(7)
    if dtype == "f32":
        blk = ResnetBlock(32)
        for conv in (blk.conv1, blk.conv2):
            conv.reset_parameters(gen)
            conv.bias.data.normal_(0.0, 1.0, generator=gen)
        x = torch.randn(3, 8, 8, 32, generator=gen)
        with torch.inference_mode():
            err = (resblock_fused(x, blk.conv1.weight, blk.conv2.weight)
                   - blk(x)).abs().max().item()
        tol = 1e-4
    else:
        _, _, dec, prop, syn = _decoder_setup(seed=43)
        for j in range(2):
            for conv in (dec.get_submodule(f"block{j}.conv1"),
                         dec.get_submodule(f"block{j}.conv2")):
                conv.bias.data.normal_(0.0, 0.1, generator=gen)
        with torch.inference_mode():
            args = (torch.from_numpy(prop), torch.from_numpy(syn))
            err = (dec(*args, fused_blocks=True).float()
                   - dec(*args).float()).abs().max().item()
        tol = 6e-2
    _report(max_abs_err=err)
    assert err <= tol


def test_toy_clip_with_fused_tail_matches_jax(monkeypatch):
    """toy_config() at precision "high" + fast_tail, both opt-ins on: the
    port's `tsnet_forward_clip` against the JAX package's clip forward with
    the variable set and `decode_with_sources`'s decoder call taking
    `use_pallas_blocks=True` (K6 and K7 in interpret mode), within the
    0.01 mean-L1 budget of the fast tiers (QUIRKS.md)."""
    monkeypatch.setenv(FUSE_ENV, "1")
    jcfg = dataclasses.replace(j_toy_config(), precision="high",
                               fast_tail=True)
    jmods = JTSNetModules(jcfg)
    params = jmods.init_generator_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    s, hw, nl, f = jcfg.n_source, jcfg.image_size, jcfg.label_nc, 7
    inputs = (rng.random((s, hw, hw, 3)).astype(np.float32),
              rng.integers(0, 2, (s, hw, hw, nl)).astype(np.float32),
              rng.integers(0, 2, (s, hw, hw)).astype(np.float32),
              rng.integers(0, 2, (f, hw, hw, nl)).astype(np.float32),
              rng.integers(0, 2, (f, hw, hw)).astype(np.float32))
    # the JAX functions import their kernels at call time: counted at trace
    jax_pair = _spy(monkeypatch, j_pallas_fuse, "fuse_pair_conv2")
    jax_blocks = _spy(monkeypatch, j_pallas_conv, "resblock_fused")
    apply_fast = j_decoder.decoder_apply_fast

    def fused_apply_fast(*args, **kwargs):
        kwargs["use_pallas_blocks"] = True
        return apply_fast(*args, **kwargs)

    monkeypatch.setattr(j_decoder, "decoder_apply_fast", fused_apply_fast)
    want = np.asarray(jax.jit(
        lambda p, *a: j_forward_clip(jmods, p, *a, use_pallas=True))(
            params, *map(jnp.asarray, inputs)))
    assert len(jax_pair) == 1 and len(jax_blocks) == jcfg.dec_n_blocks

    mods = TSNetModules(dataclasses.replace(toy_config(), precision="high",
                                            fast_tail=True), device="cpu")
    load_flax_params(mods, _np_tree(params))
    pair_calls = _spy(monkeypatch, fusenet_mod, "fuse_pair_conv2")
    block_calls = _spy(monkeypatch, decoder_mod, "resblock_fused")
    got = tsnet_forward_clip(mods, *inputs, device="cpu",
                             fused_blocks=True).numpy()
    assert len(pair_calls) == 1
    assert len(block_calls) == toy_config().dec_n_blocks
    assert got.shape == want.shape
    err = np.abs(got - want)
    _report(mean_abs_err=err.mean(), max_abs_err=err.max())
    assert err.mean() <= 0.01
