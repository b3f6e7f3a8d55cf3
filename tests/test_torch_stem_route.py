"""The encoders' stem route (`nn.encoder.Encoder.forward`) on the CPU.

- The folded stem (`nn.encoder.folded_stem`, which `Encoder.forward`
  takes under `precision="high"` on the card) against the module's
  reflect-padded 7x7 stem, conv + instance norm + ReLU, in fp32: the
  forward and the conv's grad-weight within 1e-6 relative L2, at the
  toy, face and pose stems' input channels (Ci 5, 8 and 28).
- The route table (`folds_stem`): only "high" on an fp32 CUDA tensor
  folds; "highest", "default", the bf16 tier and every CPU tensor keep
  the 7x7; `Encoder.forward` follows the table and gives each route's
  composition bit for bit.
- "high" on a CPU tensor stays the fp32 conv: the encoder at "high"
  bit-equal to the encoder at "highest" (the conv alone:
  tests/test_torch_high_precision.py).
- The folded kernel, kept per weight, follows an in-place change of it.

`pytest -s` prints each measured error. On the card the folded route is
held against a float64 oracle of the bf16x3 products in
tests/test_torch_cuda.py and chip_smoke.py `--high`.
"""

import os

import pytest
import torch

from wacv23_tsnet_tpu_torch.nn import encoder as enc_mod
from wacv23_tsnet_tpu_torch.nn.blocks import reflect_conv
from wacv23_tsnet_tpu_torch.nn.encoder import Encoder, folded_stem, folds_stem
from wacv23_tsnet_tpu_torch.ops.coords import coord_channels
from wacv23_tsnet_tpu_torch.ops.norms import instance_norm

torch.set_num_threads(2)
REL_L2 = 1e-6


def _rel_l2(got, want) -> float:
    got, want = got.detach().double(), want.detach().double()
    rel = ((got - want).norm() / want.norm()).item()
    name = os.environ.get("PYTEST_CURRENT_TEST", "").split()[0]
    print(f"[stem_route] {name}: rel_l2={rel:.3e}")
    return rel


def _encoder(in_ch, precision="highest", dtype=torch.float32, seed=0,
             **kw):
    enc = Encoder(in_ch, ngf=16, n_downsampling=kw.pop("n_downsampling", 0),
                  n_blocks=kw.pop("n_blocks", 0), addcoords=True,
                  dtype=dtype, precision=precision, **kw)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in enc.parameters():    # nonzero biases: the norm cancels them
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return enc


def _plain_stem(c, x):
    return torch.relu(instance_norm(reflect_conv(
        x, c.weight, c.bias, 3, c.precision, c.dtype, c.bwd_precision)))


# the stems' input channels with CoordConv: toy and face label encoder
# (label_nc 2 + 3), face image encoder (3 + 2 + 3), pose label encoder
# (25 + 3)
@pytest.mark.parametrize("ci", [5, 8, 28])
def test_folded_stem_is_the_module_stem(ci):
    """Forward and the stem conv's grad-weight of the folded route
    against the module's 7x7 stem, fp32, within 1e-6 relative L2."""
    enc = _encoder(ci - 3)
    c = enc.conv_in
    x = coord_channels(torch.randn(2, 32, 32, ci - 3,
                                   generator=torch.Generator().manual_seed(ci)))
    g = torch.randn(2, 32, 32, 16, generator=torch.Generator().manual_seed(1))
    outs, grads = [], []
    for stem in (folded_stem, _plain_stem):
        y = stem(c, x)
        gw, = torch.autograd.grad(y, c.weight, g)
        outs.append(y)
        grads.append(gw)
    assert outs[0].shape == outs[1].shape == (2, 32, 32, 16)
    assert _rel_l2(outs[0], outs[1]) <= REL_L2
    assert _rel_l2(grads[0], grads[1]) <= REL_L2


@pytest.mark.parametrize("precision,dtype,device,folds", [
    ("high", torch.float32, "cuda", True),
    ("high", torch.float32, "cpu", False),
    ("high", torch.bfloat16, "cuda", False),
    ("highest", torch.float32, "cuda", False),
    ("highest", torch.float32, "cpu", False),
    ("default", torch.float32, "cuda", False),
    ("default", torch.bfloat16, "cuda", False),
])
def test_stem_route_table(precision, dtype, device, folds):
    """Only bf16x3 ("high" on an fp32 tensor on the card) folds the stem:
    the bit-parity tier ("highest"), `fast_trunk` ("default"), the bf16
    tier and the CPU keep the reflect-padded 7x7."""
    assert folds_stem(precision, dtype, device) is folds


@pytest.mark.parametrize("folds", [True, False])
def test_encoder_forward_follows_the_route(monkeypatch, folds):
    """`Encoder.forward` runs the route `folds_stem` names, then its own
    layers: bit for bit the folded stem or the 7x7 composition, then the
    stride-2 convs and the blocks."""
    enc = _encoder(2, n_downsampling=1, n_blocks=1)
    x = torch.randn(2, 16, 16, 2, generator=torch.Generator().manual_seed(3))
    asked = []

    def route(precision, dtype, device_type):
        asked.append((precision, dtype, device_type))
        return folds

    monkeypatch.setattr(enc_mod, "folds_stem", route)
    with torch.no_grad():
        got = enc(x)
        stem = folded_stem if folds else _plain_stem
        want = enc.trunk(stem(enc.conv_in, coord_channels(x)))
    assert asked == [("highest", torch.float32, "cpu")]
    assert torch.equal(got, want)


@pytest.mark.parametrize("ring_pad", [False, True])
def test_cpu_high_encoder_is_the_fp32_encoder(ring_pad):
    """On a CPU tensor "high" stays the fp32 conv: the whole encoder at
    "high" bit-equal to the same weights at "highest", forward and every
    gradient."""
    x = torch.randn(2, 16, 16, 2, generator=torch.Generator().manual_seed(4))
    runs = []
    for precision in ("high", "highest"):
        enc = _encoder(2, precision, n_downsampling=1, n_blocks=1,
                       ring_pad=ring_pad)
        y = enc(x)
        y.square().sum().backward()
        runs.append([y] + [p.grad for p in enc.parameters()])
    for got, want in zip(*runs):
        assert torch.equal(got, want)


def test_folded_stem_follows_in_place_weight_changes():
    """The folded kernel is kept while the stem's weight lives unchanged:
    after an in-place change (an optimizer step, `load_state_dict`) the
    folded stem is again the module's stem of the new weight."""
    enc = _encoder(2)
    c = enc.conv_in
    x = coord_channels(torch.randn(2, 16, 16, 2,
                                   generator=torch.Generator().manual_seed(5)))
    with torch.no_grad():
        first = folded_stem(c, x)
        assert torch.equal(folded_stem(c, x), first)
        c.weight.mul_(-0.5)
        again = folded_stem(c, x)
        assert _rel_l2(again, _plain_stem(c, x)) <= REL_L2
        assert _rel_l2(again, first) > 0.1


def test_encoder_keeps_the_7x7_where_the_fold_does_not_divide(monkeypatch):
    """Where the route would fold but H or W is not divisible by the fold,
    `Encoder.forward` keeps the 7x7 stem (the folded conv raises)."""
    from wacv23_tsnet_tpu_torch.ops.stemconv import stem_conv7_fold4
    enc = _encoder(2)
    x = torch.randn(2, 18, 16, 2, generator=torch.Generator().manual_seed(6))
    monkeypatch.setattr(enc_mod, "folds_stem", lambda *a: True)
    with torch.no_grad():
        assert torch.equal(enc(x), _plain_stem(enc.conv_in,
                                               coord_channels(x)))
        with pytest.raises(ValueError, match="divisible"):
            stem_conv7_fold4(coord_channels(x), enc.conv_in.weight,
                             enc.conv_in.bias)
