"""The phase decoder's instance-norm route (CPU; no JAX).

`nn.decoder.decoder_apply_fast` and `ops.upconv.upconv_in_relu` send each
instance norm through K8 (`ops.norm_kernels.instance_norm_fused`) where
`ops.norm_kernels.fuses_norm` says so: a CUDA tensor, no gradient,
`use_kernels`. Here: the decision by device, dtype, grad state and
`use_kernels`, and its counts in `utils.profiling.DECODER_NORMS`; on the
CPU the decoder and the up stage give the bits of the composition they
ran before the route, in bf16 and fp32, with `use_kernels` either way;
and, with the route's device check made to read CUDA, the decoder's
eleven norms (two a block, one an up stage) through K8's plain version,
within bf16 rounding of the composition, and none of them where a
gradient flows, with `use_kernels=False`, or for a tensor-parallel block.
The other sites of the route: tests/test_torch_trunk_norm_route.py.
"""

import types

import pytest
import torch

from wacv23_tsnet_tpu_torch.nn.blocks import reflect_conv
from wacv23_tsnet_tpu_torch.nn.decoder import Decoder, decoder_apply_fast
from wacv23_tsnet_tpu_torch.ops import norm_kernels, upconv
from wacv23_tsnet_tpu_torch.ops.dpconv import conv2d
from wacv23_tsnet_tpu_torch.ops.norms import instance_norm
from wacv23_tsnet_tpu_torch.ops.upconv import conv7x7_phase, depth_to_space
from wacv23_tsnet_tpu_torch.utils.profiling import DECODER_NORMS

torch.set_num_threads(2)

BF16, F32 = torch.bfloat16, torch.float32
# the face config's decoder depth at toy widths: 4 blocks, 3 up stages
N_BLOCKS, N_UP = 4, 3
NORMS = 2 * N_BLOCKS + N_UP


@pytest.fixture(autouse=True)
def counts(monkeypatch):
    """`DECODER_NORMS` from zero for each test."""
    for k in DECODER_NORMS:
        monkeypatch.setitem(DECODER_NORMS, k, 0)
    return DECODER_NORMS


@pytest.fixture
def on_card(monkeypatch):
    """The route's device check reads CUDA for every tensor; the rest of
    the decision (dtype, grad, `use_kernels`) and the count are the
    route's own. K8 then runs its plain version, as CPU tensors do."""
    real = norm_kernels.fuses_norm

    def fuses(x, *args, **kwargs):
        return real(types.SimpleNamespace(
            device=torch.device("cuda"), dtype=x.dtype, shape=x.shape,
            requires_grad=x.requires_grad, element_size=x.element_size,
            data_ptr=x.data_ptr), *args, **kwargs)

    monkeypatch.setattr(norm_kernels, "fuses_norm", fuses)


def _stand_in(device, dtype, requires_grad):
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                 requires_grad=requires_grad)


ROUTES = {
    "card_bf16_inference": ("cuda", BF16, False, True, True, True),
    "card_bf16_grad_off": ("cuda", BF16, True, False, True, True),
    "card_bf16_no_kernels": ("cuda", BF16, False, True, False, False),
    "card_bf16_needs_grad": ("cuda", BF16, True, True, True, False),
    "card_f32": ("cuda", F32, False, True, True, True),
    "card_f32_needs_grad": ("cuda", F32, True, True, True, False),
    "cpu_bf16": ("cpu", BF16, False, True, True, False),
    "cpu_f32": ("cpu", F32, False, False, True, False),
    "meta_bf16": ("meta", BF16, False, False, True, False),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_route_by_device_dtype_and_grad(case, counts):
    device, dtype, requires_grad, grad_on, use_kernels, want = ROUTES[case]
    with torch.set_grad_enabled(grad_on):
        got = norm_kernels.fuses_norm(
            _stand_in(device, dtype, requires_grad), use_kernels, counts)
    assert got is want
    assert counts == {"fused": int(want), "plain": int(not want)}


def _decoder(dtype, seed=3):
    prec = "highest" if dtype == F32 else "default"
    dec = Decoder(output_nc=3, ngf=4, n_downsampling=N_UP,
                  n_blocks=N_BLOCKS, dtype=dtype, precision=prec)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in dec.parameters():      # nonzero biases, so none cancels
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    feat = 4 * 2 ** N_UP
    prop, syn = (torch.randn((2, 4, 4, feat), generator=gen)
                 for _ in range(2))
    return dec, prop, syn


def _composition_upconv(x, kernel, precision, phase_out, bwd_precision):
    """`upconv_in_relu` as it ran before the route: the conv, then the
    inline fp32 one-pass norm and relu over the four phase copies."""
    b, h, w, _ = x.shape
    co = kernel.shape[0]
    y = upconv._ring_and_bulk(x, kernel, precision, bwd_precision)
    yf = y.float().reshape(b, h, w, 4, co)
    n = h * w * 4
    mean = yf.sum(dim=(1, 2, 3), keepdim=True) / n
    var = torch.clamp(yf.square().sum(dim=(1, 2, 3), keepdim=True) / n
                      - mean * mean, min=0.0)
    y = torch.relu((yf - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)
    y = y.reshape(b, h, w, 4 * co)
    return y if phase_out else depth_to_space(y)


def _composition_block(blk, x):
    """`ResnetBlock.forward` as it ran before the route."""
    def conv(t, c):
        return reflect_conv(t, c.weight, c.bias, 1, c.precision, c.dtype,
                            c.bwd_precision, blk.ring_pad)

    h = torch.relu(instance_norm(conv(x, blk.conv1)))
    return x + instance_norm(conv(h, blk.conv2))


def _composition_decoder(dec, prop, syn):
    """`decoder_apply_fast` as it ran before the route: the blocks as
    `ResnetBlock.forward` ran them, the up stages' inline norms."""
    dt, prec, bwd = dec.dtype, dec.precision, dec.bwd_precision
    x = torch.cat([prop, syn], dim=-1).to(dt)
    mc = dec.map_conv
    x = conv2d(x, mc.weight, mc.bias, precision=prec, dtype=dt,
               bwd_precision=bwd)
    for j in range(dec.n_blocks):
        x = _composition_block(getattr(dec, f"block{j}"), x)
    for i in range(dec.n_downsampling):
        x = _composition_upconv(x, getattr(dec, f"up{i}").weight.to(dt),
                                prec, i == dec.n_downsampling - 1, bwd)
    co = dec.conv_out
    out = conv7x7_phase(x, co.weight.to(dt), co.bias.to(dt), precision=prec)
    return torch.tanh(depth_to_space(out))


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernels", "plain"])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_decoder_on_the_cpu_keeps_the_composition_bits(dtype, use_kernels,
                                                       counts):
    dec, prop, syn = _decoder(dtype)
    with torch.no_grad():
        got, _ = decoder_apply_fast(dec, prop, syn, return_fea=False,
                                    use_kernels=use_kernels)
        want = _composition_decoder(dec, prop, syn)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert counts == {"fused": 0, "plain": NORMS}


@pytest.mark.parametrize("phase_out", [False, True], ids=["interleaved",
                                                          "phase"])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_upconv_in_relu_on_the_cpu_either_way_is_the_composition(
        dtype, phase_out, counts):
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, 5, 6, 12), generator=gen).to(dtype)
    k = (torch.randn((8, 12, 3, 3), generator=gen) * 0.2).to(dtype)
    prec = "highest" if dtype == F32 else "default"
    outs = [upconv.upconv_in_relu(x, k, prec, phase_out, use_kernels=u)
            for u in (True, False)]
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], _composition_upconv(x, k, prec, phase_out,
                                                    None))
    assert counts == {"fused": 0, "plain": 2}


def test_decoder_routed_through_k8_on_bf16_inference(on_card, counts):
    """All eleven norms through K8 (its plain version here), within bf16
    rounding of the composition: each block norm rounds once where the
    composition rounds before its ReLU, and the sums run in another
    order."""
    dec, prop, syn = _decoder(BF16)
    with torch.no_grad():
        got, _ = decoder_apply_fast(dec, prop, syn, return_fea=False)
        want = _composition_decoder(dec, prop, syn)
    assert counts == {"fused": NORMS, "plain": 0}
    gap = (got.float() - want.float()).abs()
    print(f"[route] K8 plain version vs composition: max {gap.max():.3e} "
          f"mean {gap.mean():.3e}")
    assert gap.max().item() <= 4 * 2.0 ** -8
    assert gap.mean().item() <= 2.0 ** -9


@pytest.mark.parametrize("case", ["needs_grad", "f32", "no_kernels"])
def test_decoder_keeps_the_composition_off_bf16_inference(on_card, counts,
                                                          case):
    """With the device check reading CUDA: under grad (the fast train
    tier's bf16 decoder, which backpropagates), in fp32 at "highest" (the
    bit-parity tier; fp32 at "high" takes K8:
    tests/test_torch_trunk_norm_route.py) and with `use_kernels=False`
    every norm keeps the composition's bits."""
    dec, prop, syn = _decoder(F32 if case == "f32" else BF16)
    grad = case == "needs_grad"
    with torch.set_grad_enabled(grad):
        got, _ = decoder_apply_fast(dec, prop, syn, return_fea=False,
                                    use_kernels=case != "no_kernels")
    with torch.no_grad():
        want = _composition_decoder(dec, prop, syn)
    assert torch.equal(got.detach(), want)
    assert counts == {"fused": 0, "plain": NORMS}
    if grad:
        got.float().square().mean().backward()
        assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                   for p in (dec.block0.conv1.weight, dec.up0.weight))


class _OneRankMesh:
    """A mesh of one rank: its collectives return what they are given."""

    def copy_to(self, x, axis):
        return x

    def reduce_from(self, x, axis):
        return x

    def all_gather(self, x, axis, dim):
        return x


def test_a_tensor_parallel_block_keeps_its_module(on_card, counts):
    dec, prop, syn = _decoder(BF16)
    dec.block1.tensor_parallel = (_OneRankMesh(), "model")
    with torch.no_grad():
        got, _ = decoder_apply_fast(dec, prop, syn, return_fea=False)
    assert bool(torch.isfinite(got).all())
    assert counts == {"fused": NORMS - 2, "plain": 2}
