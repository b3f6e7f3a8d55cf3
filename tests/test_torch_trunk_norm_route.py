"""The generator's one instance-norm route, at every site (CPU; no JAX).

`ops.norm_kernels.instance_norm_routed` sends an instance norm (+ ReLU)
through K8 where `fuses_norm` says so (a CUDA tensor, no gradient,
`use_kernels`, and for fp32 a cluster that covers the shape, since only
K8's cluster path has the two-pass form), else through the ATen
composition, and counts it by route in the site's counter:
`utils.profiling.TRUNK_NORMS` for the encoders and FuseNet,
`DECODER_NORMS` for the phase decoder. Here, at each site (the stem, the
folded stem, the stride-2 convs, a ResNet block, FuseNet's per-pair norm,
the decoder): on the CPU, under grad and with `use_kernels=False` the
composition's bits and counts; in fp32 at "highest" and "default", which
`nn.blocks.norms_on_k8` keeps off K8, the same; with the route's device
check made to read CUDA, K8's plain versions (the two-pass form for fp32, the one-pass form
for bf16) within rounding of the composition, counted by site; K8's
two-pass plain form against `ops.norms`; its plans at the clip's trunk
shapes; and a toy clip whose counters count each site's norms.
"""

import dataclasses
import types

import pytest
import torch

from wacv23_tsnet_tpu_torch.configs import toy_config
from wacv23_tsnet_tpu_torch.models.tsnet import (TSNetModules,
                                                 decode_with_sources,
                                                 encode_sources)
from wacv23_tsnet_tpu_torch.nn.blocks import (ResnetBlock, norms_on_k8,
                                              reflect_conv)
from wacv23_tsnet_tpu_torch.nn.decoder import Decoder, decoder_apply_fast
from wacv23_tsnet_tpu_torch.nn.encoder import Encoder, folded_stem
from wacv23_tsnet_tpu_torch.nn.fusenet import FuseNet, fuse_clip
from wacv23_tsnet_tpu_torch.ops import norm_kernels, upconv
from wacv23_tsnet_tpu_torch.ops.dpconv import conv2d
from wacv23_tsnet_tpu_torch.ops.norm_kernels import instance_norm_mean_plain
from wacv23_tsnet_tpu_torch.ops.norms import (instance_norm,
                                              instance_norm_phase)
from wacv23_tsnet_tpu_torch.ops.stemconv import (depth_to_space,
                                                 stem_conv7_fold4)
from wacv23_tsnet_tpu_torch.utils.profiling import (DECODER_NORMS,
                                                    TRUNK_NORMS)

torch.set_num_threads(2)

BF16, F32 = torch.bfloat16, torch.float32
# each dtype's precision in a tier whose norms take K8
# (`nn.blocks.norms_on_k8`): on the CPU
# "high" is the fp32 conv, bit for bit "highest"'s
PREC = {F32: "high", BF16: "default"}


@pytest.fixture(autouse=True)
def counts(monkeypatch):
    """Both counters from zero for each test."""
    for counter in (TRUNK_NORMS, DECODER_NORMS):
        for k in counter:
            monkeypatch.setitem(counter, k, 0)
    return {"trunk": TRUNK_NORMS, "decoder": DECODER_NORMS}


@pytest.fixture
def on_card(monkeypatch):
    """The route's device check reads CUDA for every tensor; the rest of
    the decision (grad, `use_kernels`, the plan) and the count are the
    route's own. K8 then runs its plain versions, as CPU tensors do."""
    real = norm_kernels.fuses_norm

    def fuses(x, *args, **kwargs):
        card = types.SimpleNamespace(
            device=torch.device("cuda"), dtype=x.dtype, shape=x.shape,
            requires_grad=x.requires_grad, element_size=x.element_size,
            data_ptr=x.data_ptr)
        return real(card, *args, **kwargs)

    monkeypatch.setattr(norm_kernels, "fuses_norm", fuses)


def _fill(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():   # nonzero biases, so none cancels
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return gen


# Each site: (build(dtype, precision) -> (run(use_kernels), composition()),
# counter, norms a call). `run` is the site as the model calls it; `composition`
# the same sums written out with `ops.norms`, as every site ran before
# the route.

def _stem(dtype, prec):
    enc = Encoder(5, ngf=8, n_downsampling=0, n_blocks=0, dtype=dtype,
                  precision=prec)
    gen = _fill(enc, 1)
    x = torch.randn((2, 12, 16, 5), generator=gen)

    def composition():
        c = enc.conv_in
        y = reflect_conv(x, c.weight, c.bias, 3, c.precision, c.dtype)
        return torch.relu(instance_norm(y))

    return lambda u: enc(x, use_kernels=u), composition


def _folded_stem(dtype, prec):
    enc = Encoder(5, ngf=8, n_downsampling=0, n_blocks=0, dtype=dtype,
                  precision=prec)
    gen = _fill(enc, 2)
    x = torch.randn((2, 12, 16, 5), generator=gen)
    c = enc.conv_in

    def composition():
        yf = stem_conv7_fold4(x.to(c.dtype), c.weight.to(c.dtype),
                              c.bias.to(c.dtype), c.precision, 4)
        return depth_to_space(torch.relu(instance_norm_phase(yf, groups=16)),
                              4)

    return lambda u: folded_stem(c, x, use_kernels=u), composition


def _trunk(dtype, prec):
    enc = Encoder(8, ngf=4, n_downsampling=2, n_blocks=0, dtype=dtype,
                  precision=prec)
    gen = _fill(enc, 3)
    x = torch.randn((2, 12, 16, 4), generator=gen).to(dtype)

    def composition():
        y = x
        for i in range(2):
            y = torch.relu(instance_norm(getattr(enc, f"down{i}")(y)))
        return y

    return lambda u: enc.trunk(x, use_kernels=u), composition


def _resblock(blk, x):
    """`ResnetBlock.forward`'s sums as it ran before the route."""
    def conv(t, c):
        return reflect_conv(t, c.weight, c.bias, 1, c.precision, c.dtype)

    h = torch.relu(instance_norm(conv(x, blk.conv1)))
    return x + instance_norm(conv(h, blk.conv2))


def _block(dtype, prec):
    blk = ResnetBlock(16, dtype=dtype, precision=prec)
    gen = _fill(blk, 4)
    x = torch.randn((2, 6, 5, 16), generator=gen).to(dtype)
    return lambda u: blk(x, u, TRUNK_NORMS), lambda: _resblock(blk, x)


def _fuse_pair(dtype, prec):
    net = FuseNet(ngf=16, n_blocks=1, dtype=dtype, precision=prec)
    gen = _fill(net, 5)
    src = torch.randn((2, 6, 6, 8), generator=gen)
    tar = torch.randn((3, 6, 6, 8), generator=gen)

    def composition():
        """`fuse_clip` as it ran before the route."""
        blk = net.block0
        a, t = src.to(dtype), tar.to(dtype)
        w1 = blk.conv1.weight
        c1a = reflect_conv(a, w1[:, :8], None, 1, prec, dtype)
        c1t = reflect_conv(t, w1[:, 8:], blk.conv1.bias, 1, prec, dtype)
        hp = (c1a[:, None] + c1t[None]).reshape((6,) + c1a.shape[1:])
        hp = torch.relu(instance_norm(hp))
        h2 = reflect_conv(hp, blk.conv2.weight, None, 1, prec, dtype)
        h2m = instance_norm_mean_plain(
            h2.reshape(2, 3, 6, 6, 16).contiguous()).to(dtype)
        a_mean = a.float().mean(dim=0).to(dtype)
        x_mean = torch.cat([a_mean[None].expand(3, 6, 6, 8), t], dim=-1)
        return conv2d(x_mean + h2m, net.conv.weight, net.conv.bias,
                      precision=prec, dtype=dtype)

    return lambda u: fuse_clip(net, src, tar, use_kernels=u), composition


def _upconv(x, kernel, precision, phase_out):
    """`upconv_in_relu` as it ran before the route: the conv, then the
    inline fp32 one-pass norm and relu over the four phase copies."""
    b, h, w, _ = x.shape
    co = kernel.shape[0]
    y = upconv._ring_and_bulk(x, kernel, precision)
    yf = y.float().reshape(b, h, w, 4, co)
    n = h * w * 4
    mean = yf.sum(dim=(1, 2, 3), keepdim=True) / n
    var = torch.clamp(yf.square().sum(dim=(1, 2, 3), keepdim=True) / n
                      - mean * mean, min=0.0)
    y = torch.relu((yf - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)
    y = y.reshape(b, h, w, 4 * co)
    return y if phase_out else upconv.depth_to_space(y)


def _decoder(dtype, prec):
    dec = Decoder(output_nc=3, ngf=4, n_downsampling=3, n_blocks=4,
                  dtype=dtype, precision=prec)
    gen = _fill(dec, 6)
    prop, syn = (torch.randn((2, 4, 4, 32), generator=gen)
                 for _ in range(2))

    def composition():
        """`decoder_apply_fast` as it ran before the route."""
        x = torch.cat([prop, syn], dim=-1).to(dtype)
        mc = dec.map_conv
        x = conv2d(x, mc.weight, mc.bias, precision=prec, dtype=dtype)
        for j in range(4):
            x = _resblock(getattr(dec, f"block{j}"), x)
        for i in range(3):
            x = _upconv(x, getattr(dec, f"up{i}").weight.to(dtype), prec,
                        i == 2)
        co = dec.conv_out
        out = upconv.conv7x7_phase(x, co.weight.to(dtype), co.bias.to(dtype),
                                   precision=prec)
        return torch.tanh(upconv.depth_to_space(out))

    def run(u):
        return decoder_apply_fast(dec, prop, syn, return_fea=False,
                                  use_kernels=u)[0]

    return run, composition


# site -> (build, counter, norms a call)
SITES = {"stem": (_stem, "trunk", 1),
         "folded_stem": (_folded_stem, "trunk", 1),
         "trunk": (_trunk, "trunk", 2),
         "resnet_block": (_block, "trunk", 2),
         "fuse_pair": (_fuse_pair, "trunk", 1),
         "decoder": (_decoder, "decoder", 11)}
DTYPES = {"f32": F32, "bf16": BF16}


def _other(counter):
    return "decoder" if counter == "trunk" else "trunk"


@pytest.mark.parametrize("mode", ["kernels", "no_kernels", "grad"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("site", list(SITES))
def test_cpu_keeps_the_composition_bits(site, dtype, mode, counts):
    """On the CPU, with or without kernels and under grad, every site
    gives the composition's bits and counts each norm as plain in its
    own counter alone."""
    build, counter, n = SITES[site]
    run, composition = build(DTYPES[dtype], PREC[DTYPES[dtype]])
    with torch.set_grad_enabled(mode == "grad"):
        got = run(mode != "no_kernels")
    with torch.no_grad():
        want = composition()
    assert torch.equal(got.detach(), want)
    assert counts[counter] == {"fused": 0, "plain": n}
    assert counts[_other(counter)] == {"fused": 0, "plain": 0}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("site", list(SITES))
def test_inference_on_the_card_routes_through_k8(on_card, site, dtype,
                                                 counts):
    """With the device check reading CUDA, every norm of every site goes
    through K8 (its plain versions here), counted as fused in the site's
    counter, within rounding of the composition: fp32 in the two-pass form
    (the decoder's up stages one-pass, as their composition), bf16
    one-pass with one rounding where the composition rounds before the
    ReLU."""
    build, counter, n = SITES[site]
    run, composition = build(DTYPES[dtype], PREC[DTYPES[dtype]])
    with torch.no_grad():
        got = run(True)
        assert counts[counter] == {"fused": n, "plain": 0}
        assert counts[_other(counter)] == {"fused": 0, "plain": 0}
        want = composition()
    gap = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    print(f"[route] {site} {dtype}: max {gap.max():.3e} mean "
          f"{gap.mean():.3e} (scale {scale:.3e})")
    if dtype == "f32":
        assert gap.max().item() <= 1e-5 * max(scale, 1.0)
    else:
        assert gap.max().item() <= 4 * 2.0 ** -8 * max(scale, 1.0)
        assert gap.mean().item() <= 2.0 ** -9 * max(scale, 1.0)


@pytest.mark.parametrize("case", ["needs_grad", "no_kernels", "highest",
                                  "default"])
@pytest.mark.parametrize("site", list(SITES))
def test_the_card_keeps_the_composition_off_inference(on_card, site, case,
                                                      counts):
    """With the device check reading CUDA: where a gradient flows, with
    `use_kernels=False`, and in fp32 at precision "highest" (the
    bit-parity tier) or "default" (`fast_trunk`'s one bf16 pass), which
    `nn.blocks.norms_on_k8` does not admit, every site keeps the
    composition's bits."""
    build, counter, n = SITES[site]
    run, composition = build(F32, case if case in ("highest", "default")
                             else "high")
    with torch.set_grad_enabled(case == "needs_grad"):
        got = run(case != "no_kernels")
    with torch.no_grad():
        want = composition()
    assert torch.equal(got.detach(), want)
    assert counts[counter] == {"fused": 0, "plain": n}


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_norms_on_k8_admits_bf16_and_fp32_at_high(dtype, precision):
    """The tiers whose norms may take K8: every bf16 subnet, and fp32
    ones only with bf16x3 convs ("high")."""
    want = dtype == "bf16" or precision == "high"
    assert norms_on_k8(DTYPES[dtype], precision) is want


@pytest.mark.parametrize("relu", [False, True], ids=["norm", "relu"])
@pytest.mark.parametrize("groups", [1, 4, 16])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_two_pass_plain_form_is_the_ports_instance_norm(dtype, groups,
                                                        relu):
    """K8's two-pass plain form is `ops.norms.instance_norm` (groups 1) or
    `instance_norm_phase` (groups > 1) with the fp32 two-pass statistics,
    whatever the dtype: bit for bit for fp32; for bf16 one rounding of the
    same fp32 values."""
    gen = torch.Generator().manual_seed(groups)
    x = (torch.randn((2, 5, 7, 8 * groups), generator=gen) * 1.5
         + torch.randn(8 * groups, generator=gen) * 3).to(DTYPES[dtype])
    got = norm_kernels.instance_norm_fused(x, relu=relu, phase_groups=groups,
                                           two_pass=True)
    xf = x.float()
    want = (instance_norm(xf) if groups == 1
            else instance_norm_phase(xf, groups=groups))
    want = (torch.relu(want) if relu else want).to(x.dtype)
    assert got.dtype == x.dtype
    assert torch.equal(got, want)


def test_two_pass_form_differs_from_the_one_pass_form():
    """The two forms are two formulas: on a channel with a large mean the
    one-pass E[x²] - E[x]² loses digits the two-pass form keeps."""
    gen = torch.Generator().manual_seed(9)
    x = torch.randn((1, 16, 16, 8), generator=gen) * 1e-2 + 300.0
    one = norm_kernels.instance_norm_fused(x)
    two = norm_kernels.instance_norm_fused(x, two_pass=True)
    want = instance_norm(x.double()).float()
    assert (two - want).abs().max() < (one - want).abs().max()


# the clip's trunk norms at a 64-frame chunk: name -> (N, C, G, itemsize)
# and the blocks of K8's cluster a unit
TRUNK_PLANS = {"stem": ((65536, 64, 1, 4), 16),
               "folded_stem": ((4096, 1024, 16, 4), 16),
               "down0": ((16384, 128, 1, 4), 4),
               "down1": ((4096, 256, 1, 4), 1),
               "down2": ((1024, 512, 1, 4), 1),
               "image_encoder_block": ((1024, 512, 1, 4), 1),
               "fuse_pair": ((1024, 1024, 1, 2), 1)}


@pytest.mark.parametrize("name", list(TRUNK_PLANS))
def test_the_clip_trunk_norms_take_the_cluster_path(name):
    """Every trunk norm of the face clip has a cluster that covers it, so
    the route never leaves an fp32 norm to the composition there."""
    (n, c, groups, itemsize), cluster = TRUNK_PLANS[name]
    plan = norm_kernels.fused_plan(n, c, groups, itemsize)
    assert (plan.path, plan.cluster) == ("cluster", cluster)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_a_shape_no_cluster_covers_keeps_fp32_on_the_composition(dtype,
                                                                  counts):
    """An fp32 stem at 512² (64 channels, 262,144 pixels) has no cluster:
    the three-launch path has no two-pass form, so the route keeps the
    composition; bf16 there takes K8's three-launch path."""
    card = types.SimpleNamespace(
        device=torch.device("cuda"), dtype=DTYPES[dtype],
        shape=(1, 512, 512, 64), requires_grad=False,
        element_size=lambda: 4 if dtype == "f32" else 2, data_ptr=lambda: 0)
    two = dtype == "f32"
    assert norm_kernels.fuses_norm(card, True, TRUNK_NORMS,
                                   two_pass=two) is (not two)
    assert TRUNK_NORMS == {"fused": int(not two), "plain": int(two)}


def test_a_tensor_parallel_block_keeps_the_composition(on_card, counts):
    class _OneRankMesh:
        def copy_to(self, x, axis):
            return x

        def reduce_from(self, x, axis):
            return x

    blk = ResnetBlock(16)
    blk.tensor_parallel = (_OneRankMesh(), "model")
    with torch.no_grad():
        blk(torch.randn(1, 4, 4, 16), True, TRUNK_NORMS)
    assert TRUNK_NORMS == {"fused": 0, "plain": 2}


def _toy_clip(mods, use_kernels):
    gen = torch.Generator().manual_seed(8)
    size, nc, s, f = 64, 2, 2, 3
    src_img = torch.rand((s, size, size, 3), generator=gen) - 0.5
    src_lbl = torch.nn.functional.one_hot(
        torch.randint(0, nc, (s, size, size), generator=gen), nc).float()
    tar_lbl = torch.nn.functional.one_hot(
        torch.randint(0, nc, (f, size, size), generator=gen), nc).float()
    box = torch.ones((s + f, size, size))
    pack = encode_sources(mods, src_img, src_lbl, box[:s],
                          use_kernels=use_kernels)
    return decode_with_sources(mods, pack, tar_lbl, box[s:],
                               use_kernels=use_kernels)


# tier -> its fields over toy_config(), and whether the encoders' norms
# and FuseNet's and the decoder's take K8
TOY_TIERS = {"high": (dict(precision="high"), True, True),
             "fast_tail": (dict(precision="high", fast_tail=True), True, True),
             "bench": (dict(precision="high", fast_tail=True,
                            fast_trunk=True), False, True),
             "bit_parity": ({}, False, False)}


@pytest.mark.parametrize("tier", list(TOY_TIERS))
def test_a_toy_clip_counts_each_sites_norms(on_card, tier, counts):
    """A clip chunk through the route: the image encoder (stem, two
    stride-2 convs, two blocks) and the label encoder (stem, two stride-2
    convs) in `TRUNK_NORMS`, fused where the tier's encoders take K8
    ("high" ones, not `fast_trunk`'s or "highest"'s); FuseNet's pair norm
    there too, and the decoder's block and up stages in `DECODER_NORMS`,
    fused in a bf16 or "high" tail; with `use_kernels=False` all plain,
    and the frames near the plain path's."""
    fields, trunk_k8, tail_k8 = TOY_TIERS[tier]
    cfg = dataclasses.replace(toy_config(), **fields)
    mods = TSNetModules(cfg, device="cpu", seed=3)
    encoders, pair, decoder = (1 + 2 + 2 * 2) + (1 + 2), 1, 2 * 1 + 2
    trunk = encoders * trunk_k8 + pair * tail_k8
    with torch.no_grad():
        fused = _toy_clip(mods, True)
        assert counts["trunk"] == {"fused": trunk,
                                   "plain": encoders + pair - trunk}
        assert counts["decoder"] == {"fused": decoder * tail_k8,
                                     "plain": decoder * (not tail_k8)}
        plain = _toy_clip(mods, False)
        assert counts["trunk"] == {"fused": trunk,
                                   "plain": 2 * (encoders + pair) - trunk}
        assert counts["decoder"] == {"fused": decoder * tail_k8,
                                     "plain": decoder * (2 - tail_k8)}
    assert bool(torch.isfinite(fused).all())
    assert (fused - plain).abs().max().item() < 0.05
