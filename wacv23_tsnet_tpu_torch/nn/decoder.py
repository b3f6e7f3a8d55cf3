"""TS-Net decoder (counterpart of the JAX package's `Decoder.__call__`).

A 1x1 `map_conv` fuses the concatenated warp-branch and synthesis-branch
features (2*feat_ch -> feat_ch), then `n_blocks` ResNet blocks, then
`n_downsampling` [bilinear-2x upsample, reflect-pad 3x3 conv halving the
channels, IN, ReLU] stages, then a reflect-pad 7x7 conv + tanh to RGB.

`Decoder` is the plain form. `decoder_apply_fast` computes the same
function from the same parameters with each upsample stage
phase-decomposed (`ops.upconv`): one conv at the input's resolution with
4x the output channels, the exact border ring recomputed and the
instance norm and ReLU fused; the last stage stays in phase layout
through the 7x7 output conv (`conv7x7_phase`) and only the tanh'd RGB is
interleaved. The upsampled tensors and their reflect-padded copies are
never made. `models.tsnet` runs it on the clip and train paths, as the
JAX package does; the tests hold both forms against the JAX package's
`decoder_apply_fast`.

`decoder_apply_fast` runs its eleven instance norms (at the face
config: two in each of 4 ResNet blocks, one in each of 3 up stages)
through the generator's norm route (`ops.norm_kernels.instance_norm_routed`,
counted in `utils.profiling.DECODER_NORMS`): K8, one launch each, ReLU
folded in, where the decoder runs inference on the card in a tier that
`nn.blocks.norms_on_k8` admits (bf16, or fp32 at "high"), and the ATen
composition everywhere else: on the CPU, while a gradient flows
(training), with `use_kernels=False`, in fp32 at another precision (at
"highest", the bit-parity tier). A tensor-parallel block keeps the
composition; the plain `Decoder.forward` always runs the composition.

`fused_blocks=True` on a bf16 decoder is the counterpart of the JAX
package's `use_pallas_blocks=True`: each ResNet block runs as two K7
calls (`ops.conv_kernels.resblock_fused`), which drop the blocks' conv
biases (they cancel in the instance norms). A tensor-parallel block
(`nn.blocks.ResnetBlock`) gathers its weights first, so K7 sees whole
convolutions.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.conv_kernels import resblock_fused
from ..ops.norms import instance_norm
from ..ops.dpconv import conv2d
from ..ops.resize import upsample_bilinear_2x
from ..ops.upconv import conv7x7_phase, depth_to_space, upconv_in_relu
from ..utils.profiling import DECODER_NORMS
from .blocks import Conv2d, ResnetBlock, norms_on_k8, reflect_pad


class Decoder(nn.Module):
    def __init__(self, output_nc: int = 3, ngf: int = 64,
                 n_downsampling: int = 4, n_blocks: int = 0,
                 dtype=torch.float32, precision: str = "highest",
                 bwd_precision=None, ring_pad: bool = False):
        super().__init__()
        self.n_downsampling = n_downsampling
        self.n_blocks = n_blocks
        self.dtype = dtype
        self.precision = precision
        self.bwd_precision = bwd_precision
        kw = dict(dtype=dtype, precision=precision,
                  bwd_precision=bwd_precision)
        feat = ngf * 2 ** n_downsampling
        self.map_conv = Conv2d(2 * feat, feat, 1, **kw)
        for j in range(n_blocks):
            self.add_module(f"block{j}",
                            ResnetBlock(feat, ring_pad=ring_pad, **kw))
        for i in range(n_downsampling):
            mult = 2 ** (n_downsampling - i)
            self.add_module(f"up{i}",
                            Conv2d(ngf * mult, ngf * mult // 2, 3, **kw))
        self.conv_out = Conv2d(ngf, output_nc, 7, **kw)

    def forward(self, prop_fea: torch.Tensor, syn_fea: torch.Tensor,
                fused_blocks: bool = False,
                use_kernels: bool = True) -> torch.Tensor:
        """(B, h, w, C) x 2 -> (B, H, W, output_nc) tanh image, in the
        module's dtype. `fused_blocks` runs the ResNet blocks through K7
        when the decoder is bf16 (its plain version with
        `use_kernels=False`); otherwise they run as plain modules."""
        x = torch.cat([prop_fea, syn_fea], dim=-1).to(self.dtype)
        x = self.map_conv(x)
        if fused_blocks and self.dtype == torch.bfloat16:
            x = self.run_fused_blocks(x, use_kernels)
        else:
            for j in range(self.n_blocks):
                x = getattr(self, f"block{j}")(x)
        for i in range(self.n_downsampling):
            x = reflect_pad(upsample_bilinear_2x(x), 1)
            x = torch.relu(instance_norm(getattr(self, f"up{i}")(x)))
        return torch.tanh(self.conv_out(reflect_pad(x, 3)))

    def run_fused_blocks(self, x: torch.Tensor,
                         use_kernels: bool) -> torch.Tensor:
        """The ResNet blocks of a bf16 decoder through K7 (its plain
        version with `use_kernels=False`)."""
        x = x.contiguous()
        for j in range(self.n_blocks):
            blk = getattr(self, f"block{j}")
            w1, w2 = blk.conv1.weight, blk.conv2.weight
            if blk.tensor_parallel is not None:
                # K7 normalises whole conv outputs: gather the shards
                mesh, axis = blk.tensor_parallel
                w1 = mesh.all_gather(w1, axis, 0)
                w2 = mesh.all_gather(w2, axis, 1)
            x = resblock_fused(x, w1, w2, use_kernels=use_kernels)
        return x


def decoder_apply_fast(dec: Decoder, prop_fea: torch.Tensor,
                       syn_fea: torch.Tensor, return_fea: bool = True,
                       fused_blocks: bool = False, use_kernels: bool = True):
    """`dec(prop_fea, syn_fea)` with the upsample stages phase-decomposed
    (the JAX package's `decoder_apply_fast`): the same parameters, the
    same function, borders included.

    Returns (rgb (B, H, W, 3) tanh image in the decoder's dtype, the
    penultimate feature map (B, H, W, ngf) or None with `return_fea=False`,
    which skips interleaving it). `fused_blocks` and `use_kernels` as in
    `Decoder.forward`; `use_kernels` also lets the instance norms of the
    blocks and up stages take K8 (the module docstring). The JAX
    function's `bwd_precision` and `ring_pad` are the decoder's own, as it
    was built (`models.tsnet` builds it from
    the config): `bwd_precision` is the backward's tier of the map conv,
    the blocks and the up stages' bulk convs (None: the forward's; the
    output conv runs its backward at the forward's, as in the JAX
    package), and `ring_pad` runs the blocks' reflect-pad convs without
    the padded tensor."""
    dt, prec, bwd = dec.dtype, dec.precision, dec.bwd_precision
    x = torch.cat([prop_fea, syn_fea], dim=-1).to(dt)
    mc = dec.map_conv
    x = conv2d(x, mc.weight, mc.bias, precision=prec, dtype=dt,
               bwd_precision=bwd)
    k8 = use_kernels and norms_on_k8(dt, prec)
    if fused_blocks and dt == torch.bfloat16:
        x = dec.run_fused_blocks(x, use_kernels)
    else:
        for j in range(dec.n_blocks):
            x = getattr(dec, f"block{j}")(x, k8, DECODER_NORMS)
    # the up stages' conv biases cancel in their instance norms
    for i in range(dec.n_downsampling):
        x = upconv_in_relu(x, getattr(dec, f"up{i}").weight.to(dt),
                           precision=prec,
                           phase_out=i == dec.n_downsampling - 1,
                           bwd_precision=bwd, use_kernels=k8)
    co = dec.conv_out
    out = conv7x7_phase(x, co.weight.to(dt), co.bias.to(dt), precision=prec)
    rgb = torch.tanh(depth_to_space(out))
    return rgb, depth_to_space(x) if return_fea else None
