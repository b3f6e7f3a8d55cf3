"""TS-Net decoder (counterpart of the JAX package's `Decoder.__call__`).

A 1x1 `map_conv` fuses the concatenated warp-branch and synthesis-branch
features (2*feat_ch -> feat_ch), then `n_blocks` ResNet blocks, then
`n_downsampling` [bilinear-2x upsample, reflect-pad 3x3 conv halving the
channels, IN, ReLU] stages, then a reflect-pad 7x7 conv + tanh to RGB.

This is the plain form. The JAX clip path runs `decoder_apply_fast`, a
TPU layout rewrite of the same math (phase-decomposed upsample convs);
the tests hold this module against it. `fused_blocks=True` on a bf16
decoder is the counterpart of its `use_pallas_blocks=True`: each ResNet
block runs as two K7 calls (`ops.conv_kernels.resblock_fused`), which
drop the blocks' conv biases (they cancel in the instance norms). A
tensor-parallel block (`nn.blocks.ResnetBlock`) gathers its weights
first, so K7 sees whole convolutions.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.conv_kernels import resblock_fused
from ..ops.norms import instance_norm
from ..ops.resize import upsample_bilinear_2x
from .blocks import Conv2d, ResnetBlock, reflect_pad


class Decoder(nn.Module):
    def __init__(self, output_nc: int = 3, ngf: int = 64,
                 n_downsampling: int = 4, n_blocks: int = 0,
                 dtype=torch.float32, precision: str = "highest",
                 bwd_precision=None):
        super().__init__()
        self.n_downsampling = n_downsampling
        self.n_blocks = n_blocks
        self.dtype = dtype
        kw = dict(dtype=dtype, precision=precision,
                  bwd_precision=bwd_precision)
        feat = ngf * 2 ** n_downsampling
        self.map_conv = Conv2d(2 * feat, feat, 1, **kw)
        for j in range(n_blocks):
            self.add_module(f"block{j}", ResnetBlock(feat, **kw))
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
        else:
            for j in range(self.n_blocks):
                x = getattr(self, f"block{j}")(x)
        for i in range(self.n_downsampling):
            x = reflect_pad(upsample_bilinear_2x(x), 1)
            x = torch.relu(instance_norm(getattr(self, f"up{i}")(x)))
        return torch.tanh(self.conv_out(reflect_pad(x, 3)))
