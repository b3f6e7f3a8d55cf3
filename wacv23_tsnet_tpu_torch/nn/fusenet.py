"""Synthesis branch FuseNet (counterpart of the JAX package's `nn/fusenet.py`).

`FuseNet`: concat(source image feature, target label feature) -> one
ResNet block at the doubled width -> 1x1 conv back to feat_ch.

`fuse_clip` is the exact split form for S sources shared by F frames:
conv1 acts on concat(a_s, t_f), so its source half runs once per source
and its target half once per frame; only conv2, behind the IN + ReLU,
stays per pair. conv2's bias cancels in the instance norm that follows
and is dropped. The IN + mean over sources is one fused pass
(`ops.norm_kernels.instance_norm_mean`, K2), and the final 1x1 commutes
with the mean, so it runs once per frame.

With a bf16 FuseNet and `TSNET_FUSE_PAIR_KERNEL=1` in the environment
(the JAX package's own opt-in, read at each call as the JAX package reads
it at trace time), the per-pair block runs as K6
(`ops.fuse_kernels.fuse_pair_conv2`): pair-sum + IN + relu + conv2 in one
kernel, so the per-pair normalised tensor never reaches device memory.
Off by default, as in the JAX package.

`fuse_train` is the same split for the training shape, where each sample
has its own S sources and one target: differentiable, with K2's backward
through its recomputed plain composition.

Under tensor parallelism (`block0.tensor_parallel`, see
`nn.blocks.ResnetBlock`) both run conv1, the norm and the ReLU on this
rank's share of the 2C channels and sum conv2's partial sums over the
`model` axis before K2. K6 computes the whole block, so with K6 on the
block's weights are gathered first and every rank runs it whole.

A FuseNet built with `ring_pad` (`TSNetConfig.ring_pad`) runs its
reflect-pad convs, in the module and in both split forms, without the
padded tensor (`ops.reflectconv`), split over ranks too; K6 pads inside.
"""

from __future__ import annotations

import os

import torch
import torch.nn as nn

from ..ops.fuse_kernels import fuse_pair_conv2, fuse_pair_conv2_plain
from ..ops.norm_kernels import (instance_norm_mean, instance_norm_mean_plain,
                                instance_norm_routed)
from ..ops.norms import instance_norm
from ..utils.profiling import TRUNK_NORMS
from .blocks import (Conv2d, ResnetBlock, conv2d, conv2d_split_in,
                     norms_on_k8, reflect_conv)


class FuseNet(nn.Module):
    def __init__(self, ngf: int = 1024, n_blocks: int = 1,
                 dtype=torch.float32, precision: str = "highest",
                 bwd_precision=None, ring_pad: bool = False):
        super().__init__()
        self.n_blocks = n_blocks
        self.dtype = dtype
        self.precision = precision
        self.bwd_precision = bwd_precision
        self.ring_pad = ring_pad
        kw = dict(dtype=dtype, precision=precision,
                  bwd_precision=bwd_precision)
        for j in range(n_blocks):
            self.add_module(f"block{j}",
                            ResnetBlock(ngf, ring_pad=ring_pad, **kw))
        self.conv = Conv2d(ngf, ngf // 2, 1, **kw)

    def forward(self, src_fea: torch.Tensor,
                tar_fea: torch.Tensor) -> torch.Tensor:
        x = torch.cat([src_fea, tar_fea], dim=-1).to(self.dtype)
        for j in range(self.n_blocks):
            x = getattr(self, f"block{j}")(x)
        return self.conv(x)


def fuse_clip(fuse_net: FuseNet, src_fea: torch.Tensor, tar_fea: torch.Tensor,
              use_kernels: bool = True) -> torch.Tensor:
    """mean_s FuseNet(src_fea[s], tar_fea[f]) for all frames, split form.

    src_fea (S, h, w, C); tar_fea (F, h, w, C); `fuse_net.n_blocks == 1`.
    Returns (F, h, w, C) in the FuseNet's dtype. The per-pair norm takes
    the generator's norm route (`ops.norm_kernels.instance_norm_routed`,
    counted in `utils.profiling.TRUNK_NORMS`): one K8 launch at inference
    on the card in a tier that `nn.blocks.norms_on_k8` admits.
    `use_kernels=False` runs the plain version of each kernel (K2, and K6
    where it is on) and the pair norm's composition on any device. Unlike
    the JAX package's `use_pallas=False`, which leaves the K6 branch for
    the unfused composition, it keeps the branch the environment picks
    and swaps only the kernels for their plain versions.
    """
    if fuse_net.n_blocks != 1:
        raise ValueError("fuse_clip needs a one-block FuseNet")
    dt, prec = fuse_net.dtype, fuse_net.precision
    s, h, w, c = src_fea.shape
    f = tar_fea.shape[0]
    blk = fuse_net.block0
    w1, b1, w2 = blk.conv1.weight, blk.conv1.bias, blk.conv2.weight
    pair_kernel = (dt == torch.bfloat16
                   and os.environ.get("TSNET_FUSE_PAIR_KERNEL", "0") == "1")
    tp = blk.tensor_parallel
    if tp is not None and pair_kernel:
        # K6 computes the whole pair block: gather the block's shards
        mesh, axis = tp
        w1, b1 = mesh.all_gather(w1, axis, 0), mesh.all_gather(b1, axis, 0)
        w2 = mesh.all_gather(w2, axis, 1)
        tp = None
    a = src_fea.to(dt)
    t = tar_fea.to(dt)

    def conv(x, weight, bias=None):
        return conv2d(x, weight, bias, precision=prec, dtype=dt)

    def rconv(x, weight, bias=None):
        return reflect_conv(x, weight, bias, 1, prec, dt,
                            ring_pad=fuse_net.ring_pad)

    # (S or F, h, w, 2C), or this rank's share of the 2C under TP
    c1a = rconv(a, w1[:, :c])
    c1t = rconv(t, w1[:, c:], b1)
    if pair_kernel:
        pair_conv = fuse_pair_conv2 if use_kernels else fuse_pair_conv2_plain
        h2 = pair_conv(c1a.contiguous(), c1t.contiguous(), w2)  # bias dropped
    else:
        hp = (c1a[:, None] + c1t[None]).reshape((s * f,) + c1a.shape[1:])
        hp = instance_norm_routed(
            hp, TRUNK_NORMS, relu=True,
            use_kernels=use_kernels and norms_on_k8(dt, prec))
        if tp is None:
            h2 = rconv(hp, w2)                              # bias dropped
        else:
            h2 = conv2d_split_in(hp, w2, None, *tp, prec, dt,
                                 ring_pad=fuse_net.ring_pad)
        h2 = h2.reshape(s, f, h, w, 2 * c).contiguous()
    in_mean = instance_norm_mean if use_kernels else instance_norm_mean_plain
    h2m = in_mean(h2).to(dt)                                # (F, h, w, 2C)
    a_mean = a.float().mean(dim=0).to(dt)
    x_mean = torch.cat([a_mean[None].expand(f, h, w, c), t], dim=-1)
    return conv(x_mean + h2m, fuse_net.conv.weight, fuse_net.conv.bias)


def fuse_train(fuse_net: FuseNet, src_fea: torch.Tensor, tar_fea: torch.Tensor,
               use_kernels: bool = True) -> torch.Tensor:
    """mean_s FuseNet(src_fea[b, s], tar_fea[b]) for the training shape.

    src_fea (B, S, h, w, C); tar_fea (B, h, w, C); one-block FuseNet.
    conv1's source half runs per (b, s), its target half per b, and the
    final 1x1 once per b on the mean. Returns (B, h, w, C) in the
    FuseNet's dtype. `use_kernels=False` runs K2's plain version.
    """
    if fuse_net.n_blocks != 1:
        raise ValueError("fuse_train needs a one-block FuseNet")
    dt, prec = fuse_net.dtype, fuse_net.precision
    b, s, h, w, c = src_fea.shape
    blk = fuse_net.block0
    w1 = blk.conv1.weight                                   # (2C, 2C, 3, 3)
    a = src_fea.to(dt).reshape(b * s, h, w, c)
    t = tar_fea.to(dt)
    a_in, t_in, tp = a, t, blk.tensor_parallel
    if tp is not None:
        # conv1 holds this rank's share of the 2C out-channels
        a_in, t_in = tp[0].copy_to(a, tp[1]), tp[0].copy_to(t, tp[1])

    bwd, ring_pad = fuse_net.bwd_precision, fuse_net.ring_pad

    def conv(x, weight, bias=None):
        return conv2d(x, weight, bias, precision=prec, dtype=dt,
                      bwd_precision=bwd)

    def rconv(x, weight, bias=None):
        return reflect_conv(x, weight, bias, 1, prec, dt, bwd, ring_pad)

    c1a = rconv(a_in, w1[:, :c])                            # (B*S, h, w, 2C)
    c1t = rconv(t_in, w1[:, c:], blk.conv1.bias)            # (B, h, w, 2C)
    k = c1t.shape[-1]
    hp = (c1a.reshape(b, s, h, w, k) + c1t[:, None]).reshape(b * s, h, w, k)
    hp = torch.relu(instance_norm(hp))
    if tp is None:
        h2 = rconv(hp, blk.conv2.weight)                    # bias dropped
    else:
        h2 = conv2d_split_in(hp, blk.conv2.weight, None, *tp, prec, dt, bwd,
                             ring_pad)
    h2 = h2.reshape(b, s, h, w, 2 * c).transpose(0, 1).contiguous()
    in_mean = instance_norm_mean if use_kernels else instance_norm_mean_plain
    h2m = in_mean(h2).to(dt)                                # (B, h, w, 2C)
    a_mean = src_fea.float().mean(dim=1).to(dt)
    x_mean = torch.cat([a_mean, t], dim=-1)
    return conv(x_mean + h2m, fuse_net.conv.weight, fuse_net.conv.bias)
