"""Whole-clip TS-Net inference (counterpart of the JAX package's
`models/tsnet.py:encode_sources`, `decode_with_sources` and
`tsnet_forward_clip`).

Conventions are the JAX package's: NHWC tensors; images in model space
((BGR - mean) / 255); labels one-hot (…, H, W, label_nc); bbox masks
float (…, H, W). The S reference frames are encoded once
(`encode_sources`) and every chunk of driving frames reuses the pack
(`decode_with_sources`).

Tiers (configs/base.py): the encoders run at `precision`, or one bf16
pass under `fast_trunk`; FuseNet and the decoder run in bf16 under
`fast_tail`, where the transformation branch writes its source mean in
bf16 through K1; otherwise K3-nf writes every pair in f32 and the mean is
taken here. Both tiers run K2 inside `fuse_clip`.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..configs import TSNetConfig
from ..device import resolve_device
from ..nn import Decoder, Encoder, FuseNet, fuse_clip
from ..nn.blocks import Conv2d
from ..ops.norms import l2_normalize
from ..ops.resize import resize_nearest
from ..ops.similarity import (transformation_warp_clip,
                              transformation_warp_clip_mean)


class TSNetModules(nn.Module):
    """The generator subnets of one config, initialised from `seed`.

    Submodule and parameter names follow the JAX package's param tree
    (`img_enc`, `lbl_enc`, `dec`, `fuse_net`; `conv_in`, `down{i}`,
    `block{j}.conv{1,2}`, `map_conv`, `up{i}`, `conv_out`, `conv`), so
    `compat.flax_params` maps one onto the other by name.
    """

    def __init__(self, cfg: TSNetConfig, device="cuda", seed: int = 0):
        super().__init__()
        if cfg.ring_pad:
            raise NotImplementedError("ring_pad is a TPU training knob; the "
                                      "port does not implement it")
        if cfg.use_fg_mask:
            raise NotImplementedError("the pose variant (use_fg_mask) is not "
                                      "ported yet")
        dev = resolve_device(device)
        self.cfg = cfg
        dt = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
              else torch.float32)
        self.dtype = dt
        prec = cfg.precision
        trunk_prec = "default" if cfg.fast_trunk else prec
        common = dict(ngf=cfg.ngf, n_downsampling=cfg.n_downsampling)
        self.img_enc = Encoder(3 + cfg.label_nc, n_blocks=cfg.enc_n_blocks,
                               addcoords=cfg.addcoords, dtype=dt,
                               precision=trunk_prec, **common)
        self.lbl_enc = Encoder(cfg.label_nc, n_blocks=0,
                               addcoords=cfg.addcoords, dtype=dt,
                               precision=trunk_prec, **common)
        tail_dt = torch.bfloat16 if cfg.fast_tail else dt
        tail_prec = "default" if cfg.fast_tail else prec
        self.dec = Decoder(output_nc=3, n_blocks=cfg.dec_n_blocks,
                           dtype=tail_dt, precision=tail_prec, **common)
        self.fuse_net = FuseNet(ngf=2 * cfg.feat_ch, n_blocks=1,
                                dtype=tail_dt, precision=tail_prec)
        self.init_generator_params(seed)
        self.requires_grad_(False)
        self.to(dev)
        self.device = dev

    def init_generator_params(self, seed: int) -> None:
        """normal(0, 0.02) kernels, zero biases (the JAX package's init
        distribution), drawn from one CPU `torch.Generator` in module
        order, so a seed gives the same weights on every device. The
        numbers differ from `jax.random`'s; tests carry weights across
        with `compat.flax_params`."""
        gen = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, Conv2d):
                mod.reset_parameters(gen)


def encode_sources(mods: TSNetModules, src_img: torch.Tensor,
                   src_lbl: torch.Tensor, src_bbox: torch.Tensor) -> dict:
    """Encode the S reference frames once: the source pack reused by
    every chunk of driving frames. src_img (S, H, W, 3), src_lbl
    (S, H, W, L), src_bbox (S, H, W), on the modules' device."""
    with torch.inference_mode():
        enc_in = torch.cat([src_img, src_lbl], dim=-1).to(mods.dtype)
        src_fea = mods.img_enc(enc_in)
        hw = src_fea.shape[1:3]
        return {
            "fea": src_fea,
            "fea_n": l2_normalize(src_fea.float()),
            "mask": resize_nearest(src_bbox[..., None].float(), hw)[..., 0],
        }


def decode_with_sources(mods: TSNetModules, src_pack: dict,
                        tar_lbl: torch.Tensor, tar_bbox: torch.Tensor,
                        use_kernels: bool = True) -> torch.Tensor:
    """Run F driving frames against a source pack -> (F, H, W, 3) f32.

    `use_kernels=False` runs every kernel's plain PyTorch version instead
    (the reference the kernels are held against, as `use_pallas=False`
    is in the JAX package); on CPU tensors the two are the same path.
    """
    cfg = mods.cfg
    with torch.inference_mode():
        src_fea = src_pack["fea"].float()
        tar_fea = mods.lbl_enc(tar_lbl.to(mods.dtype))       # (F, h, w, C)
        h, w = tar_fea.shape[1:3]
        tar_fea_n = l2_normalize(tar_fea.float())
        tar_mask = resize_nearest(tar_bbox[..., None].float(), (h, w))[..., 0]
        if mods.dec.dtype == torch.bfloat16:
            # fast tail: K1 folds the mean over sources in and writes bf16
            prop_fea = transformation_warp_clip_mean(
                src_fea, src_pack["fea_n"], src_pack["mask"], tar_fea_n,
                tar_mask, temp=cfg.softmax_temp, out_dtype=torch.bfloat16,
                use_kernels=use_kernels)
        else:
            warped = transformation_warp_clip(
                src_fea, src_pack["fea_n"], src_pack["mask"], tar_fea_n,
                tar_mask, temp=cfg.softmax_temp, use_kernels=use_kernels)
            prop_fea = warped.mean(dim=0).to(mods.dtype)
        syn_fea = fuse_clip(mods.fuse_net, src_fea, tar_fea.float(),
                            use_kernels=use_kernels)
        return mods.dec(prop_fea, syn_fea).float()


def tsnet_forward_clip(mods: TSNetModules, src_img, src_lbl, src_bbox,
                       tar_lbl, tar_bbox, use_kernels: bool = True,
                       device="cuda") -> torch.Tensor:
    """Whole-clip inference: encode the S references once, batch frames.

    src_img (S, H, W, 3) model space, src_lbl (S, H, W, L), src_bbox
    (S, H, W); tar_lbl (F, H, W, L), tar_bbox (F, H, W); numpy arrays or
    tensors, moved to `device`, where `mods` must live. Returns
    (F, H, W, 3) f32 reconstructions on `device`.
    """
    dev = resolve_device(device)
    if mods.device != dev:
        raise ValueError(f"modules live on {mods.device}, inputs go to {dev}")
    args = [torch.as_tensor(x, device=dev)
            for x in (src_img, src_lbl, src_bbox, tar_lbl, tar_bbox)]
    src_pack = encode_sources(mods, *args[:3])
    return decode_with_sources(mods, src_pack, *args[3:],
                               use_kernels=use_kernels)
