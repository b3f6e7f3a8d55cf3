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
taken here. Both tiers run K2 inside `fuse_clip`. Two opt-ins of the bf16
tail, both off by default as in the JAX package: `TSNET_FUSE_PAIR_KERNEL=1`
runs FuseNet's per-pair block through K6 (`nn.fusenet.fuse_clip`), and
`fused_blocks=True` runs the decoder's ResNet blocks through K7 (the JAX
package's `decoder_apply_fast(use_pallas_blocks=True)`).

Both entry points decode through `decode`: the phase-decomposed decoder
(`nn.decoder.decoder_apply_fast`), as the JAX package does, in every
tier. `cfg.ring_pad` runs the generator's reflect-pad convs without the
padded tensors (`ops.reflectconv`), off by default as in the JAX package.

`tsnet_forward` is the generator forward of training (counterpart of the
JAX package's `tsnet_forward(train=True)`): per-sample sources, the
transformation branch through `transformation_warp_sources` (K3-flow
forward, K4 backward), the image-space warp loss, `fuse_train` (K2) and
the align loss, all differentiable.

The pose variant (`use_fg_mask`, `use_face_d`): `composite_foreground`
paints the columns outside the middle half with the mean colour, on the
warped sources before the warp loss and on every reconstruction;
`crop_faces` cuts the face of each sample out of its label map's extent,
on the device with no host sync, for the face discriminator netDF.
"""

from __future__ import annotations

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..configs import TSNetConfig
from ..device import resolve_device
from ..losses.image import cosine_align_loss, l1_loss, renorm_to_reference
from ..nn import (Decoder, Encoder, FuseNet, PatchDiscriminator,
                  decoder_apply_fast, fuse_clip, fuse_train)
from ..nn.blocks import Conv2d
from ..ops.norms import l2_normalize
from ..ops.resize import resize_nearest, sample_separable
from ..ops.similarity import (transformation_warp_clip,
                              transformation_warp_clip_mean,
                              transformation_warp_sources)
from ..ops.warp import patch_warp
from ..utils.profiling import setup_time, span

GEN_SUBNETS = ("img_enc", "lbl_enc", "fuse_net", "dec")


def disc_subnets(cfg: TSNetConfig) -> tuple[str, ...]:
    """The discriminators a train state of `cfg` holds."""
    return ("netD", "netDF") if cfg.use_face_d else ("netD",)


class TSNetModules(nn.Module):
    """The generator subnets of one config, initialised from `seed`.

    Submodule and parameter names follow the JAX package's param trees
    (`img_enc`, `lbl_enc`, `dec`, `fuse_net`; `conv_in`, `down{i}`,
    `block{j}.conv{1,2}`, `map_conv`, `up{i}`, `conv_out`, `conv`; the
    discriminator `netD.stage{i}`), so `compat.flax_params` maps one onto
    the other by name.

    `train=False` (inference) builds the generator only, with gradients
    off. `train=True` also builds the PatchGAN discriminator `netD`
    (initialised from `seed + 1`) and, with `cfg.use_face_d`, the face
    discriminator `netDF` on 3-channel face crops (initialised from
    `seed + 3`; `seed + 2` is the train state's random VGG19), and keeps
    gradients on. Construction counts toward
    `utils.profiling.SETUP_S["modules"]`.

    Every conv of the encoders, FuseNet, the decoder and the
    discriminators runs its backward at `cfg.bwd_precision`
    (`ops.dpconv`). With `cfg.remat`, `run` recomputes the activations
    of the subnets the JAX package rematerializes (the encoders, the
    decoder, netD, netDF) in the backward pass instead of keeping them.
    """

    @setup_time("modules")
    def __init__(self, cfg: TSNetConfig, device="cuda", seed: int = 0,
                 train: bool = False):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        dt = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
              else torch.float32)
        self.dtype = dt
        prec = cfg.precision
        trunk_prec = "default" if cfg.fast_trunk else prec
        bwd = cfg.bwd_precision
        common = dict(ngf=cfg.ngf, n_downsampling=cfg.n_downsampling,
                      bwd_precision=bwd, ring_pad=cfg.ring_pad)
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
                                dtype=tail_dt, precision=tail_prec,
                                bwd_precision=bwd, ring_pad=cfg.ring_pad)
        self.init_generator_params(seed)
        if train:
            self.netD = PatchDiscriminator(3 + cfg.label_nc, ndf=cfg.ndf,
                                           n_layers=cfg.d_n_layers, dtype=dt,
                                           precision=prec, bwd_precision=bwd)
            self.netD.reset_parameters(torch.Generator().manual_seed(seed + 1))
            if cfg.use_face_d:
                self.netDF = PatchDiscriminator(
                    3, ndf=cfg.ndf, n_layers=cfg.d_n_layers, dtype=dt,
                    precision=prec, bwd_precision=bwd)
                self.netDF.reset_parameters(
                    torch.Generator().manual_seed(seed + 3))
        self.requires_grad_(train)
        self.to(dev)
        self.device = dev

    def run(self, subnet: nn.Module, *args):
        """`subnet(*args)`, under `torch.utils.checkpoint` with
        `cfg.remat` while autograd records."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(subnet, *args, use_reentrant=False)
        return subnet(*args)

    def init_generator_params(self, seed: int) -> None:
        """normal(0, 0.02) kernels, zero biases (the JAX package's init
        distribution), drawn from one CPU `torch.Generator` in module
        order, so a seed gives the same weights on every device. The
        numbers differ from `jax.random`'s; tests carry weights across
        with `compat.flax_params`."""
        gen = torch.Generator().manual_seed(seed)
        for sub in (self.img_enc, self.lbl_enc, self.dec, self.fuse_net):
            for mod in sub.modules():
                if isinstance(mod, Conv2d):
                    mod.reset_parameters(gen)


def get_face_bbox(lbl: torch.Tensor):
    """The face crop box of each pose label map lbl (B, H, W, L): its
    centre (yc, xc) and side, three (B,) int32 tensors.

    The reference's rule with static shapes: the extent of the face class
    (channel -1), else of the head classes (channels 1-4), else a fixed
    box; centre at the extent's middle column and 2/5 down its rows, side
    2.5 times its width within [32, W], and the box held inside the
    image. Masked min/max and `torch.where` instead of the reference's
    `.nonzero()`, `.item()` and branches, so the box stays on the device
    and the host never waits for it. Integer division floors, as `//`
    does in the JAX package."""
    _, h, w, _ = lbl.shape
    dev = lbl.device
    face = lbl[..., -1] > 0
    head = (lbl[..., 1] + lbl[..., 2] + lbl[..., 3] + lbl[..., 4]) > 0
    rows = torch.arange(h, dtype=torch.int32, device=dev)[None, :, None]
    cols = torch.arange(w, dtype=torch.int32, device=dev)[None, None, :]
    big = 1 << 20

    def div(a, n):
        return torch.div(a, n, rounding_mode="floor")

    def centre(mask):
        ys = torch.where(mask, rows, big).amin(dim=(1, 2))
        ye = torch.where(mask, rows, -big).amax(dim=(1, 2))
        xs = torch.where(mask, cols, big).amin(dim=(1, 2))
        xe = torch.where(mask, cols, -big).amax(dim=(1, 2))
        xc = div(xs + xe, 2)
        yc = div(ys * 3 + ye * 2, 5)
        ln = div((xe - xs) * 5, 2).clamp(32, None).clamp(None, w)
        half = div(ln, 2)
        yc = torch.maximum(half, torch.minimum(h - 1 - half, yc))
        xc = torch.maximum(half, torch.minimum(w - 1 - half, xc))
        return yc, xc, ln

    has_face = face.any(dim=2).any(dim=1)
    has_head = head.any(dim=2).any(dim=1)
    default = (h // 4, w // 2, h // 32 * 8)
    return tuple(torch.where(has_face, f, torch.where(has_head, hd, d))
                 for f, hd, d in zip(centre(face), centre(head), default))


def crop_faces(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The face of each image (B, H, W, 3), boxed by `get_face_bbox` of
    its label map, resized to (H//32*8)² with align_corners=True bilinear
    sampling -> (B, H//32*8, H//32*8, 3) f32. The reference crops rows
    [c - side//2, c + side//2) and interpolates; here the crop's sample
    positions are taken straight from the image (`sample_separable`),
    the same arithmetic. Differentiable in the images; makes no host
    sync."""
    _, h, _, _ = images.shape
    face_size = h // 32 * 8
    yc, xc, ln = get_face_bbox(labels)
    half = torch.div(ln, 2, rounding_mode="floor")
    span = (2 * half).float() - 1.0
    t = (torch.arange(face_size, dtype=torch.float32, device=images.device)
         / (face_size - 1))[None, :]
    ys = (yc - half).float()[:, None] + t * span[:, None]
    xs = (xc - half).float()[:, None] + t * span[:, None]
    return sample_separable(images.float(), ys, xs)


def composite_foreground(img: torch.Tensor, cfg: TSNetConfig) -> torch.Tensor:
    """The pose variant's fixed foreground: columns [W/4, 3W/4) of img
    (..., H, W, 3) kept, the others painted with the model-space mean
    colour -img_mean/255 exactly."""
    w = img.shape[-2]
    cols = torch.arange(w, device=img.device)
    fore = ((cols >= w // 4) & (cols < 3 * w // 4)).to(img.dtype)[:, None]
    bg = torch.as_tensor(-cfg.img_mean_array() / 255.0, dtype=img.dtype,
                         device=img.device)
    return img * fore + bg * (1.0 - fore)


def tsnet_forward(mods: TSNetModules, src_img, src_lbl, src_bbox, tar_lbl,
                  tar_bbox, tar_img=None, train: bool = False,
                  use_kernels: bool = True, return_flow: bool = False) -> dict:
    """One generator forward over a batch, each sample with its own S
    sources, differentiable in the generator's parameters.

    src_img (B, S, H, W, 3) model space, src_lbl (B, S, H, W, L),
    src_bbox (B, S, H, W); tar_lbl (B, H, W, L), tar_bbox (B, H, W);
    tar_img (B, H, W, 3), needed with `train`. Tensors on the modules'
    device. Returns a dict with `rec_img` (B, H, W, 3) f32, `prop_fea`
    and `syn_fea`; with `train`, also `warp_imgs` (B, S, H, W, 3),
    `loss_warp` (10 x the sum over sources of the L1 of each renormalised
    patch-warped source image against tar_img) and, with the config's
    `use_align_loss`, `loss_align`; with `return_flow`, `flows`
    (B, S, h, w, 2). `use_kernels=False` runs every kernel's plain version.
    """
    cfg = mods.cfg
    dt = mods.dtype
    b, s, hh, ww, _ = src_img.shape
    enc_in = torch.cat([src_img, src_lbl], dim=-1).to(dt)
    src_img_fea = mods.run(mods.img_enc,
                           enc_in.reshape((b * s,) + enc_in.shape[2:]),
                           use_kernels)
    h, w, c = src_img_fea.shape[1:]
    src_img_fea = src_img_fea.reshape(b, s, h, w, c)
    tar_lbl_fea = mods.run(mods.lbl_enc, tar_lbl.to(dt),
                           use_kernels)                      # (B, h, w, C)

    tar_fea_n = l2_normalize(tar_lbl_fea.float())
    tar_mask = resize_nearest(tar_bbox[..., None].float(), (h, w))[..., 0]
    src_fea_n = l2_normalize(src_img_fea.float())
    src_mask = resize_nearest(src_bbox.reshape(b * s, hh, ww, 1).float(),
                              (h, w)).reshape(b, s, h, w)
    warped_fea, flows = transformation_warp_sources(
        src_img_fea.float(), tar_fea_n, src_fea_n, tar_mask, src_mask,
        temp=cfg.softmax_temp, use_kernels=use_kernels,
        fast_warp=cfg.fast_tail, bwd_fast3=cfg.precision != "highest")

    out = {}
    if return_flow:
        out["flows"] = flows
    if train:
        if tar_img is None:
            raise ValueError("tsnet_forward(train=True) needs tar_img")
        ref = tar_img.float()
        warp_imgs = torch.stack([
            renorm_to_reference(patch_warp(src_img[:, i].float(),
                                           flows[:, i].float()), ref)
            for i in range(s)], dim=1)                        # (B, S, H, W, 3)
        if cfg.use_fg_mask:
            warp_imgs = composite_foreground(warp_imgs, cfg)
        out["warp_imgs"] = warp_imgs
        out["loss_warp"] = 10.0 * sum(l1_loss(warp_imgs[:, i], ref)
                                      for i in range(s))

    prop_fea = warped_fea.mean(dim=1).to(dt)                 # (B, h, w, C)
    syn_fea = fuse_train(mods.fuse_net, src_img_fea.to(dt), tar_lbl_fea,
                         use_kernels=use_kernels)
    if train and cfg.use_align_loss:
        out["loss_align"] = cosine_align_loss(prop_fea, syn_fea)
    rec_img = mods.run(lambda pf, sf: decode(mods, pf, sf, use_kernels),
                       prop_fea, syn_fea).float()
    if cfg.use_fg_mask:
        rec_img = composite_foreground(rec_img, cfg)
    out["rec_img"] = rec_img
    out["prop_fea"] = prop_fea
    out["syn_fea"] = syn_fea
    return out


def encode_sources(mods: TSNetModules, src_img: torch.Tensor,
                   src_lbl: torch.Tensor, src_bbox: torch.Tensor,
                   use_kernels: bool = True) -> dict:
    """Encode the S reference frames once: the source pack reused by
    every chunk of driving frames. src_img (S, H, W, 3), src_lbl
    (S, H, W, L), src_bbox (S, H, W), on the modules' device.
    `use_kernels=False` keeps the encoder's norms on the composition."""
    with torch.inference_mode(), span("tsnet.encode_sources", mods.device):
        enc_in = torch.cat([src_img, src_lbl], dim=-1).to(mods.dtype)
        src_fea = mods.img_enc(enc_in, use_kernels)
        hw = src_fea.shape[1:3]
        return {
            "fea": src_fea,
            "fea_n": l2_normalize(src_fea.float()),
            "mask": resize_nearest(src_bbox[..., None].float(), hw)[..., 0],
        }


def label_features(mods: TSNetModules, tar_lbl: torch.Tensor,
                   tar_bbox: torch.Tensor, use_kernels: bool = True):
    """The label encoder's stage of `decode_with_sources`: the driving
    frames' label features (F, h, w, C) in the encoders' dtype, their
    f32 L2-normalised form, and the bbox masks at (h, w)."""
    with span("tsnet.lbl_enc", mods.device):
        tar_fea = mods.lbl_enc(tar_lbl.to(mods.dtype), use_kernels)
        h, w = tar_fea.shape[1:3]
        return (tar_fea, l2_normalize(tar_fea.float()),
                resize_nearest(tar_bbox[..., None].float(), (h, w))[..., 0])


def propagate(mods: TSNetModules, src_pack: dict, tar_fea_n: torch.Tensor,
              tar_mask: torch.Tensor,
              use_kernels: bool = True) -> torch.Tensor:
    """The transformation stage of `decode_with_sources`: the source
    features warped to each driving frame and averaged over the sources,
    (F, h, w, C) in the decoder's dtype."""
    with span("tsnet.warp", mods.device):
        src_fea = src_pack["fea"].float()
        temp = mods.cfg.softmax_temp
        if mods.dec.dtype == torch.bfloat16:
            # fast tail: K1 folds the mean over sources in and writes bf16
            return transformation_warp_clip_mean(
                src_fea, src_pack["fea_n"], src_pack["mask"], tar_fea_n,
                tar_mask, temp=temp, out_dtype=torch.bfloat16,
                use_kernels=use_kernels)
        warped = transformation_warp_clip(
            src_fea, src_pack["fea_n"], src_pack["mask"], tar_fea_n,
            tar_mask, temp=temp, use_kernels=use_kernels)
        return warped.mean(dim=0).to(mods.dtype)


def decode(mods: TSNetModules, prop_fea: torch.Tensor, syn_fea: torch.Tensor,
           use_kernels: bool = True, fused_blocks: bool = False
           ) -> torch.Tensor:
    """The decoder stage of both entry points: (B, h, w, C) x 2 -> the
    tanh image (B, H, W, 3) in the decoder's dtype, through the
    phase-decomposed decoder (`nn.decoder.decoder_apply_fast`, as the JAX
    package runs it) with the config's `ring_pad` and `bwd_precision`, as
    the decoder was built. `fused_blocks` runs a bf16 decoder's ResNet
    blocks through K7."""
    return decoder_apply_fast(mods.dec, prop_fea, syn_fea, return_fea=False,
                              fused_blocks=fused_blocks,
                              use_kernels=use_kernels)[0]


def decode_with_sources(mods: TSNetModules, src_pack: dict,
                        tar_lbl: torch.Tensor, tar_bbox: torch.Tensor,
                        use_kernels: bool = True,
                        fused_blocks: bool = False) -> torch.Tensor:
    """Run F driving frames against a source pack -> (F, H, W, 3) f32:
    `label_features`, `propagate`, `fuse_clip` and `decode`.

    `use_kernels=False` runs every kernel's plain PyTorch version instead
    (the reference the kernels are held against, as `use_pallas=False`
    is in the JAX package); on CPU tensors the two are the same path.
    `fused_blocks=True` runs a bf16 decoder's ResNet blocks through K7
    (the JAX package hard-codes False here).

    Under a profiler each stage is a span (`utils.profiling.span`):
    `tsnet.lbl_enc`, `tsnet.warp`, `tsnet.fuse`, `tsnet.decode` (with the
    cast to f32 and the foreground composite), as `encode_sources` is
    `tsnet.encode_sources`.
    """
    with torch.inference_mode():
        tar_fea, tar_fea_n, tar_mask = label_features(
            mods, tar_lbl, tar_bbox, use_kernels)
        prop_fea = propagate(mods, src_pack, tar_fea_n, tar_mask,
                             use_kernels=use_kernels)
        with span("tsnet.fuse", mods.device):
            syn_fea = fuse_clip(mods.fuse_net, src_pack["fea"].float(),
                                tar_fea.float(), use_kernels=use_kernels)
        with span("tsnet.decode", mods.device):
            rec = decode(mods, prop_fea, syn_fea, use_kernels,
                         fused_blocks=fused_blocks).float()
            if mods.cfg.use_fg_mask:
                rec = composite_foreground(rec, mods.cfg)
        return rec


def tsnet_forward_clip(mods: TSNetModules, src_img, src_lbl, src_bbox,
                       tar_lbl, tar_bbox, use_kernels: bool = True,
                       device="cuda", fused_blocks: bool = False
                       ) -> torch.Tensor:
    """Whole-clip inference: encode the S references once, batch frames.

    src_img (S, H, W, 3) model space, src_lbl (S, H, W, L), src_bbox
    (S, H, W); tar_lbl (F, H, W, L), tar_bbox (F, H, W); numpy arrays or
    tensors, moved to `device`, where `mods` must live. Returns
    (F, H, W, 3) f32 reconstructions on `device`. `fused_blocks` as in
    `decode_with_sources`.
    """
    dev = resolve_device(device)
    if mods.device != dev:
        raise ValueError(f"modules live on {mods.device}, inputs go to {dev}")
    args = [torch.as_tensor(x, device=dev)
            for x in (src_img, src_lbl, src_bbox, tar_lbl, tar_bbox)]
    src_pack = encode_sources(mods, *args[:3], use_kernels=use_kernels)
    return decode_with_sources(mods, src_pack, *args[3:],
                               use_kernels=use_kernels,
                               fused_blocks=fused_blocks)
