"""Plain PyTorch reference of TS-Net: the generator, the PatchGAN
discriminators, VGG19, the losses, the face crop and the Adam step.

Written from the model's description (the torch original's layers, in
NCHW with `F.conv2d`, `F.instance_norm`, `F.grid_sample` and
`F.interpolate`), with no kernel, no split or phase form and no
batching trick: FuseNet runs on every (source, frame) pair and the
results are averaged, the decoder upsamples and then convolves. It
imports nothing of the measured package. Parameters are a flat dict of
tensors named as the port's `state_dict()` names them (`img_enc.block0.
conv1.weight`, `netD.stage0.bias`, `vgg.conv3.weight`, ...).

`Precision` says where each part computes:

- `trunk`: the encoders' convolutions, "fp32" or "bf16pass" (bf16
  operands, the sum rounded to bf16 once, back to fp32, bias in fp32),
  or "fp8pass" (the same with the operands rounded to fp8 e4m3 first,
  each tensor scaled to its largest value);
- `tail`: FuseNet and the decoder, "fp32", "bf16" (bf16 operands and
  activations, instance-norm statistics in fp32) or "fp8" (bf16 with
  the convolutions' operands rounded to fp8 e4m3 first);
- `sim`: the dtype of the similarity logits, the softmax and the flow;
- `tf32`: whether fp32 convolutions and matmuls may run in TF32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F

VGG_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512,
                512)
VGG_TAPS = (0, 2, 4, 8, 12)
VGG_POOL_AFTER = (1, 3, 7, 11)
VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


@dataclasses.dataclass(frozen=True)
class Precision:
    trunk: str = "fp32"
    tail: str = "fp32"
    sim: torch.dtype = torch.float32
    tf32: bool = False

    @property
    def tail_dtype(self) -> torch.dtype:
        return torch.float32 if self.tail == "fp32" else torch.bfloat16


@contextlib.contextmanager
def tf32(enabled: bool):
    """cuBLAS and cuDNN TF32 switched to `enabled` inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ---------------------------------------------------------------- layers

def fp8(x):
    """x rounded to fp8 e4m3, scaled so that its largest value is the
    format's largest, and back in x's dtype."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / 448.0
    return ((x.float() / scale).to(torch.float8_e4m3fn).float()
            * scale).to(x.dtype)


def conv(x, p, name, mode="fp32", stride=1, pad=0, reflect=0):
    """Conv `name` of p on x (NCHW); `reflect` pixels of reflection
    padding first, `pad` of zero padding inside the conv."""
    w, b = p[name + ".weight"], p.get(name + ".bias")
    if reflect:
        x = F.pad(x, (reflect,) * 4, mode="reflect")
    if mode in ("fp8pass", "fp8"):
        x, w = fp8(x), fp8(w)
        mode = "bf16pass" if mode == "fp8pass" else "bf16"
    if mode == "bf16pass":
        y = F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16), None,
                     stride, pad).float()
        return y if b is None else y + b.float()[None, :, None, None]
    if mode == "bf16":
        return F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16),
                        None if b is None else b.to(torch.bfloat16), stride,
                        pad)
    return F.conv2d(x.float(), w, b, stride, pad)


def inorm(x):
    """Affine-free instance norm, statistics in fp32, out in x's dtype."""
    return F.instance_norm(x.float(), eps=1e-5).to(x.dtype)


def resblock(x, p, name, mode):
    h = torch.relu(inorm(conv(x, p, name + ".conv1", mode, reflect=1)))
    return x + inorm(conv(h, p, name + ".conv2", mode, reflect=1))


def coord_channels(x):
    """x (B, C, H, W) with x, y in [-1, 1] and their radius appended."""
    b, _, h, w = x.shape
    ys = torch.linspace(-1.0, 1.0, h, device=x.device, dtype=x.dtype)
    xs = torch.linspace(-1.0, 1.0, w, device=x.device, dtype=x.dtype)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    rr = torch.sqrt(xx * xx + yy * yy)
    extra = torch.stack([xx, yy, rr])[None].expand(b, 3, h, w)
    return torch.cat([x, extra], dim=1)


def encoder(x, p, name, cfg, n_blocks, mode):
    """(B, C, H, W) -> (B, ngf 2^n, H / 2^n, W / 2^n), fp32."""
    if cfg["addcoords"]:
        x = coord_channels(x)
    x = torch.relu(inorm(conv(x, p, name + ".conv_in", mode, reflect=3)))
    for i in range(cfg["n_downsampling"]):
        x = torch.relu(inorm(conv(x, p, f"{name}.down{i}", mode, stride=2,
                                  pad=1)))
    for j in range(n_blocks):
        x = resblock(x, p, f"{name}.block{j}", mode)
    return x.float()


def fusenet(src_fea, tar_fea, p, mode):
    """FuseNet on every pair: src_fea (B, S, C, h, w), tar_fea (B, F, C, h,
    w) -> mean over the S sources, (B, F, C, h, w) fp32."""
    b, s, c, h, w = src_fea.shape
    f = tar_fea.shape[1]
    dt = torch.float32 if mode == "fp32" else torch.bfloat16
    x = torch.cat([src_fea[:, :, None].expand(b, s, f, c, h, w),
                   tar_fea[:, None].expand(b, s, f, c, h, w)], dim=3)
    x = x.reshape(b * s * f, 2 * c, h, w).to(dt)
    x = resblock(x, p, "fuse_net.block0", mode)
    y = conv(x, p, "fuse_net.conv", mode).float()
    return y.reshape(b, s, f, c, h, w).mean(dim=1)


def decoder(prop, syn, p, cfg, mode):
    """(N, C, h, w) x 2 -> (N, 3, H, W) tanh image, fp32."""
    dt = torch.float32 if mode == "fp32" else torch.bfloat16
    x = conv(torch.cat([prop, syn], dim=1).to(dt), p, "dec.map_conv", mode)
    for j in range(cfg["dec_n_blocks"]):
        x = resblock(x, p, f"dec.block{j}", mode)
    for i in range(cfg["n_downsampling"]):
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=False)
        x = torch.relu(inorm(conv(x, p, f"dec.up{i}", mode, reflect=1)))
    return torch.tanh(conv(x, p, "dec.conv_out", mode, reflect=3)).float()


def l2n(x, dim=1):
    return x / torch.clamp(x.norm(dim=dim, keepdim=True), min=1e-12)


def nearest(mask, hw):
    """(N, H, W) mask -> (N, h, w), torch's nearest rule."""
    return F.interpolate(mask[:, None].float(), size=hw, mode="nearest")[:, 0]


def flow_and_warp(tar_n, tar_m, src_n, src_m, src_fea, temp, sim):
    """One source against N targets: tar_n (N, C, h, w) normalised, tar_m
    (N, h, w); src_n (N, C, h, w), src_m (N, h, w), src_fea (N, C, h, w),
    each per target (views may repeat one source). Returns the warped
    source features (N, C, h, w) fp32 and the flow (N, h, w, 2) fp32."""
    n, c, h, w = tar_n.shape
    t = h * w
    q = tar_n.reshape(n, c, t).transpose(1, 2).to(sim)          # (N, T, C)
    k = src_n.reshape(n, c, t).to(sim)                          # (N, C, T)
    logits = torch.bmm(q, k)                                    # (N, T, T)
    mt = tar_m.reshape(n, t, 1).to(sim)
    ms = src_m.reshape(n, 1, t).to(sim)
    z = temp * (logits * (mt * ms + (1.0 - mt) * (1.0 - ms)))
    attn = torch.softmax(z, dim=-1)
    ys = torch.linspace(-1.0, 1.0, h, device=tar_n.device)
    xs = torch.linspace(-1.0, 1.0, w, device=tar_n.device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([xx, yy], dim=-1).reshape(t, 2).to(sim)
    flow = torch.matmul(attn, grid).float().reshape(n, h, w, 2)
    warped = F.grid_sample(src_fea, flow, mode="bilinear",
                           padding_mode="zeros", align_corners=False)
    return warped, flow


def composite_foreground(img, img_mean):
    """Columns outside [W/4, 3W/4) of img (N, 3, H, W) painted with the
    model-space mean colour."""
    w = img.shape[-1]
    cols = torch.arange(w, device=img.device)
    fore = ((cols >= w // 4) & (cols < 3 * w // 4)).to(img.dtype)
    bg = torch.tensor([-m / 255.0 for m in img_mean], dtype=img.dtype,
                      device=img.device)[None, :, None, None]
    return img * fore + bg * (1.0 - fore)


def nchw(x):
    return x.permute(0, 3, 1, 2)


# ---------------------------------------------------------------- clip

@torch.no_grad()
def generator_clip(p, cfg, src_img, src_lbl, src_bbox, tar_lbl, tar_bbox,
                   prec: Precision, block: int = 64):
    """Render F driving frames from S sources.

    src_img (S, H, W, 3) model space, src_lbl (S, H, W, L) one-hot,
    src_bbox (S, H, W); tar_lbl (F, H, W, L), tar_bbox (F, H, W); cfg
    the configuration's numbers. Returns (F, 3, H, W) fp32 frames,
    computed `block` frames at a time."""
    with tf32(prec.tf32):
        src_fea = encoder(nchw(torch.cat([src_img, src_lbl], -1)).float(),
                          p, "img_enc", cfg, cfg["enc_n_blocks"], prec.trunk)
        h, w = src_fea.shape[-2:]
        src_n = l2n(src_fea)
        src_m = nearest(src_bbox, (h, w))
        tail_dt = prec.tail_dtype
        outs = []
        for lo in range(0, tar_lbl.shape[0], block):
            lbl = nchw(tar_lbl[lo:lo + block]).float()
            f = lbl.shape[0]
            tar_fea = encoder(lbl, p, "lbl_enc", cfg, 0, prec.trunk)
            tar_n = l2n(tar_fea)
            tar_m = nearest(tar_bbox[lo:lo + block], (h, w))
            acc = 0.0
            for s in range(src_fea.shape[0]):
                warped, _ = flow_and_warp(
                    tar_n, tar_m, src_n[s:s + 1].expand(f, -1, -1, -1),
                    src_m[s:s + 1].expand(f, -1, -1), src_fea[s:s + 1].expand(
                        f, -1, -1, -1), cfg["softmax_temp"], prec.sim)
                acc = acc + warped
            prop = (acc / src_fea.shape[0]).to(tail_dt)
            syn = fusenet(src_fea.to(tail_dt).float()[None],
                          tar_fea.to(tail_dt).float()[None], p,
                          prec.tail)[0].to(tail_dt)
            rec = decoder(prop, syn, p, cfg, prec.tail)
            if cfg["use_fg_mask"]:
                rec = composite_foreground(rec, cfg["img_mean"])
            outs.append(rec)
        return torch.cat(outs)


# ---------------------------------------------------------------- training

def patchgan(x, p, name, n_layers):
    """The stages' activations, the last one the patch logits."""
    feats = []
    for i in range(n_layers + 1):
        x = conv(x, p, f"{name}.stage{i}", stride=2 if i < n_layers else 1,
                 pad=1)
        if i > 0:
            x = F.instance_norm(x, eps=1e-5)
        x = F.leaky_relu(x, 0.2)
        feats.append(x)
    feats.append(conv(x, p, f"{name}.stage{n_layers + 1}", pad=1))
    return feats


def vgg19(x, p):
    taps = []
    for i in range(len(VGG_CHANNELS)):
        x = torch.relu(conv(x, p, f"vgg.conv{i}", pad=1))
        if i in VGG_TAPS:
            taps.append(x)
        if i in VGG_POOL_AFTER:
            x = F.max_pool2d(x, 2)
    return taps


def lsgan(pred, real: bool):
    return (pred - (1.0 if real else 0.0)).square().mean()


def feature_matching(fake, real, weight):
    return sum(weight * (f - r).abs().mean() for f, r in
               zip(fake[:-1], real[:-1]))


def vgg_loss(p, fake, real):
    with torch.no_grad():
        real_taps = vgg19(real, p)
    return sum(wt * (f - r).abs().mean() for wt, f, r in
               zip(VGG_WEIGHTS, vgg19(fake, p), real_taps))


def gradient_loss(fake, real):
    def d(x, dim):
        return (x.narrow(dim, 0, x.shape[dim] - 1)
                - x.narrow(dim, 1, x.shape[dim] - 1)).abs()
    return sum((d(real, dim) - d(fake, dim)).abs().mean() for dim in (2, 3))


def renorm_to(img, ref):
    """img (N, 3, H, W) shifted and scaled per (sample, channel) to ref's
    mean and unbiased std."""
    def stats(x):
        flat = x.flatten(2)
        return (flat.mean(-1)[..., None, None],
                flat.std(-1, unbiased=True)[..., None, None])
    gm, gs = stats(img)
    rm, rs = stats(ref)
    return (img - gm) / gs * rs + rm


def face_box(lbl):
    """The face crop box of each pose label map lbl (B, L, H, W): centre
    row, centre column and side (B,) int64: the extent of the face class
    (the last channel), else of the head classes (1-4), else a fixed box;
    centre at the extent's middle column and 2/5 down its rows, side 2.5
    times its width within [32, W], held inside the image."""
    b, _, h, w = lbl.shape
    out = []
    for i in range(b):
        face = lbl[i, -1] > 0
        head = lbl[i, 1:5].sum(0) > 0
        mask = face if bool(face.any()) else head if bool(head.any()) else None
        if mask is None:
            out.append((h // 4, w // 2, h // 32 * 8))
            continue
        rows = torch.nonzero(mask.any(1))[:, 0]
        cols = torch.nonzero(mask.any(0))[:, 0]
        ys, ye = int(rows.min()), int(rows.max())
        xs, xe = int(cols.min()), int(cols.max())
        xc = (xs + xe) // 2
        yc = (ys * 3 + ye * 2) // 5
        ln = min(max((xe - xs) * 5 // 2, 32), w)
        half = ln // 2
        yc = max(half, min(h - 1 - half, yc))
        xc = max(half, min(w - 1 - half, xc))
        out.append((yc, xc, ln))
    return out


def crop_faces(img, lbl):
    """The face of each image (B, 3, H, W) from its label map's box,
    resampled bilinearly to (H/32*8)^2 with the box's end pixels on the
    crop's corners."""
    b, _, h, w = img.shape
    size = h // 32 * 8
    t = torch.arange(size, dtype=torch.float32, device=img.device) / (size - 1)
    grids = []
    for yc, xc, ln in face_box(lbl):
        half = ln // 2
        ys = (yc - half) + t * (2 * half - 1)
        xs = (xc - half) + t * (2 * half - 1)
        gy = 2.0 * ys / (h - 1) - 1.0
        gx = 2.0 * xs / (w - 1) - 1.0
        yy, xx = torch.meshgrid(gy, gx, indexing="ij")
        grids.append(torch.stack([xx, yy], dim=-1))
    return F.grid_sample(img, torch.stack(grids), mode="bilinear",
                         padding_mode="border", align_corners=True)


def generator_train(p, cfg, batch):
    """The generator forward of training on a batch (NHWC tensors as the
    harness makes them): the reconstruction (B, 3, H, W) and the warp and
    align losses."""
    src_img, src_lbl, src_bbox = (batch["src_img"], batch["src_lbl"],
                                  batch["src_bbox"])
    b, s, hh, ww, _ = src_img.shape
    x = torch.cat([src_img, src_lbl], -1).reshape((b * s,) + src_img.shape[2:
                                                                          -1]
                                                  + (-1,))
    src_fea = encoder(nchw(x).float(), p, "img_enc", cfg, cfg["enc_n_blocks"],
                      "fp32")
    c, h, w = src_fea.shape[1:]
    tar_fea = encoder(nchw(batch["tar_lbl"]).float(), p, "lbl_enc", cfg, 0,
                      "fp32")
    tar_n = l2n(tar_fea)
    tar_m = nearest(batch["tar_bbox"], (h, w))
    src_fea = src_fea.reshape(b, s, c, h, w)
    src_n = l2n(src_fea, dim=2)
    src_m = nearest(src_bbox.reshape(b * s, hh, ww), (h, w)).reshape(b, s, h,
                                                                     w)
    tar_img = nchw(batch["tar_img"]).float()
    warped, warp_loss = [], 0.0
    p_img = hh // h
    for i in range(s):
        wf, flow = flow_and_warp(tar_n, tar_m, src_n[:, i], src_m[:, i],
                                 src_fea[:, i], cfg["softmax_temp"],
                                 torch.float32)
        warped.append(wf)
        # the source image cut into p x p patches, the patch grid warped
        img = nchw(src_img[:, i]).float()
        patches = F.pixel_unshuffle(img, p_img)
        wimg = F.pixel_shuffle(F.grid_sample(
            patches, flow, mode="bilinear", padding_mode="zeros",
            align_corners=False), p_img)
        wimg = renorm_to(wimg, tar_img)
        if cfg["use_fg_mask"]:
            wimg = composite_foreground(wimg, cfg["img_mean"])
        warp_loss = warp_loss + (wimg - tar_img).abs().mean()
    prop = torch.stack(warped, 1).mean(1)
    syn = fusenet(src_fea, tar_fea[:, None], p, "fp32")[:, 0]
    out = {"warp": 10.0 * warp_loss}
    if cfg["use_align_loss"]:
        cos = (prop * syn).sum(1) / torch.clamp(
            prop.norm(dim=1) * syn.norm(dim=1), min=1e-8)
        out["align"] = 1.0 - cos.mean()
    rec = decoder(prop, syn, p, cfg, "fp32")
    if cfg["use_fg_mask"]:
        rec = composite_foreground(rec, cfg["img_mean"])
    out["rec"] = rec
    return out


GEN_PREFIXES = ("img_enc.", "lbl_enc.", "fuse_net.", "dec.")


def train_step(p, adam, cfg, batch, lr, lambda_dec=1.0, d_lr_factor=0.5,
               betas=(0.5, 0.999), eps=1e-8):
    """One GAN step on p (a dict of leaf tensors, updated in place) and
    the Adam state `adam` (name -> (m, v, t), filled here). The D update
    on the detached reconstruction, then the G update against the
    updated discriminators. Returns the step's metrics (floats) and the
    gradients it applied (name -> tensor)."""
    n_layers = cfg["d_n_layers"]
    gen = [k for k in p if k.startswith(GEN_PREFIXES)]
    disc = [k for k in p if k.startswith(("netD.", "netDF."))]
    lbl = nchw(batch["tar_lbl"]).float()
    tar = nchw(batch["tar_img"]).float()
    for k in gen + disc:
        p[k].requires_grad_(True)
    out = generator_train(p, cfg, batch)
    rec = out["rec"]
    m = {}
    real_in = torch.cat([lbl, tar], 1)
    pf = patchgan(torch.cat([lbl, rec.detach()], 1), p, "netD", n_layers)
    pr = patchgan(real_in, p, "netD", n_layers)
    m["D_fake"], m["D_real"] = lsgan(pf[-1], False), lsgan(pr[-1], True)
    m["D"] = 0.5 * (m["D_fake"] + m["D_real"])
    d_total = m["D"]
    if cfg["use_face_d"]:
        fake_face, real_face = crop_faces(rec, lbl), crop_faces(tar, lbl)
        qf = patchgan(fake_face.detach(), p, "netDF", n_layers)
        qr = patchgan(real_face, p, "netDF", n_layers)
        m["DF_fake"], m["DF_real"] = lsgan(qf[-1], False), lsgan(qr[-1], True)
        m["DF"] = 0.5 * (m["DF_fake"] + m["DF_real"])
        d_total = d_total + m["DF"]
    grads = dict(zip(disc, torch.autograd.grad(d_total, [p[k] for k in disc],
                                               allow_unused=True)))
    lrs = {k: lr * d_lr_factor for k in disc}
    adam_update(p, adam, grads, lrs, betas, eps)
    for k in disc:
        p[k].requires_grad_(False)
    pf = patchgan(torch.cat([lbl, rec], 1), p, "netD", n_layers)
    with torch.no_grad():
        pr = patchgan(real_in, p, "netD", n_layers)
    m["G_GAN"] = lsgan(pf[-1], True)
    m["G_FML"] = feature_matching(pf, pr, cfg["lambda_fml"])
    m["G_VGG"] = cfg["lambda_vgg"] * vgg_loss(p, rec, tar)
    m["grad_G"] = cfg["lambda_grad"] * gradient_loss(rec, tar)
    m["warp"] = out["warp"]
    m["G"] = m["G_GAN"] + m["G_FML"] + m["G_VGG"]
    total = m["G"] + m["grad_G"] + m["warp"]
    if cfg["use_align_loss"]:
        m["align"] = out["align"]
        total = total + m["align"]
    if cfg["use_face_d"]:
        qf = patchgan(fake_face, p, "netDF", n_layers)
        with torch.no_grad():
            qr = patchgan(real_face, p, "netDF", n_layers)
        m["GF_GAN"] = lsgan(qf[-1], True)
        m["GF_FML"] = feature_matching(qf, qr, cfg["lambda_fml"])
        m["GF_VGG"] = cfg["lambda_vgg"] * vgg_loss(p, fake_face, real_face)
        m["GF"] = m["GF_GAN"] + m["GF_FML"] + m["GF_VGG"]
        total = total + m["GF"]
    g_grads = torch.autograd.grad(total, [p[k] for k in gen],
                                  allow_unused=True)
    grads.update(zip(gen, g_grads))
    adam_update(p, adam, {k: grads[k] for k in gen},
                {k: lr * (lambda_dec if k.startswith("dec.") else 1.0)
                 for k in gen}, betas, eps)
    for k in gen + disc:
        p[k].requires_grad_(False)
    metrics = {k: float(v.detach()) for k, v in m.items()}
    return metrics, {k: (g if g is not None else torch.zeros_like(p[k]))
                     for k, g in grads.items()}


@torch.no_grad()
def adam_update(p, adam, grads, lrs, betas, eps):
    """Adam with bias correction, as torch.optim.Adam computes it."""
    b1, b2 = betas
    for k, g in grads.items():
        g = torch.zeros_like(p[k]) if g is None else g
        m, v, t = adam.get(k, (torch.zeros_like(g), torch.zeros_like(g), 0))
        t += 1
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        adam[k] = (m, v, t)
        denom = (v.sqrt() / math.sqrt(1 - b2 ** t)) + eps
        p[k].sub_(lrs[k] / (1 - b1 ** t) * m / denom)
