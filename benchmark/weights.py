"""Seeded weights of one configuration, made on the device in one draw.

`shapes(cfg, train)` lists every parameter the configuration holds, by
the name the port's `state_dict()` gives it, from the configuration's
numbers alone. `make(cfg, seed, device, train)` fills them from one
`torch.Generator` on `device`: one normal draw for all kernels, scaled
per tensor (normal(0, 0.02) for the generator and the discriminators,
1/sqrt(fan_in) for VGG19), zero biases. The same dict goes to the port
(through `load_state_dict`) and to the reference.
"""

from __future__ import annotations

import math

import torch

from .reference.model import VGG_CHANNELS


def _conv(out, name, o, i, k, bias=True):
    out[name + ".weight"] = (o, i, k, k)
    if bias:
        out[name + ".bias"] = (o,)


def _encoder(out, name, cfg, in_ch, n_blocks):
    ngf, n = cfg["ngf"], cfg["n_downsampling"]
    _conv(out, name + ".conv_in", ngf, in_ch + 3 * bool(cfg["addcoords"]), 7)
    for i in range(n):
        _conv(out, f"{name}.down{i}", ngf * 2 ** (i + 1), ngf * 2 ** i, 3)
    for j in range(n_blocks):
        for c in (1, 2):
            _conv(out, f"{name}.block{j}.conv{c}", ngf * 2 ** n,
                  ngf * 2 ** n, 3)


def _patchgan(out, name, cfg, in_ch):
    ndf, n = cfg["ndf"], cfg["d_n_layers"]
    widths = [ndf] + [ndf * min(2 ** k, 8) for k in range(1, n + 1)]
    ch = in_ch
    for i, w in enumerate(widths):
        _conv(out, f"{name}.stage{i}", w, ch, 4)
        ch = w
    _conv(out, f"{name}.stage{n + 1}", 1, ch, 4)


def shapes(cfg: dict, train: bool) -> dict:
    """name -> shape of every parameter; with `train` also netD (netDF)
    and VGG19 (`vgg.` prefix)."""
    out: dict = {}
    ngf, n, lab = cfg["ngf"], cfg["n_downsampling"], cfg["label_nc"]
    feat = ngf * 2 ** n
    _encoder(out, "img_enc", cfg, 3 + lab, cfg["enc_n_blocks"])
    _encoder(out, "lbl_enc", cfg, lab, 0)
    _conv(out, "dec.map_conv", feat, 2 * feat, 1)
    for j in range(cfg["dec_n_blocks"]):
        for c in (1, 2):
            _conv(out, f"dec.block{j}.conv{c}", feat, feat, 3)
    for i in range(n):
        mult = 2 ** (n - i)
        _conv(out, f"dec.up{i}", ngf * mult // 2, ngf * mult, 3)
    _conv(out, "dec.conv_out", 3, ngf, 7)
    for c in (1, 2):
        _conv(out, f"fuse_net.block0.conv{c}", 2 * feat, 2 * feat, 3)
    _conv(out, "fuse_net.conv", feat, 2 * feat, 1)
    if train:
        _patchgan(out, "netD", cfg, 3 + lab)
        if cfg["use_face_d"]:
            _patchgan(out, "netDF", cfg, 3)
        ch = 3
        for i, o in enumerate(VGG_CHANNELS):
            _conv(out, f"vgg.conv{i}", o, ch, 3)
            ch = o
    return out


def make(cfg: dict, seed: int, device, train: bool) -> dict:
    """name -> fp32 tensor on `device`, drawn from `seed`."""
    sh = shapes(cfg, train)
    kernels = [k for k in sh if k.endswith(".weight")]
    total = sum(math.prod(sh[k]) for k in kernels)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k in sh:
        if k.endswith(".bias"):
            out[k] = torch.zeros(sh[k], device=device)
            continue
        size = math.prod(sh[k])
        std = (1.0 / math.sqrt(math.prod(sh[k][1:])) if k.startswith("vgg.")
               else 0.02)
        out[k] = flat[at:at + size].view(sh[k]).mul_(std)
        at += size
    return out
