"""Operations and bytes, from a configuration's shapes.

Model FLOPs count what the reference computes, the way
`torch.utils.flop_counter.FlopCounterMode` counts it: each conv
2·N·Cin·Cout·k²·Hout·Wout, its backward once more for the input's
gradient and once for the weight's where autograd takes them; each
matmul 2·m·n·k (the similarity logits 2·T·T'·C, the flow 2·T·T'·2 for
every target and source). FuseNet runs on every (source, target) pair,
as the model states it. Nothing is counted twice for a recomputation.

The kernel functions give one call's operations and bytes as its
algorithm needs them: every input read once, every output written once
(the arithmetic of `chip_smoke.py`'s bounds).
"""

from __future__ import annotations

# dense bf16 tensor-core rate and HBM bandwidth of one H100 SXM at 700 W
# (NVIDIA's data sheet); every share of a peak or roofline is against
# these two
PEAK_FLOP_PER_S = 989e12
PEAK_BYTES_PER_S = 3.35e12


def conv(n, cin, cout, k, hout, wout):
    return 2 * n * cin * cout * k * k * hout * wout


def encoder_convs(cfg, n, in_ch, n_blocks):
    """[(flops, first)] of an encoder's convs on n images; `first` marks
    the stem, whose input needs no gradient."""
    size, ngf, nd = cfg["image_size"], cfg["ngf"], cfg["n_downsampling"]
    out = [(conv(n, in_ch + 3 * bool(cfg["addcoords"]), ngf, 7, size, size),
            True)]
    for i in range(nd):
        s = size // 2 ** (i + 1)
        out.append((conv(n, ngf * 2 ** i, ngf * 2 ** (i + 1), 3, s, s), False))
    fs, feat = size // 2 ** nd, ngf * 2 ** nd
    out += [(conv(n, feat, feat, 3, fs, fs), False)] * (2 * n_blocks)
    return out


def fusenet_flops(cfg, pairs):
    fs = cfg["image_size"] // 2 ** cfg["n_downsampling"]
    feat = cfg["ngf"] * 2 ** cfg["n_downsampling"]
    return (2 * conv(pairs, 2 * feat, 2 * feat, 3, fs, fs)
            + conv(pairs, 2 * feat, feat, 1, fs, fs))


def decoder_flops(cfg, n):
    ngf, nd, size = cfg["ngf"], cfg["n_downsampling"], cfg["image_size"]
    fs, feat = size // 2 ** nd, ngf * 2 ** nd
    total = conv(n, 2 * feat, feat, 1, fs, fs)
    total += 2 * cfg["dec_n_blocks"] * conv(n, feat, feat, 3, fs, fs)
    for i in range(nd):
        mult = 2 ** (nd - i)
        s = fs * 2 ** (i + 1)
        total += conv(n, ngf * mult, ngf * mult // 2, 3, s, s)
    return total + conv(n, ngf, 3, 7, size, size)


def attention_flops(cfg, n):
    """Logits and flow of one source against n targets (forward)."""
    t = (cfg["image_size"] // 2 ** cfg["n_downsampling"]) ** 2
    c = cfg["ngf"] * 2 ** cfg["n_downsampling"]
    return 2 * n * t * t * c + 2 * n * t * t * 2


def clip_flops(cfg, sources, frames):
    """One render of `frames` driving frames from `sources` references."""
    lab = cfg["label_nc"]
    enc = sum(f for f, _ in encoder_convs(cfg, sources, 3 + lab,
                                          cfg["enc_n_blocks"]))
    enc += sum(f for f, _ in encoder_convs(cfg, frames, lab, 0))
    return (enc + sources * attention_flops(cfg, frames)
            + fusenet_flops(cfg, sources * frames) + decoder_flops(cfg, frames))


def patchgan_convs(cfg, n, in_ch, size):
    ndf, nl = cfg["ndf"], cfg["d_n_layers"]
    widths = [ndf] + [ndf * min(2 ** k, 8) for k in range(1, nl + 1)] + [1]
    out, ch, s = [], in_ch, size
    for i, w in enumerate(widths):
        stride = 2 if i < nl else 1
        s = (s + 2 - 4) // stride + 1
        out.append(conv(n, ch, w, 4, s, s))
        ch = w
    return out


VGG = (64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512, 512)
VGG_POOL_AFTER = (1, 3, 7, 11)


def vgg_flops(n, size):
    total, ch, s = 0, 3, size
    for i, w in enumerate(VGG):
        total += conv(n, ch, w, 3, s, s)
        ch = w
        if i in VGG_POOL_AFTER:
            s //= 2
    return total


def train_step_flops(cfg, batch):
    """One GAN step of the reference: forward and backward of the
    generator, the D phase on the detached reconstruction (weight
    gradients; input gradients past the first stage), the G phase through
    the updated, frozen discriminators and the frozen VGG19 (input
    gradients only); with the face discriminator the same on the crops."""
    lab, s, size = cfg["label_nc"], cfg["n_source"], cfg["image_size"]
    b = batch
    enc = (encoder_convs(cfg, b * s, 3 + lab, cfg["enc_n_blocks"])
           + encoder_convs(cfg, b, lab, 0))
    fwd_enc = sum(f for f, _ in enc)
    bwd_enc = sum(f if first else 2 * f for f, first in enc)
    t = (size // 2 ** cfg["n_downsampling"]) ** 2
    c = cfg["ngf"] * 2 ** cfg["n_downsampling"]
    att_f = s * attention_flops(cfg, b)
    att_b = s * (2 * (2 * b * t * t * c) + 2 * b * t * t * 2)
    rest = fusenet_flops(cfg, b * s) + decoder_flops(cfg, b)
    gen = fwd_enc + bwd_enc + att_f + att_b + 3 * rest

    def disc(n, in_ch, sz):
        stages = patchgan_convs(cfg, n, in_ch, sz)
        fwd = sum(stages)
        d_phase = 2 * fwd + 2 * (fwd + fwd - stages[0])
        g_phase = 2 * fwd + fwd
        return d_phase + g_phase

    total = gen + disc(b, 3 + lab, size) + 3 * vgg_flops(b, size)
    if cfg["use_face_d"]:
        face = size // 32 * 8
        total += disc(b, 3, face) + 3 * vgg_flops(b, face)
    return total


# ---------------------------------------------------------------- kernels

def bound_s(flops, nbytes):
    """The least seconds the card could take for a call."""
    return max(flops / PEAK_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S)


def k1_call(sources, frames, t, c):
    """K1: the mean over sources of each frame's warped source features,
    bf16 out."""
    s, f = sources, frames
    nbytes = 4 * (2 * s * t * c + f * t * c + s * t + f * t + 2 * t) \
        + 2 * f * t * c
    return s * f * t * (2 * t * c + 10 * t + 8 * c), nbytes


def k2_call(sources, frames, hw, c, elem_bytes):
    """K2: the mean over sources of per-plane instance norms."""
    numel = sources * frames * hw * c
    nbytes = numel * elem_bytes
    return 7 * numel, nbytes + nbytes // sources


def _pairs_in_bytes(g, s, t, c):
    return 4 * (2 * g * s * t * c + g * t * c + g * s * t + g * t + 2 * t)


def k3flow_call(groups, sources, t, c):
    """K3-flow: warped features and flow of every (sample, source) pair."""
    pairs = groups * sources
    nbytes = _pairs_in_bytes(groups, sources, t, c) + 4 * pairs * t * (c + 3)
    return pairs * t * (2 * t * c + 10 * t + 8 * c), nbytes


def k4_call(groups, sources, t, c):
    """K4: the six cotangents of K3-flow's inputs."""
    pairs = groups * sources
    nbytes = (2 * _pairs_in_bytes(groups, sources, t, c)
              + 4 * pairs * t * (c + 5))
    return pairs * t * t * (6 * c + 20), nbytes
