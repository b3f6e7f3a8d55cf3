"""Phase-decomposed [bilinear-2x upsample -> reflect-pad -> 3x3 conv]
(the port's copy of the JAX package's `ops/upconv.py`).

The decoder's upsample stages run a 3x3 conv on the 2x-bilinear-upsampled
tensor: at twice the resolution with half the channels, behind two
full-size passes (the upsample and the reflect pad). Both steps are
linear, so the composition is itself a conv of the INPUT, one 3x3 kernel
per output phase (py, px) in {0,1}^2. With half-pixel centres
(align_corners=False), output row 2i+p of the upsample reads

    u[2i]   = 0.25 x[i-1] + 0.75 x[i]        (clamped at i=0)
    u[2i+1] = 0.75 x[i]   + 0.25 x[i+1]      (clamped at i=H-1)

so a 3-tap conv over u is a 3-tap conv over x with phase-mixed weights
(`_W1D`): ONE conv at the input's resolution with 4x the output channels,
then a depth-to-space interleave. The products are the same; the
upsampled tensor is never made.

The identity fails on the 2-pixel ring of the output, where the upsample
clamps and the pad reflects the upsampled tensor. That ring is linear in
the first and last two input rows and columns, so closed-form kernels
(`_derived`) compute it exactly from them, and slice writes place it
over the bulk conv's ring: the op is exact everywhere, borders included.

`upconv_in_relu` runs the stage's instance norm and ReLU through the
generator's norm route (`ops.norm_kernels.instance_norm_routed`,
`phase_groups=4`, one-pass statistics): one K8 launch at inference on the
card with `use_kernels`, an ATen composition everywhere else.

`conv7x7_phase` is the decoder's last [reflect-pad 3 -> 7x7 conv] of a
phase-layout input: a 5x5 conv over 4 Ci channels at half resolution
with 4 Co outputs, its 2-pixel ring recomputed from thin slabs that carry
the true reflected rows.

Phase layout: channel ((py * 2 + px) * C + c), as
`ops.warp.space_to_depth(y, 2)` of the interleaved y. Kernels are OIHW,
tensors NHWC. Every convolution is the tier's `ops.dpconv.conv2d` in the
dtype of its input; derived kernels are computed in fp32 (TF32 off) and
rounded once to the kernel's dtype.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import DECODER_NORMS
from .dpconv import conv2d
from .norm_kernels import instance_norm_routed
from .precision import tf32

# _W1D[p, k, d]: coefficient of x[i + d - 1] in upsample tap u[2i + p + k - 1]
# (the k-th of the three rows a VALID 3-tap conv reads for output 2i + p)
_W1D = np.array([[[0.75, 0.25, 0.0], [0.25, 0.75, 0.0], [0.0, 0.75, 0.25]],
                 [[0.25, 0.75, 0.0], [0.0, 0.75, 0.25], [0.0, 0.25, 0.75]]])
# _T_EDGE[p, k, a]: weight of x[a] in the k-th tap for output row p at the
# clamped and reflect-padded top edge: u[0] = x0, u[1] = .75 x0 + .25 x1,
# u[2] = .25 x0 + .75 x1, pad row u[-1] = u[1]; _T_EDGE_BOT, its mirror
# against (x[H-2], x[H-1]) for output rows (2H-2, 2H-1)
_T_EDGE = np.array([[[0.75, 0.25], [1.0, 0.0], [0.75, 0.25]],
                    [[1.0, 0.0], [0.75, 0.25], [0.25, 0.75]]])
_T_EDGE_BOT = np.array([[[0.75, 0.25], [0.25, 0.75], [0.0, 1.0]],
                        [[0.25, 0.75], [0.0, 1.0], [0.25, 0.75]]])
_EDGES = (_T_EDGE, _T_EDGE_BOT)
# Every derived kernel is linear in the 9 taps (a, b) of the 3x3 kernel:
# one (196, 9) matrix maps them to the phase kernel's taps (p, q, d, e),
# the top and bottom ring strips' (edge, p, q, a, d), the left and right
# strips' (edge, p, q, d, a) and the four corners' (vs * 2 + hs, p, q,
# a, b). Its entries are products of quarters: exact in fp32.
_DERIVE = np.concatenate(
    [np.einsum("pad,qbe->pqdeab", _W1D, _W1D).reshape(36, 9)]
    + [np.einsum("pka,qxd->pqadkx", t, _W1D).reshape(24, 9) for t in _EDGES]
    + [np.einsum("pkd,qxa->pqdakx", _W1D, t).reshape(24, 9) for t in _EDGES]
    + [np.einsum("pka,qxb->pqabkx", tv, th).reshape(16, 9)
       for tv in _EDGES for th in _EDGES]).astype(np.float32)


@functools.cache
def _derive_matrix(device: torch.device) -> torch.Tensor:
    # a normal tensor even when first asked for under inference_mode:
    # training saves it for the backward
    with torch.inference_mode(False):
        return torch.from_numpy(_DERIVE).to(device)


def _derived(kernel: torch.Tensor):
    """(Co, Ci, 3, 3) kernel -> (phase (4Co, Ci, 3, 3), rows (8Co, Ci, 2, 3),
    cols (8Co, Ci, 3, 2), corners (16Co, Ci, 2, 2)) in the kernel's dtype,
    from one fp32 product (TF32 off). Output channels: phase ((py * 2 +
    px) * Co + o), matching `depth_to_space`; rows and cols the top/left
    strip's 4Co then the bottom/right one's, over x[:, :2] / x[:, -2:]
    and x[:, :, :2] / x[:, :, -2:]; corners the 4Co of each corner, in
    the order top-left, top-right, bottom-left, bottom-right."""
    co, ci = kernel.shape[:2]
    with tf32(False):
        d = _derive_matrix(kernel.device) @ kernel.float().reshape(
            co * ci, 9).t()

    def block(rows, lead, taps):
        n = len(lead) + 2
        k = rows.to(kernel.dtype).reshape(*lead, *taps, co, ci)
        k = k.permute(*range(len(lead)), n, n + 1, *range(len(lead), n))
        return k.reshape(-1, ci, *taps)

    phase, rows, cols, corners = d.split((36, 48, 48, 64))
    return (block(phase, (2, 2), (3, 3)), block(rows, (2, 2, 2), (2, 3)),
            block(cols, (2, 2, 2), (3, 2)), block(corners, (4, 2, 2), (2, 2)))


def phase_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3) conv kernel -> (4 Co, Ci, 3, 3) phase kernel, output
    channel ((py * 2 + px) * Co + o), matching `depth_to_space`."""
    return _derived(kernel)[0]


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 4C) phase layout -> (B, 2H, 2W, C)."""
    b, h, w, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h, 2 * w, c)


def _edges(x: torch.Tensor, dim: int, k: int) -> torch.Tensor:
    """x's first and last k rows (dim 1) or columns (dim 2), as one
    gather: its gradient is one scatter into a tensor of x's shape, where
    a slice for each piece would make one such tensor a piece."""
    i = torch.arange(2 * k, device=x.device)
    return x.index_select(dim, torch.where(i < k, i, i + x.shape[dim] - 2 * k))


def _ring_and_bulk(x: torch.Tensor, kernel: torch.Tensor, precision: str,
                   bwd_precision=None) -> torch.Tensor:
    """The phase-layout conv of x (B, H, W, 4Co) with its 2-pixel border
    ring exact: the bulk conv pads with zeros, which corrupts only that
    ring, and the ring (linear in x's first and last two rows and
    columns) comes from three thin grouped VALID convs with the
    closed-form ring kernels (the opposite edges side by side in the
    channels), at the forward's precision, placed by slice writes."""
    b, h, w, c = x.shape
    c4 = 4 * kernel.shape[0]
    kp, k_rows, k_cols, k_corners = _derived(kernel)
    y = conv2d(x, kp, padding=1, precision=precision, dtype=x.dtype,
               bwd_precision=bwd_precision)

    def conv(xs, k, groups):
        out = conv2d(xs, k, precision=precision, dtype=x.dtype, groups=groups)
        return out.split(c4, dim=-1)

    rows, cols = _edges(x, 1, 2), _edges(x, 2, 2)      # (B, 4, W), (B, H, 4)
    top, bot = conv(rows.reshape(b, 2, 2, w, c).permute(0, 2, 3, 1, 4)
                    .reshape(b, 2, w, 2 * c), k_rows, 2)
    left, right = conv(cols.reshape(b, h, 2, 2, c).permute(0, 1, 3, 2, 4)
                       .reshape(b, h, 2, 2 * c), k_cols, 2)
    tl, tr, bl, br = conv(_edges(rows, 2, 2).reshape(b, 2, 2, 2, 2, c)
                          .permute(0, 2, 4, 1, 3, 5).reshape(b, 2, 2, 4 * c),
                          k_corners, 4)
    y[:, :1] = torch.cat([tl, top, tr], dim=2)
    y[:, -1:] = torch.cat([bl, bot, br], dim=2)
    y[:, 1:-1, :1] = left
    y[:, 1:-1, -1:] = right
    return y


def upsample2x_reflect_conv3(x: torch.Tensor, kernel: torch.Tensor,
                             bias=None, precision: str = "highest",
                             phase_out: bool = False) -> torch.Tensor:
    """Exact [upsample_bilinear_2x -> reflect_pad(1) -> conv3x3 VALID].

    x (B, H, W, Ci), H, W >= 3; kernel (Co, Ci, 3, 3); bias (Co,) or None.
    Returns (B, 2H, 2W, Co), or with `phase_out` its (B, H, W, 4Co) phase
    layout, in x's dtype."""
    y = _ring_and_bulk(x, kernel, precision)
    if bias is not None:
        y = y + bias.to(y.dtype).repeat(4)
    return y if phase_out else depth_to_space(y)


def upconv_in_relu(x: torch.Tensor, kernel: torch.Tensor,
                   precision: str = "highest", phase_out: bool = False,
                   eps: float = 1e-5, bwd_precision=None,
                   use_kernels: bool = True) -> torch.Tensor:
    """[upsample2x -> reflect-pad -> conv3x3 -> instance_norm -> relu].

    The conv's bias is dropped: a per-channel constant cancels exactly in
    the instance norm's mean. The statistics are the JAX package's form
    for this op: one pass in fp32 over the bulk's interior and the ring
    pieces (sum and sum of squares over space and the four phase copies
    of each channel, the variance clamped at 0), whatever the dtype. The
    bulk conv carries almost all the products and runs its backward at
    `bwd_precision`; the thin ring convs stay at the forward's. Arguments
    and result as `upsample2x_reflect_conv3`.

    The norm and relu of the phase-layout conv output take the
    generator's norm route (`norm_kernels.instance_norm_routed`, counted
    in `utils.profiling.DECODER_NORMS`): at inference on the card with
    `use_kernels` one K8 launch with `phase_groups=4`, the same formula
    with its fp32 sums in another order; everywhere else
    `ops.norms.instance_norm_one_pass`."""
    y = _ring_and_bulk(x, kernel, precision, bwd_precision)
    y = instance_norm_routed(y, DECODER_NORMS, relu=True, phase_groups=4,
                             use_kernels=use_kernels, one_pass=True, eps=eps)
    return y if phase_out else depth_to_space(y)


@functools.cache
def _phase7_index(device: torch.device) -> torch.Tensor:
    """iy[a, py, p]: the row (and column) of the padded 7x7 kernel that
    phase tap a of input phase py reads for output phase p."""
    a = np.arange(5)[:, None, None]
    p = np.arange(2)
    iy = 2 * (a - 2) + p[None, :, None] - p[None, None, :] + 5
    with torch.inference_mode(False):           # as in `_derive_matrix`
        return torch.from_numpy(iy).to(device)


def conv7x7_phase_kernel(k7: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 7, 7) -> (4 Co, 4 Ci, 5, 5) phase-domain kernel.

    An output pixel at interleaved (2i+p, 2j+q) reads interleaved rows
    2i+p-3 .. 2i+p+3, which lie in phase rows i-2 .. i+2 at tap offset
    dy = 2 dy' + py - p; taps with |dy| > 3 land in the zero border of a
    padded copy of k7 and vanish exactly (a gather, no arithmetic)."""
    co, ci = k7.shape[:2]
    k = F.pad(k7, (2, 2, 2, 2)).permute(2, 3, 1, 0)        # (11, 11, Ci, Co)
    iy = _phase7_index(k7.device)
    k5 = k[iy[:, None, :, None, :, None],
           iy[None, :, None, :, None, :]]          # a b py px p q Ci Co
    k5 = k5.permute(0, 1, 2, 3, 6, 4, 5, 7).reshape(5, 5, 4 * ci, 4 * co)
    return k5.permute(3, 2, 0, 1).contiguous()


def _mixed(x: torch.Tensor, sel: torch.Tensor, dim: int, pairs):
    """Phase rows (dim 1) or columns (dim 2) of reflect_pad(interleaved, 3)
    that lie outside x, one for each (i0, i1): the channels where `sel`
    holds (phase 0 along `dim`) from phase row or column i0, the others
    from i1 (reflection keeps parity, so phases never cross). Padded
    phase row -1 holds interleaved rows (-2, -1), reflected (2, 1): row
    1's py=0 and row 0's py=1."""
    return [torch.where(sel, x.narrow(dim, i0, 1), x.narrow(dim, i1, 1))
            for i0, i1 in pairs]


def _padded(x: torch.Tensor, sel: torch.Tensor, dim: int) -> torch.Tensor:
    """x with 2 phase rows or columns of the reflect pad on each side."""
    n = x.shape[dim]
    return torch.cat([*_mixed(x, sel, dim, ((2, 1), (1, 0))), x,
                      *_mixed(x, sel, dim, ((n - 1, n - 2), (n - 2, n - 3)))],
                     dim=dim)


def conv7x7_phase(x_phase: torch.Tensor, k7: torch.Tensor, bias=None,
                  precision: str = "highest",
                  bwd_precision=None) -> torch.Tensor:
    """Exact [reflect_pad(3) -> conv7x7 VALID] of the interleaved tensor,
    computed in phase layout.

    The bulk conv pads with zeros; only the 2-pixel output ring sees the
    reflected values, so it is recomputed from 6-row and 6-column slabs
    that carry the true phase-mixed pad rows (O(H) work; the two
    opposite slabs stacked along the batch, one conv each way) and
    placed by slice writes: rows first, then columns, which own the
    corners.

    x_phase (B, H, W, 4Ci), H, W >= 4; k7 (Co, Ci, 7, 7); bias (Co,) or
    None. Returns (B, H, W, 4Co) phase layout in x_phase's dtype
    (`depth_to_space` interleaves it)."""
    c = k7.shape[1]
    b, c4 = x_phase.shape[0], x_phase.shape[-1]
    ch = torch.arange(c4, device=x_phase.device)
    sel_row, sel_col = ch < 2 * c, (ch // c) % 2 == 0
    k5 = conv7x7_phase_kernel(k7)

    def conv(t, padding=0, bwd=None):
        return conv2d(t, k5, padding=padding, precision=precision,
                      dtype=x_phase.dtype, bwd_precision=bwd)

    y = conv(x_phase, 2, bwd_precision)
    rows = _edges(x_phase, 1, 4)        # phase rows 0..3 and H-4..H-1
    top = torch.cat([*_mixed(rows, sel_row, 1, ((2, 1), (1, 0))),
                     rows[:, :4]], dim=1)
    bot = torch.cat([rows[:, 4:],
                     *_mixed(rows, sel_row, 1, ((7, 6), (6, 5)))], dim=1)
    out = conv(_padded(torch.cat([top, bot]), sel_col, 2))  # (2B, 2, W)
    y[:, :2], y[:, -2:] = out[:b], out[b:]
    cols = _edges(x_phase, 2, 4)
    left = torch.cat([*_mixed(cols, sel_col, 2, ((2, 1), (1, 0))),
                      cols[:, :, :4]], dim=2)
    right = torch.cat([cols[:, :, 4:],
                       *_mixed(cols, sel_col, 2, ((7, 6), (6, 5)))], dim=2)
    out = conv(_padded(torch.cat([left, right]), sel_row, 1))  # (2B, H, 2)
    y[:, :, :2], y[:, :, -2:] = out[:b], out[b:]
    if bias is not None:
        y = y + bias.to(y.dtype).repeat(4)
    return y
