"""Shared building blocks (NHWC tensors, PyTorch modules).

Counterpart of the JAX package's `nn/blocks.py`: reflection padding
before VALID convolutions, affine-free instance norm, normal(0, 0.02)
kernels and zero biases.

Every convolution goes through `conv2d` (`ops/dpconv.py`), which takes
the tier's activation dtype and precision (see `configs/base.py`):

- dtype bf16 (`fast_tail`): input, kernel and bias in bf16, bf16 out;
- dtype f32, precision "default" (`fast_trunk`): one bf16 pass, output
  back to f32, bias added in f32;
- dtype f32, precision "high": three bf16 passes with fp32 accumulation
  on the card (`ops.dpconv.conv_bf16x3`), the fp32 conv on the CPU;
- dtype f32, precision "highest": full fp32, TF32 off.

The f32 tiers hold in both directions: autograd would dispatch a
convolution's backward later, under the process's own TF32 setting
(cuDNN's default is TF32 on), so `ops.dpconv.conv2d_dp` computes
grad-input and grad-weight under the tier's own setting, the forward's
or `bwd_precision`'s where a module sets one.

Tensors stay NHWC; a convolution sees them as channels_last NCHW views.

`norms_on_k8` says which of these tiers let their instance norms take
K8 at inference (the norm route of `ops.norm_kernels.instance_norm_routed`).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.dpconv import conv2d
from ..ops.norm_kernels import instance_norm_routed
from ..ops.norms import instance_norm
from ..ops.reflectconv import conv2d_reflect_dp


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Spatial reflection padding of an NHWC tensor (torch ReflectionPad2d)."""
    _, h, w, _ = x.shape

    def index(n):
        i = torch.arange(-p, n + p, device=x.device).abs()
        return torch.where(i > n - 1, 2 * (n - 1) - i, i)

    return x.index_select(1, index(h)).index_select(2, index(w))


def reflect_conv(x: torch.Tensor, weight: torch.Tensor, bias, p: int,
                 precision: str = "highest", dtype=torch.float32,
                 bwd_precision=None, ring_pad: bool = False) -> torch.Tensor:
    """`conv2d(reflect_pad(x, p), weight, bias)`; with `ring_pad` the same
    sums without the padded tensor (`ops.reflectconv`)."""
    if ring_pad:
        return conv2d_reflect_dp(x, weight, p, bias, precision, dtype,
                                 bwd_precision)
    return conv2d(reflect_pad(x, p), weight, bias, 1, 0, precision, dtype,
                  bwd_precision)


def conv2d_split_in(x: torch.Tensor, weight: torch.Tensor, bias, mesh,
                    axis: str, precision: str = "highest",
                    dtype=torch.float32, bwd_precision=None,
                    ring_pad: bool = False) -> torch.Tensor:
    """The reflect-pad 3x3 conv `reflect_conv(x, weight, bias, 1)` where x
    holds this rank's share of the in-channels and weight the same share
    of its dim 1: the partial sums are summed over `axis` of `mesh`
    (`reduce_from`: the gradient passes as it is) and the bias is added
    once, after the sum. Where the whole conv rounds its output to bf16
    (a bf16 tier, or "default" precision), each partial sum is the exact
    product of the bf16 operands summed in f32, and the total is rounded
    once, as the whole conv's f32 accumulator is; what remains different
    is the order of the sum. With `ring_pad` each partial sum is taken by
    `ops.reflectconv` (a linear map of x, so the sum over ranks holds)."""
    rounds = dtype == torch.bfloat16 or (
        precision == "default" and bwd_precision in (None, "default"))

    def partial(xx, ww, prec, dt):
        return reflect_conv(xx, ww, None, 1, prec, dt, bwd_precision,
                            ring_pad)

    if not rounds:
        y = mesh.reduce_from(partial(x, weight, precision, dtype), axis)
        return y if bias is None else y + bias
    y = partial(x.to(torch.bfloat16).float(),
                weight.to(torch.bfloat16).float(), "highest", torch.float32)
    y = mesh.reduce_from(y, axis)
    if dtype == torch.bfloat16:
        if bias is not None:
            y = y + bias.to(torch.bfloat16).float()
        return y.to(torch.bfloat16)
    y = y.to(torch.bfloat16).float()
    return y if bias is None else y + bias.float()


class Conv2d(nn.Module):
    """Convolution module holding an OIHW kernel and, unless `bias=False`,
    a bias (f32)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype=torch.float32,
                 precision: str = "highest", bwd_precision=None,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.precision = precision
        self.bwd_precision = bwd_precision
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        """normal(0, 0.02) kernel, zero bias. Drawn on the CPU from
        `generator`, so one seed gives the same weights on any device."""
        with torch.no_grad():
            self.weight.copy_(torch.empty(self.weight.shape).normal_(
                0.0, 0.02, generator=generator))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, self.stride, self.padding,
                      self.precision, self.dtype, self.bwd_precision)


def norms_on_k8(dtype, precision: str) -> bool:
    """Whether the instance norms after convs of this dtype and precision
    may take K8 at inference: bf16 always, fp32 only at "high" (bf16x3).

    K8 sums in another order than ATen's composition. At "highest" (the
    bit-parity tier, held within 1e-3 of its plain path) that moves the
    frames past 1e-3; at "default" (`fast_trunk`: the next conv takes one
    bf16 pass) it flips bf16 roundings of the encoders' features ahead of
    the temp-100 attention (0.13 mean L1 in the face clip's frames on an
    H100, random weights, against the fast tiers' 0.01 budget). Both keep
    the composition."""
    return dtype == torch.bfloat16 or precision == "high"


class ResnetBlock(nn.Module):
    """reflect-pad 3x3 conv + IN + ReLU, reflect-pad 3x3 conv + IN, +skip.

    Tensor parallel (`tensor_parallel = (mesh, axis)`, set by
    `parallel.spmd.shard_modules`): conv1 holds this rank's share of the
    out-channels (and of its bias), conv2 the same share of its
    in-channels. The input enters through `mesh.copy_to` (its gradient is
    summed over `axis`), conv1, its instance norm (per channel, so no
    collective) and the ReLU run on the rank's channels, and conv2 runs
    as `conv2d_split_in`.

    `ring_pad` (`TSNetConfig.ring_pad`) runs each reflect-pad conv
    without the padded tensor (`ops.reflectconv`), on one rank or split.

    On one rank both norms take the generator's norm route
    (`ops.norm_kernels.instance_norm_routed`) with `use_kernels` in a
    tier that `norms_on_k8` admits, counted in the `norms` given to
    `forward` (a `utils.profiling` counter, or None). The tensor-parallel
    branch keeps the composition, counted as such.
    """

    def __init__(self, dim: int, dtype=torch.float32,
                 precision: str = "highest", bwd_precision=None,
                 ring_pad: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, precision=precision,
                  bwd_precision=bwd_precision)
        self.conv1 = Conv2d(dim, dim, 3, **kw)
        self.conv2 = Conv2d(dim, dim, 3, **kw)
        self.ring_pad = ring_pad
        self.tensor_parallel = None

    def forward(self, x: torch.Tensor, use_kernels: bool = False,
                norms: dict | None = None) -> torch.Tensor:
        def conv(t, c):
            return reflect_conv(t, c.weight, c.bias, 1, c.precision, c.dtype,
                                c.bwd_precision, self.ring_pad)

        if self.tensor_parallel is None:
            c1 = self.conv1
            k8 = use_kernels and norms_on_k8(c1.dtype, c1.precision)
            h = instance_norm_routed(conv(x, c1), norms, relu=True,
                                     use_kernels=k8)
            return x + instance_norm_routed(conv(h, self.conv2), norms,
                                            use_kernels=k8)
        if norms is not None:
            norms["plain"] += 2
        mesh, axis = self.tensor_parallel
        h = torch.relu(instance_norm(conv(mesh.copy_to(x, axis), self.conv1)))
        c2 = self.conv2
        y = conv2d_split_in(h, c2.weight, c2.bias, mesh, axis, c2.precision,
                            c2.dtype, c2.bwd_precision, self.ring_pad)
        return x + instance_norm(y)


# flax's truncated-normal variance scaling draws from a unit normal cut at
# +-2 and divides by that distribution's std, so the kernel keeps `scale`
_TRUNC_STD = 0.87962566103423978


def get_initializer(init_type: str = "normal", init_gain: float = 0.02):
    """Weight-init factory (the JAX package's `get_initializer`, after the
    reference's `init_weights`): `init(weight, generator=None)` fills an
    OIHW conv kernel in place from `generator` (drawn on the CPU, so a
    seed gives the same kernel on any device) and returns it.

    normal: N(0, init_gain). xavier: flax `variance_scaling(init_gain**2,
    "fan_avg", "truncated_normal")`. kaiming: flax `kaiming_normal`
    (`variance_scaling(2, "fan_in", "truncated_normal")`). orthogonal:
    orthonormal rows of the (O, I*kh*kw) matrix (columns where there are
    fewer of them), times init_gain. fan_in = I*kh*kw, fan_out =
    O*kh*kw, as flax counts an HWIO kernel.
    """
    def variance_scaling(scale: float, mode: str):
        def init(weight, generator=None):
            o, i = weight.shape[:2]
            field = weight[0, 0].numel()
            fan = {"fan_in": i * field,
                   "fan_avg": (i + o) * field / 2.0}[mode]
            std = (scale / fan) ** 0.5 / _TRUNC_STD
            x = torch.nn.init.trunc_normal_(torch.empty(weight.shape),
                                            generator=generator)
            with torch.no_grad():
                return weight.copy_(x * std)
        return init

    if init_type == "normal":
        def normal(weight, generator=None):
            with torch.no_grad():
                return weight.copy_(torch.empty(weight.shape).normal_(
                    0.0, init_gain, generator=generator))
        return normal
    if init_type == "xavier":
        return variance_scaling(init_gain ** 2, "fan_avg")
    if init_type == "kaiming":
        return variance_scaling(2.0, "fan_in")
    if init_type == "orthogonal":
        def orthogonal(weight, generator=None):
            rows, cols = weight.shape[0], weight[0].numel()
            a = torch.empty(max(rows, cols), min(rows, cols),
                            dtype=torch.float64).normal_(generator=generator)
            q, r = torch.linalg.qr(a)
            q = q * torch.sign(torch.diagonal(r))[None]
            q = q if rows >= cols else q.T              # (rows, cols)
            with torch.no_grad():
                return weight.copy_((init_gain * q).reshape(weight.shape))
        return orthogonal
    raise NotImplementedError(
        f"initialization method [{init_type}] is not implemented")


def get_norm_layer(norm_type: str = "instance"):
    """Norm factory (the JAX package's `get_norm_layer`): a callable
    x -> x on NHWC tensors. TS-Net uses "instance" everywhere
    (affine-free, no running statistics); "batch" is refused, as there:
    no shipped config uses it and it needs running-statistics state."""
    if norm_type == "instance":
        return instance_norm
    if norm_type == "none":
        return lambda x: x
    if norm_type == "batch":
        raise NotImplementedError(
            "batch norm is vestigial in the reference (never used by a "
            "shipped TS-Net config) and needs mutable batch-stats state; "
            "use 'instance' or 'none'")
    raise NotImplementedError(
        f"normalization layer [{norm_type}] is not found")
