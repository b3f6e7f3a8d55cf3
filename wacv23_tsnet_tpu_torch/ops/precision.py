"""Switches for cuBLAS and cuDNN around an operation: TF32, and cuDNN's
deterministic algorithms.

PyTorch runs fp32 matmuls in full fp32 by default but fp32 convolutions
through cuDNN in TF32 (~3 decimal digits). The port states the tier of
every fp32 product where it is made: `with tf32(False)` for the
bit-parity tier and the similarity logits, `with tf32(True)` only
around the three products of a `precision="high"` convolution on the
card (`ops.dpconv.conv_bf16x3`), whose operands hold bf16 values that
TF32 represents exactly. `deterministic_cudnn()` makes cuDNN take only
algorithms that give the same bits on every call, and no benchmarked
choice; the train step runs under it (`train/step.py`). The flags are
read when an operation is dispatched, so restoring them after the call
is enough.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32(enabled: bool):
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN with `deterministic=True` and `benchmark=False`; the
    caller's flags come back afterwards, also on an exception."""
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            flags)
