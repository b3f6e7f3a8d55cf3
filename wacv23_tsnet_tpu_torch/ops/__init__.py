"""Tensor ops of the port (NHWC), and the CUDA kernels' wrappers."""

from .coords import coord_channels, normalized_grid
from .grid_sample import grid_sample
from .norm_kernels import instance_norm_mean, instance_norm_mean_plain
from .norms import instance_norm, l2_normalize
from .resize import resize_nearest, upsample_bilinear_2x
from .similarity import (masked_attention_flow, transformation_warp,
                         transformation_warp_clip,
                         transformation_warp_clip_mean)

__all__ = [
    "coord_channels", "normalized_grid", "grid_sample", "instance_norm",
    "l2_normalize", "instance_norm_mean", "instance_norm_mean_plain",
    "resize_nearest", "upsample_bilinear_2x", "masked_attention_flow",
    "transformation_warp", "transformation_warp_clip",
    "transformation_warp_clip_mean",
]
