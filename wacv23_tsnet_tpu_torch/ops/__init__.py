"""Tensor ops of the port (NHWC), and the CUDA kernels' wrappers."""

from .conv_kernels import conv3x3_in, conv3x3_in_plain, resblock_fused
from .coords import coord_channels, normalized_grid
from .flow_kernels import masked_attention_flow, masked_attention_flow_fused
from .fuse_kernels import fuse_pair_conv2, fuse_pair_conv2_plain
from .grid_sample import grid_sample
from .norm_kernels import (instance_norm_fused, instance_norm_fused_plain,
                           instance_norm_mean, instance_norm_mean_plain)
from .norms import instance_norm, instance_norm_phase, l2_normalize
from .resize import resize_nearest, upsample_bilinear_2x
from .similarity import (transformation_warp, transformation_warp_clip,
                         transformation_warp_clip_mean)

__all__ = [
    "coord_channels", "normalized_grid", "grid_sample", "instance_norm",
    "instance_norm_phase", "l2_normalize", "instance_norm_mean",
    "instance_norm_mean_plain", "instance_norm_fused",
    "instance_norm_fused_plain", "resize_nearest", "upsample_bilinear_2x",
    "masked_attention_flow", "masked_attention_flow_fused",
    "transformation_warp", "transformation_warp_clip",
    "transformation_warp_clip_mean", "fuse_pair_conv2",
    "fuse_pair_conv2_plain", "conv3x3_in", "conv3x3_in_plain",
    "resblock_fused",
]
