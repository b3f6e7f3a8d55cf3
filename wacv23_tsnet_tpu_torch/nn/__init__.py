"""PyTorch modules of TS-Net (NHWC tensors in and out)."""

from .blocks import Conv2d, ResnetBlock, conv2d, reflect_pad
from .decoder import Decoder
from .encoder import Encoder
from .fusenet import FuseNet, fuse_clip

__all__ = ["Conv2d", "ResnetBlock", "conv2d", "reflect_pad", "Decoder",
           "Encoder", "FuseNet", "fuse_clip"]
