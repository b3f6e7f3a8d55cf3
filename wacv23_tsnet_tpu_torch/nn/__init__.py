"""PyTorch modules of TS-Net (NHWC tensors in and out)."""

from .blocks import Conv2d, ResnetBlock, conv2d, reflect_pad
from .decoder import Decoder
from .encoder import Encoder
from .discriminator import PatchDiscriminator, define_D
from .fusenet import FuseNet, fuse_clip, fuse_train
from .vgg import VGG19Features, load_vgg19_npz

__all__ = ["Conv2d", "ResnetBlock", "conv2d", "reflect_pad", "Decoder",
           "Encoder", "FuseNet", "fuse_clip", "fuse_train",
           "PatchDiscriminator", "define_D", "VGG19Features",
           "load_vgg19_npz"]
