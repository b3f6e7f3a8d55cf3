"""PyTorch modules of TS-Net (NHWC tensors in and out)."""

from .blocks import (Conv2d, ResnetBlock, conv2d, get_initializer,
                     get_norm_layer, reflect_pad)
from .decoder import Decoder, decoder_apply_fast
from .encoder import Encoder, encoder_apply_fast
from .discriminator import (PatchDiscriminator, PixelDiscriminator,
                            VideoDiscriminator, define_D)
from .fusenet import FuseNet, fuse_clip, fuse_train
from .generators import ResnetGenerator, UnetGenerator, define_G
from .vgg import VGG19Features, load_vgg19_npz

__all__ = ["Conv2d", "ResnetBlock", "conv2d", "get_initializer",
           "get_norm_layer", "reflect_pad", "Decoder", "decoder_apply_fast",
           "Encoder", "encoder_apply_fast", "FuseNet",
           "fuse_clip", "fuse_train", "PatchDiscriminator",
           "PixelDiscriminator", "VideoDiscriminator", "define_D",
           "ResnetGenerator", "UnetGenerator", "define_G", "VGG19Features",
           "load_vgg19_npz"]
