"""Training losses of the port (NHWC tensors, fp32 sums)."""

from .gan import (feature_matching_loss, gan_loss, gradient_penalty,
                  lsgan_loss)
from .image import (cosine_align_loss, gradient_loss, l1_loss,
                    renorm_to_reference)
from .perceptual import VGG_WEIGHTS, vgg_perceptual_loss

__all__ = ["feature_matching_loss", "gan_loss", "gradient_penalty",
           "lsgan_loss",
           "cosine_align_loss", "gradient_loss", "l1_loss",
           "renorm_to_reference", "VGG_WEIGHTS", "vgg_perceptual_loss"]
