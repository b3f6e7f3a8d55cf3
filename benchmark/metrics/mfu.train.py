"""Model FLOPs of the window's train steps (forward and backward of the
generator, the discriminators and VGG19) over the window, as a % of the
card's dense bf16 peak (layer: train step)."""

from benchmark import readers


def read(rec):
    return readers.share_of_peak(rec, "train_shape")
