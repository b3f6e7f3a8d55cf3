"""Model FLOPs of the window's real frames over the window, as a % of
the card's dense bf16 peak (layer: generator)."""

from benchmark import readers


def read(rec):
    return readers.share_of_peak(rec, "clip_shape")
