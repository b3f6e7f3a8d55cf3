"""% of the traced stretch of clip renders with no device operation
running (layer: device)."""

from benchmark import readers


def read(rec):
    return readers.idle_share(rec, "clip_shape")
