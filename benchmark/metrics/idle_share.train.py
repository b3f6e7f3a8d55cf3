"""% of the traced stretch of train steps with no device operation
running (layer: device)."""

from benchmark import readers


def read(rec):
    return readers.idle_share(rec, "train_shape")
