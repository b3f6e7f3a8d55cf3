"""Median ms a train step spends from the end of the discriminators'
Adam update to the end of the G loss's backward, between CUDA events
that `make_train_step`'s `mark` hook records (layer: train step)."""

import statistics


def read(rec):
    ms = rec.get("stage_ms")
    if not ms:
        return None
    return statistics.median(ms)
