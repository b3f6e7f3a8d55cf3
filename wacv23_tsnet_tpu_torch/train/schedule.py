"""Learning-rate schedules (counterpart of the JAX package's
`train/schedule.py`).

`lr_poly` is TS-Net's: polynomial decay after an initial constant phase,
counted in examples (step * batch size); the fraction is clamped to
[0, 1], so training past `max_iter` gives lr 0 rather than a negative lr.

`get_scheduler` and `PlateauScale` are the reference zoo's
(`get_scheduler`: linear, step, cosine; the metric-driven plateau policy
as a host-side object). TS-Net itself uses `lr_poly`. Each schedule is
computed as the JAX package computes it: in float32 where that code does
its arithmetic in `jnp` (linear; cosine as optax's
`cosine_decay_schedule(alpha=0)`), in Python floats where it does not
(step), in the same order of operations.
"""

from __future__ import annotations

import math

import numpy as np

_F32 = np.float32


def lr_poly(base_lr: float, it, initial_iter: int, max_iter: int,
            power: float = 1.0) -> float:
    frac = (it - initial_iter) / (max_iter - initial_iter)
    return base_lr * (1.0 - min(max(frac, 0.0), 1.0)) ** power


def _cosine(base_lr: float, decay_steps: int):
    """optax `cosine_decay_schedule(base_lr, decay_steps, alpha=0)`."""
    if not decay_steps > 0:
        raise ValueError("the cosine schedule requires positive decay "
                         f"steps, got {decay_steps}")

    def sched(count) -> float:
        c = _F32(min(float(count), float(decay_steps)))
        arg = _F32(math.pi) * c / _F32(decay_steps)
        decay = _F32(0.5) * (_F32(1.0) + _F32(math.cos(float(arg))))
        return float(_F32(base_lr) * (_F32(1.0) * decay + _F32(0.0)))
    return sched


def get_scheduler(policy: str, base_lr: float, *, n_epochs: int = 100,
                  epoch_count: int = 1, n_epochs_decay: int = 100,
                  lr_decay_iters: int = 50, steps_per_epoch: int = 1):
    """Per-step learning-rate schedule `step -> lr` (the reference's
    `get_scheduler` policies on epochs = step // steps_per_epoch):
    linear (constant for n_epochs, then linear decay over
    n_epochs_decay + 1), step (x0.1 every lr_decay_iters epochs) or
    cosine (over n_epochs to 0)."""
    def per_epoch(fn):
        return lambda step: fn(step // steps_per_epoch)

    if policy == "linear":
        def lam(epoch) -> float:
            over = _F32(max(0.0, epoch + epoch_count - n_epochs))
            return float(_F32(base_lr) * (
                _F32(1.0) - over / _F32(n_epochs_decay + 1)))
        return per_epoch(lam)
    if policy == "step":
        return per_epoch(
            lambda epoch: base_lr * 0.1 ** (epoch // lr_decay_iters))
    if policy == "cosine":
        return per_epoch(_cosine(base_lr, n_epochs))
    raise NotImplementedError(f"learning rate policy [{policy}] "
                              "is not implemented")


class PlateauScale:
    """ReduceLROnPlateau counterpart (host-side, metric-driven): the lr
    falls by `factor` once the metric has not improved on its best by a
    relative `threshold` for more than `patience` updates."""

    def __init__(self, base_lr: float, factor: float = 0.2,
                 threshold: float = 0.01, patience: int = 5):
        self.lr = base_lr
        self.factor = factor
        self.threshold = threshold
        self.patience = patience
        self.best = float("inf")
        self.bad_epochs = 0

    def update(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr *= self.factor
                self.bad_epochs = 0
        return self.lr
