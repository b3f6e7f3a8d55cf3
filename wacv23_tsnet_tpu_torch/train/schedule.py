"""Learning-rate schedule (counterpart of the JAX package's
`train/schedule.py:lr_poly`).

Polynomial decay after an initial constant phase, counted in examples
(step * batch size); the fraction is clamped to [0, 1], so training past
`max_iter` gives lr 0 rather than a negative lr.
"""

from __future__ import annotations


def lr_poly(base_lr: float, it, initial_iter: int, max_iter: int,
            power: float = 1.0) -> float:
    frac = (it - initial_iter) / (max_iter - initial_iter)
    return base_lr * (1.0 - min(max(frac, 0.0), 1.0)) ** power
