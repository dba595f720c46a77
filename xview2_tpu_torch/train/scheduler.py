"""Noam learning-rate schedule (a copy of ``xview2_tpu/train/scheduler.py``'s
arithmetic as a plain function of the update count).

Linear warmup ``init_lr -> max_lr`` over ``warmup_epochs * steps_per_epoch``
updates, then exponential decay reaching ``final_lr`` at ``total_epochs *
steps_per_epoch``, then constant ``final_lr``.  Update ``k`` (0-based) uses
the value at ``count == k``: the train step sets the optimizer's learning
rate from its step counter once per update.  Like the JAX schedule it
evaluates in float32 (the decay base ``gamma`` rounded to float32 moves the
far end of a long schedule by up to a few 1e-3, and the two packages must
train with the same rates).
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def noam_schedule(init_lr: float, max_lr: float, final_lr: float, warmup_epochs: int,
                  total_epochs: int, steps_per_epoch: int) -> Callable[[int], float]:
    warmup_steps = int(warmup_epochs * steps_per_epoch)
    total_steps = total_epochs * steps_per_epoch
    linear_increment = (max_lr - init_lr) / max(warmup_steps, 1)
    decay_steps = max(total_steps - warmup_steps, 1)
    gamma = (final_lr / max_lr) ** (1.0 / decay_steps)

    f32 = np.float32

    def schedule(count: int) -> float:
        count = f32(count)
        if count <= warmup_steps:
            return float(f32(init_lr) + count * f32(linear_increment))
        if count <= total_steps:
            return float(f32(max_lr) * f32(gamma) ** (count - f32(warmup_steps)))
        return float(f32(final_lr))

    return schedule
