"""Scalar schedules: the reference's `C()` convention and LR decay.

Counterpart of open_diffusiongs_tpu/utils/schedules.py:15-34 (and C_max of
open_diffusiongs_tpu/utils/config.py:25-41).  `step` is a Python int here:
the port runs eagerly, so the schedules are plain Python floats.

C(value, step): value is a float (constant), [v0, v1, end_step] (start 0)
or [start_step, v0, v1, end_step] (linear ramp clamped outside the window)
— the reference's utils/misc.py:73-94.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Union

Spec = Union[float, int, Sequence[float]]


def _four(value: Sequence[float]) -> list:
    value = list(value)
    if len(value) == 3:
        value = [0] + value
    if len(value) != 4:
        raise ValueError(f"C() spec must have 3 or 4 entries, got {value}")
    return [float(x) for x in value]


def C(value: Spec, step) -> float:
    if isinstance(value, (int, float)):
        return float(value)
    start_step, v0, v1, end_step = _four(value)
    frac = min(max((float(step) - start_step)
                   / max(end_step - start_step, 1e-8), 0.0), 1.0)
    return v0 + (v1 - v0) * frac


def C_max(value: Spec) -> float:
    """Largest value a C() spec takes (a multi-segment [s, v0, v1, e, v2,
    ...] spec takes the max of its values, like the JAX package's)."""
    if isinstance(value, (int, float)):
        return float(value)
    value = list(value)
    if len(value) >= 6:
        value = [value[0], value[1], max([value[2]] + value[4::2]),
                 value[3]]
    _, v0, v1, _ = _four(value)
    return max(v0, v1)


def cosine_annealing_lr(base_lr: float, t_max: int, eta_min: float = 0.0
                        ) -> Callable[[int], float]:
    """torch CosineAnnealingLR in closed form, clamped at t_max (the JAX
    package's schedule fn)."""
    def schedule(step) -> float:
        frac = min(max(float(step) / float(t_max), 0.0), 1.0)
        return eta_min + (base_lr - eta_min) * 0.5 * (1.0 + math.cos(
            math.pi * frac))
    return schedule
