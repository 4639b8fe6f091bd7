"""Learning-rate schedules (counterpart of tclight_tpu/ops/schedules.py).

`expon_lr_schedule` is the Plenoxels log-lerp decay with an optional
delay, used by the exposure alignment. It returns a function step -> lr
(a Python float), computed in float32 as the JAX schedule is, so both
packages step with the same rates.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["expon_lr_schedule"]


def expon_lr_schedule(lr_init: float, lr_final: float, lr_delay_steps: int = 0,
                      lr_delay_mult: float = 1.0, max_steps: int = 1_000_000):
    """Log-linear interpolation from lr_init (step 0) to lr_final (step
    max_steps), eased in over `lr_delay_steps`."""
    f32 = np.float32
    if lr_init == 0.0 and lr_final == 0.0:
        return lambda step: 0.0
    log_init, log_final = np.log(f32(lr_init)), np.log(f32(lr_final))

    def schedule(step) -> float:
        step = f32(step)
        if step < 0:
            return 0.0
        if lr_delay_steps > 0:
            frac = np.clip(step / f32(lr_delay_steps), f32(0.0), f32(1.0))
            delay_rate = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
                f32(0.5 * math.pi) * frac)
        else:
            delay_rate = f32(1.0)
        t = np.clip(step / f32(max_steps), f32(0.0), f32(1.0))
        log_lerp = np.exp(log_init * (f32(1) - t) + log_final * t)
        return float(f32(delay_rate * log_lerp))

    return schedule
