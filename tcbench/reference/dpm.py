"""Multistep DPM-Solver++ of order 2 with SDE noise on Karras sigmas
(diffusers' DPMSolverMultistepScheduler with algorithm_type
"sde-dpmsolver++", use_karras_sigmas, lower_order_final), written out for
one step from its state."""

from __future__ import annotations

import math

import numpy as np
import torch


def train_sigmas(n_train: int = 1000, beta_start: float = 0.00085,
                 beta_end: float = 0.012) -> np.ndarray:
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, n_train) ** 2
    ac = np.cumprod(1.0 - betas)
    return np.sqrt((1 - ac) / ac)


def sigmas(n_steps: int, rho: float = 7.0) -> np.ndarray:
    """The descending Karras ladder and a final 0, float32 (n_steps + 1)."""
    train = train_sigmas()
    lo, hi = float(train.min()) ** (1 / rho), float(train.max()) ** (1 / rho)
    ladder = (hi + np.linspace(0, 1, n_steps) * (lo - hi)) ** rho
    return np.concatenate([ladder, [0.0]]).astype(np.float32)


def timesteps(n_steps: int) -> np.ndarray:
    """Each sigma's fractional train timestep, by linear interpolation in
    log sigma, rounded (diffusers' `_sigma_to_t`)."""
    log_train = np.log(train_sigmas())
    out = []
    for s in sigmas(n_steps)[:-1]:
        ls = math.log(max(float(s), 1e-10))
        low = int(np.clip(np.sum(ls >= log_train) - 1, 0, len(log_train) - 2))
        w = np.clip((log_train[low] - ls) / (log_train[low] - log_train[low + 1]), 0, 1)
        out.append(round((1 - w) * low + w * (low + 1)))
    return np.asarray(out, np.float32)


def _alpha_sigma_lambda(s: float) -> tuple[float, float, float]:
    alpha = 1.0 / math.sqrt(s * s + 1.0)
    sig = s * alpha
    return alpha, sig, math.log(alpha) - math.log(max(sig, 1e-10))


def x0_of(sample: torch.Tensor, eps: torch.Tensor, i: int, n_steps: int) -> torch.Tensor:
    """The data prediction of step i from its sample and noise prediction."""
    alpha, sig, _ = _alpha_sigma_lambda(float(sigmas(n_steps)[i]))
    return (sample - sig * eps) / alpha


def step(i: int, n_steps: int, sample: torch.Tensor, eps: torch.Tensor,
         prev_x0: torch.Tensor | None, noise: torch.Tensor) -> torch.Tensor:
    """x at step i + 1 from x at step i, its noise prediction, the previous
    step's data prediction (None at step 0) and the step's SDE noise."""
    sg = sigmas(n_steps)
    a0, s0, l0 = _alpha_sigma_lambda(float(sg[i]))
    a1, s1, l1 = _alpha_sigma_lambda(float(sg[i + 1]))
    x0 = (sample - s0 * eps) / a0
    h = l1 - l0
    e2h = math.exp(-2.0 * h)
    c_d = a1 * (1.0 - e2h)
    out = (s1 / max(s0, 1e-10)) * math.exp(-h) * sample + c_d * x0
    if prev_x0 is not None and i < n_steps - 1:
        _, _, lp = _alpha_sigma_lambda(float(sg[i - 1]))
        r0 = (l0 - lp) / h
        out = out + 0.5 * c_d * (x0 - prev_x0) / r0
    return out + s1 * math.sqrt(max(1.0 - e2h, 0.0)) * noise
