"""Multistep DPM-Solver++ (SDE variant, Karras sigmas) with explicit state
(counterpart of tclight_tpu/diffusion/schedulers.py).

Schedules are host numpy. `step` takes the SDE noise as a tensor: the
caller draws it from a `torch.Generator` or injects it (the tests inject
the noise the JAX package draws).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["NoiseSchedule", "karras_sigmas", "DPMState",
           "DPMSolverMultistepScheduler"]


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """VP schedule: x_t = sqrt(a_bar_t) x0 + sqrt(1 - a_bar_t) eps."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"

    def betas(self) -> np.ndarray:
        n = self.num_train_timesteps
        if self.beta_schedule == "scaled_linear":
            return np.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5, n) ** 2
        if self.beta_schedule == "linear":
            return np.linspace(self.beta_start, self.beta_end, n)
        raise ValueError(self.beta_schedule)

    def alphas_cumprod(self) -> np.ndarray:
        return np.cumprod(1.0 - self.betas())

    def sigmas(self) -> np.ndarray:
        ac = self.alphas_cumprod()
        return np.sqrt((1 - ac) / ac)


def karras_sigmas(sigma_min: float, sigma_max: float, n: int, rho: float = 7.0
                  ) -> np.ndarray:
    """rho-spaced sigma ladder (Karras et al. 2022), descending."""
    ramp = np.linspace(0, 1, n)
    min_inv, max_inv = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    return (max_inv + ramp * (min_inv - max_inv)) ** rho


def _sigma_to_t(sigma: np.ndarray, log_sigmas: np.ndarray) -> np.ndarray:
    log_sigma = np.log(np.maximum(sigma, 1e-10))
    dists = log_sigma[None, :] - log_sigmas[:, None]
    low_idx = np.clip((dists >= 0).cumsum(axis=0).argmax(axis=0), 0,
                      log_sigmas.shape[0] - 2)
    high_idx = low_idx + 1
    low, high = log_sigmas[low_idx], log_sigmas[high_idx]
    w = np.clip((low - log_sigma) / (low - high), 0, 1)
    return (1 - w) * low_idx + w * high_idx


class DPMState(NamedTuple):
    """Multistep carry: previous x0 prediction and the step index."""

    prev_x0: torch.Tensor
    has_prev: bool
    step_index: int


def _alpha_sigma(sigma: torch.Tensor):
    alpha = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
    return alpha, sigma * alpha


def _lam(alpha: torch.Tensor, sig: torch.Tensor) -> torch.Tensor:
    return torch.log(alpha) - torch.log(torch.clamp(sig, min=1e-10))


@dataclasses.dataclass(frozen=True)
class DPMSolverMultistepScheduler:
    """Multistep DPM-Solver++ (order 2, midpoint) with optional SDE noise
    and Karras sigma spacing."""

    schedule: NoiseSchedule = NoiseSchedule()
    num_inference_steps: int = 25
    algorithm_type: str = "sde-dpmsolver++"
    use_karras_sigmas: bool = True
    lower_order_final: bool = True
    rho: float = 7.0

    @property
    def sde(self) -> bool:
        return self.algorithm_type == "sde-dpmsolver++"

    def sigmas(self) -> np.ndarray:
        """Descending sigma ladder with terminal 0 appended (length n+1)."""
        train = self.schedule.sigmas()
        if self.use_karras_sigmas:
            s = karras_sigmas(float(train.min()), float(train.max()),
                              self.num_inference_steps, self.rho)
        else:
            idx = np.linspace(0, self.schedule.num_train_timesteps - 1,
                              self.num_inference_steps + 1
                              ).round().astype(int)[::-1][:-1]
            s = train[idx]
        return np.concatenate([s, [0.0]]).astype(np.float32)

    def timesteps(self) -> np.ndarray:
        """Float timesteps for the model, rounded like diffusers' Karras
        path."""
        train = self.schedule.sigmas()
        return _sigma_to_t(self.sigmas()[:-1], np.log(train)).round().astype(np.float32)

    def init_state(self, sample: torch.Tensor) -> DPMState:
        return DPMState(torch.zeros_like(sample), False, 0)

    def step(self, state: DPMState, eps: torch.Tensor, sample: torch.Tensor,
             noise: torch.Tensor | None = None
             ) -> tuple[DPMState, torch.Tensor]:
        """One update. `noise` (shaped like `sample`) is required by the SDE
        variant."""
        sigmas = torch.from_numpy(self.sigmas())  # f32 scalars, as in JAX
        i = state.step_index
        alpha_s0, sig_s0 = _alpha_sigma(sigmas[i])
        alpha_t, sig_t = _alpha_sigma(sigmas[i + 1])
        alpha_s1, sig_s1 = _alpha_sigma(sigmas[max(i - 1, 0)])
        x0 = (sample - sig_s0.item() * eps) / alpha_s0.item()

        lam_s0 = _lam(alpha_s0, sig_s0)
        h = _lam(alpha_t, sig_t) - lam_s0
        r0 = (lam_s0 - _lam(alpha_s1, sig_s1)) / (1.0 if h == 0 else h)
        if self.sde:
            e2h = torch.exp(-2.0 * h)
            c_sample = (sig_t / torch.clamp(sig_s0, min=1e-10)) * torch.exp(-h)
            c_d0 = alpha_t * (1.0 - e2h)
            noise_scale = sig_t * torch.sqrt(torch.clamp(1.0 - e2h, min=0.0))
        else:
            c_sample = sig_t / torch.clamp(sig_s0, min=1e-10)
            c_d0 = alpha_t * (1.0 - torch.exp(-h))
            noise_scale = torch.tensor(0.0)

        use_second = state.has_prev
        if self.lower_order_final:
            use_second = use_second and i < self.num_inference_steps - 1
        prev = c_sample.item() * sample + c_d0.item() * x0
        if use_second:
            d1 = (x0 - state.prev_x0) / (1.0 if r0 == 0 else r0.item())
            prev = prev + (0.5 * c_d0).item() * d1
        if self.sde:
            if noise is None:
                raise ValueError("sde-dpmsolver++ needs a noise tensor per step")
            prev = prev + noise_scale.item() * noise
        return DPMState(x0, True, i + 1), prev
