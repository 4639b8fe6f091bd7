"""Diffusion samplers with explicit state (counterpart of
tclight_tpu/diffusion/schedulers.py): multistep DPM-Solver++ (SDE variant,
Karras sigmas), IC-Light's sampler; deterministic DDIM (eta = 0,
leading-spaced timesteps) for the inversion and the generic-SD editing path.

Schedules are host numpy. `step` takes the SDE noise as a tensor: the
caller draws it from a `torch.Generator` or injects it (the tests inject
the noise the JAX package draws). `sde` says whether a scheduler needs it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["NoiseSchedule", "karras_sigmas", "DDIMScheduler", "DDIMStateScheduler",
           "DPMState", "DPMSolverMultistepScheduler"]


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


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class DDIMScheduler:
    """Deterministic DDIM (eta = 0), epsilon prediction, leading-spaced
    timesteps (JAX's DDIMScheduler)."""

    schedule: NoiseSchedule = NoiseSchedule()
    num_inference_steps: int = 50

    def timesteps(self) -> np.ndarray:
        step = self.schedule.num_train_timesteps // self.num_inference_steps
        return (np.arange(0, self.num_inference_steps) * step).round()[::-1].astype(np.int64)

    def alphas_cumprod(self) -> np.ndarray:
        """The train schedule's alpha-bars in f32, as JAX indexes them."""
        return self.schedule.alphas_cumprod().astype(np.float32)

    def step(self, eps: torch.Tensor, t_idx: int, sample: torch.Tensor,
             inversion: bool = False) -> torch.Tensor:
        """One update at `timesteps()[t_idx]`: x_t -> x_{t - step}, or with
        `inversion` x_t -> x_{t + step} (from the less noisy timestep
        t - step, whose alpha-bar is 1 below 0)."""
        ac = self.alphas_cumprod()
        n_step = self.schedule.num_train_timesteps // self.num_inference_steps
        t = int(self.timesteps()[t_idx])
        a_at = lambda i: ac[i] if i >= 0 else np.float32(1.0)
        a_t, a_next = (a_at(t - n_step), ac[t]) if inversion else (ac[t], a_at(t - n_step))
        a_t, a_next = _f32(a_t), _f32(a_next)
        x0 = (sample - torch.sqrt(1 - a_t).item() * eps) / torch.sqrt(a_t).item()
        return torch.sqrt(a_next).item() * x0 + torch.sqrt(1 - a_next).item() * eps

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: int) -> torch.Tensor:
        a = _f32(self.alphas_cumprod()[t])
        return torch.sqrt(a).item() * x0 + torch.sqrt(1 - a).item() * noise


@dataclasses.dataclass(frozen=True)
class DDIMStateScheduler:
    """DDIM behind the DPM-Solver's (init_state, step) protocol, so the
    Generator samples with either: the generic-SD editing path's sampler
    (JAX's DDIMStateScheduler). The state is the step index."""

    schedule: NoiseSchedule = NoiseSchedule()
    num_inference_steps: int = 50
    sde = False

    def _inner(self) -> DDIMScheduler:
        return DDIMScheduler(self.schedule, self.num_inference_steps)

    def timesteps(self) -> np.ndarray:
        return self._inner().timesteps().astype(np.float32)

    def init_state(self, sample: torch.Tensor) -> int:
        return 0

    def step(self, state: int, eps: torch.Tensor, sample: torch.Tensor,
             noise: torch.Tensor | None = None) -> tuple[int, torch.Tensor]:
        """(state + 1, x_{t - step}); deterministic, `noise` is unused."""
        return state + 1, self._inner().step(eps, state, sample)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: int) -> torch.Tensor:
        return self._inner().add_noise(x0, noise, t)


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

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, step_index: int
                  ) -> torch.Tensor:
        """A clean sample noised to the ladder position `step_index`."""
        alpha, sig = _alpha_sigma(torch.from_numpy(self.sigmas())[step_index])
        return alpha.item() * x0 + sig.item() * noise
