"""EDM diffusion core: sigma scaling, rho-spaced timesteps and the samplers
(counterpart of tclight_tpu/cosmos/edm.py): Euler, Heun (RK2), the RES
family of Runge-Kutta solvers, and the second-order multistep update.

Model contract: `x0_fn(x, sigma) -> x0 prediction` (the CFG-combined x0
function). The loops run in Python over the sigma ladder; the sigmas and
every per-step coefficient are f32 scalars, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

__all__ = ["EDMScaling", "rho_timesteps", "sample_edm", "SolverConfig", "sample_res",
           "RK_SOLVERS", "MULTISTEP_SOLVERS"]

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class EDMScaling:
    """c_skip / c_out / c_in / c_noise coefficients (Karras et al. 2022)."""

    sigma_data: float = 0.5

    def __call__(self, sigma: torch.Tensor):
        sigma = sigma.float()
        sd2 = self.sigma_data ** 2
        c_skip = sd2 / (sigma ** 2 + sd2)
        c_out = sigma * self.sigma_data / torch.sqrt(sigma ** 2 + sd2)
        c_in = 1.0 / torch.sqrt(sigma ** 2 + sd2)
        c_noise = 0.25 * torch.log(sigma)
        return c_skip, c_out, c_in, c_noise


def rho_timesteps(sigma_max: float = 80.0, sigma_min: float = 0.002, n: int = 35,
                  rho: float = 7.0) -> np.ndarray:
    """Descending rho-spaced sigma ladder with a terminal 0."""
    ramp = np.linspace(0, 1, n)
    sig = (sigma_max ** (1 / rho) + ramp * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
    return np.concatenate([sig, [0.0]]).astype(np.float32)


def _euler_step(x0_fn, x, s_cur, s_next):
    x0 = x0_fn(x, s_cur)
    d = (x - x0) / float(s_cur)
    return x + d * float(f32(s_next - s_cur)), x0


# ------------------------------------------------- RES solver family


def _phi1(t):
    return f32(np.expm1(f32(t)) / f32(t))


def _phi2(t):
    return f32((_phi1(t) - f32(1.0)) / f32(t))


def _reg_x0_euler_step(x_s, s, t, x0_s):
    """x' = (s - t) / s * x0 + t / s * x."""
    return float(f32((s - t) / s)) * x0_s + float(f32(t / s)) * x_s, x0_s


def _reg_eps_euler_step(x_s, s, t, eps_s):
    return x_s + eps_s * float(f32(t - s)), x_s + eps_s * float(f32(0 - s))


def _res_x0_rk2_step(x_s, t, s, x0_s, s1, x0_s1):
    """Residual exponential-integrator RK2 update."""
    with np.errstate(divide="ignore", invalid="ignore"):
        ls, lt, lm = -np.log(f32(s)), -np.log(f32(t)), -np.log(f32(s1))
        dt = f32(lt - ls)
        c2 = f32((lm - ls) / dt)
        p1, p2 = _phi1(-dt), _phi2(-dt)
        b1 = np.nan_to_num(f32(p1 - p2 / c2))
        b2 = np.nan_to_num(f32(p2 / c2))
    out = float(np.exp(-dt)) * x_s + float(dt) * (float(b1) * x0_s + float(b2) * x0_s1)
    return out.to(x_s.dtype)


def _rk1_euler(x_s, s, t, x0_fn):
    x0_s = x0_fn(x_s, s)
    return _reg_x0_euler_step(x_s, s, t, x0_s)


def _rk2_mid_stable(x_s, s, t, x0_fn):
    s1 = f32(np.sqrt(f32(s * t)))
    x_s1, _ = _rk1_euler(x_s, s, s1, x0_fn)
    x0_s1 = x0_fn(x_s1, s1)
    return _reg_x0_euler_step(x_s, s, t, x0_s1)


def _rk2_mid(x_s, s, t, x0_fn):
    s1 = f32(np.sqrt(f32(s * t)))
    x_s1, x0_s = _rk1_euler(x_s, s, s1, x0_fn)
    x0_s1 = x0_fn(x_s1, s1)
    return _res_x0_rk2_step(x_s, t, s, x0_s, s1, x0_s1), x0_s1


def _rk_2heun_naive(x_s, s, t, x0_fn):
    x_t, x0_s = _rk1_euler(x_s, s, t, x0_fn)
    # the reference estimates eps at s from x_t; kept for parity
    eps_s = (x_t - x0_s) / float(s)
    x0_t = x0_fn(x_t, t)
    eps_t = (x_t - x0_t) / float(t)
    return _reg_eps_euler_step(x_s, s, t, (eps_s + eps_t) / 2)


def _rk_2heun_edm(x_s, s, t, x0_fn):
    x_t, x0_s = _rk1_euler(x_s, s, t, x0_fn)
    x0_t = x0_fn(x_t, t)
    return _reg_x0_euler_step(x_s, s, t, (x0_s + x0_t) / 2)


def _rk_3kutta_naive(x_s, s, t, x0_fn):
    c2, c3 = f32(0.5), f32(1.0)
    a31, a32 = -1.0, 2.0
    b1, b2, b3 = 1.0 / 6, 4.0 / 6, 1.0 / 6
    delta = f32(t - s)
    s1 = f32(c2 * delta + s)
    s2 = f32(c3 * delta + s)
    x_s1, x0_s = _rk1_euler(x_s, s, s1, x0_fn)
    eps_s = (x_s - x0_s) / float(s)
    x0_s1 = x0_fn(x_s1, s1)
    eps_s1 = (x_s1 - x0_s1) / float(s1)
    x_s2, _ = _reg_eps_euler_step(x_s, s, s2, a31 * eps_s + a32 * eps_s1)
    x0_s2 = x0_fn(x_s2, s2)
    eps_s2 = (x_s2 - x0_s2) / float(s2)
    avg_eps = b1 * eps_s + b2 * eps_s1 + b3 * eps_s2
    return _reg_eps_euler_step(x_s, s, t, avg_eps)


RK_SOLVERS = {
    "1euler": _rk1_euler,
    "2mid": _rk2_mid,
    "2mid_stable": _rk2_mid_stable,
    "2heun_edm": _rk_2heun_edm,
    "2heun_naive": _rk_2heun_naive,
    "3kutta_naive": _rk_3kutta_naive,
}


def _multistep_2ab(x_s, s, t, x0_s, prev):
    """AB2 over x0 predictions; `prev` = (x0_s1, s1) of the step before,
    or None at the first step."""
    if prev is None:
        x_t, _ = _reg_x0_euler_step(x_s, s, t, x0_s)
    else:
        x0_s1, s1 = prev
        x_t = _res_x0_rk2_step(x_s, t, s, x0_s, s1, x0_s1)
    return x_t, (x0_s, s)


MULTISTEP_SOLVERS = {"2ab": _multistep_2ab}


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """The reference's SolverConfig."""

    is_multi: bool = False
    rk: str = "2mid"
    multistep: str = "2ab"
    s_churn: float = 0.0
    s_t_max: float = float("inf")
    s_t_min: float = 0.05
    s_noise: float = 1.0


def sample_res(x0_fn: Callable, x_sigma_max: torch.Tensor, sigmas: np.ndarray | None = None,
               cfg: SolverConfig = SolverConfig(), generator: torch.Generator | None = None,
               sample_clean: bool = True,
               churn_noises: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
    """The reference Sampler: RK / multistep steps over a rho-spaced sigma
    ladder, optional EDM stochastic churn, and a final clean x0
    evaluation. `x_sigma_max` is the noised input at sigmas[0]. The
    churn's Gaussian noise of step i is `churn_noises[i]` when given, else
    drawn from `generator`."""
    if sigmas is None:
        sigmas = rho_timesteps()[:-1]  # the RES ladder ends at sigma_min, not 0
    sigmas = np.asarray(sigmas, np.float32)
    num_step = len(sigmas) - 1
    eta = min(cfg.s_churn / (num_step + 1), float(np.sqrt(1.2) - 1.0))
    use_churn = cfg.s_churn > 0
    if use_churn and generator is None and churn_noises is None:
        raise ValueError("stochastic churn (s_churn > 0) needs a generator or churn_noises")
    step_rk = RK_SOLVERS[cfg.rk]
    step_ms = MULTISTEP_SOLVERS[cfg.multistep]
    x, prev = x_sigma_max, None
    for i in range(num_step):
        s_cur, s_next = sigmas[i], sigmas[i + 1]
        if use_churn:
            s_hat = f32(s_cur + f32(eta) * s_cur) if cfg.s_t_min < s_cur < cfg.s_t_max else s_cur
            noise = (churn_noises[i].to(x) if churn_noises is not None else
                     torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device))
            x = x + float(f32(np.sqrt(max(f32(s_hat ** 2 - s_cur ** 2), 0.0)))) * cfg.s_noise * noise
            s_cur = s_hat
        if cfg.is_multi:
            x0 = x0_fn(x, s_cur)
            x, prev = step_ms(x, s_cur, s_next, x0, prev)
        else:
            x, _ = step_rk(x, s_cur, s_next, x0_fn)
    if sample_clean:
        x = x0_fn(x, sigmas[-1])
    return x


def sample_edm(x0_fn: Callable, noise: torch.Tensor, sigmas: np.ndarray | None = None,
               solver: str = "heun", on_step: Callable[[int], None] | None = None
               ) -> torch.Tensor:
    """Deterministic EDM sampling from pure noise (`noise` ~ N(0, I)).
    'heun' is second-order Runge-Kutta with an Euler last step;
    'multistep' second-order Adams-Bashforth over the x0 trajectory.
    `on_step(i)` is called after step i."""
    on_step = on_step or (lambda i: None)
    if sigmas is None:
        sigmas = rho_timesteps()
    sigmas = np.asarray(sigmas, np.float32)
    x = noise * float(sigmas[0])
    n = len(sigmas) - 1
    if solver == "euler":
        for i in range(n):
            x, _ = _euler_step(x0_fn, x, sigmas[i], sigmas[i + 1])
            on_step(i)
        return x
    if solver == "heun":
        for i in range(n):
            s_cur, s_next = sigmas[i], sigmas[i + 1]
            x0 = x0_fn(x, s_cur)
            d = (x - x0) / float(s_cur)
            x_eul = x + d * float(f32(s_next - s_cur))
            if s_next > 0:
                x0_2 = x0_fn(x_eul, s_next)
                d2 = (x_eul - x0_2) / float(s_next)
                x = x + 0.5 * (d + d2) * float(f32(s_next - s_cur))
            else:
                x = x_eul
            on_step(i)
        return x
    if solver == "multistep":
        x0_prev = None
        for i in range(n):
            s_cur, s_next = sigmas[i], sigmas[i + 1]
            x0 = x0_fn(x, s_cur)
            d = (x - x0) / float(s_cur)
            if x0_prev is None:
                x = x + d * float(f32(s_next - s_cur))
            else:
                d_prev = (x - x0_prev) / float(s_cur)
                x = x + (1.5 * d - 0.5 * d_prev) * float(f32(s_next - s_cur))
            x0_prev = x0
            on_step(i)
        return x
    raise ValueError(solver)
