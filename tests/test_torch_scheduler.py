"""Port DPM-Solver++ (tclight_torch/diffusion/schedulers.py) against the
JAX package: the same sigma ladder and timesteps, and the same samples
step by step when the port is handed the SDE noise the JAX scheduler
draws from its keys. f32; tolerance 1e-5 relative (f32 scalar rounding of
the step coefficients)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclight_tpu.diffusion import schedulers as jsched
from tclight_torch.diffusion import schedulers as tsched

torch.set_num_threads(2)


@pytest.mark.parametrize("steps", [4, 25])
def test_ladder_and_timesteps_match(steps):
    j = jsched.DPMSolverMultistepScheduler(num_inference_steps=steps)
    t = tsched.DPMSolverMultistepScheduler(num_inference_steps=steps)
    np.testing.assert_array_equal(t.sigmas(), j.sigmas())
    np.testing.assert_array_equal(t.timesteps(), j.timesteps())


@pytest.mark.parametrize("algorithm", ["sde-dpmsolver++", "dpmsolver++"])
def test_steps_match_with_injected_noise(algorithm):
    steps = 6
    j = jsched.DPMSolverMultistepScheduler(num_inference_steps=steps,
                                           algorithm_type=algorithm)
    t = tsched.DPMSolverMultistepScheduler(num_inference_steps=steps,
                                           algorithm_type=algorithm)
    rng = np.random.default_rng(0)
    shape = (3, 8, 8, 4)
    x_j = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    x_t = torch.from_numpy(np.asarray(x_j))
    state_j, state_t = j.init_state(x_j), t.init_state(x_t)
    key = jax.random.PRNGKey(7)
    step = jax.jit(j.step)
    for _ in range(steps):
        eps = rng.standard_normal(shape).astype(np.float32)
        key, sub = jax.random.split(key)
        # the noise JAX's step draws from `sub`
        noise = np.asarray(jax.random.normal(sub, shape, jnp.float32))
        state_j, x_j = step(state_j, jnp.asarray(eps), x_j, sub)
        state_t, x_t = t.step(state_t, torch.from_numpy(eps), x_t,
                              torch.from_numpy(noise))
        ref = np.asarray(x_j)
        np.testing.assert_allclose(x_t.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()))
    assert state_t.step_index == int(state_j.step_index) == steps


def test_sde_step_needs_noise():
    t = tsched.DPMSolverMultistepScheduler(num_inference_steps=4)
    x = torch.zeros(1, 2, 2, 4)
    with pytest.raises(ValueError, match="noise"):
        t.step(t.init_state(x), x, x)
