"""The port's losses, colour ops and learning-rate schedule against the
JAX package's on the same seeded inputs. Values agree within 1e-5 (f32
convolutions and reductions in another order); MS-SSIM gradients within
1e-5 of the largest."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclight_tpu.ops import color as jcolor
from tclight_tpu.ops import losses as jlosses
from tclight_tpu.ops.schedules import expon_lr_schedule as jschedule
from tclight_torch.ops import color, losses
from tclight_torch.ops.schedules import expon_lr_schedule

torch.set_num_threads(2)


def _pair(seed=0, shape=(3, 48, 64, 3)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return a, b


def test_simple_losses_match_jax():
    a, b = _pair()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name in ("l1_loss", "l2_loss", "psnr"):
        np.testing.assert_allclose(float(getattr(losses, name)(ta, tb)),
                                   float(getattr(jlosses, name)(ja, jb)), rtol=1e-5)
    np.testing.assert_allclose(float(losses.tv_loss(ta, 0.3)),
                               float(jlosses.tv_loss(ja, 0.3)), rtol=1e-5)


@pytest.mark.parametrize("size_average", [True, False])
def test_ssim_matches_jax(size_average):
    a, b = _pair(1)
    got = losses.ssim(torch.from_numpy(a), torch.from_numpy(b), size_average=size_average)
    ref = jlosses.ssim(jnp.asarray(a), jnp.asarray(b), size_average=size_average)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("levels,start", [(2, 1), (3, 0), (3, 1)])
def test_relaxed_ms_ssim_and_gradient_match_jax(levels, start):
    a, b = _pair(2, (2, 45, 63, 3))  # odd sides: the padded average pool
    w = losses.MS_SSIM_WEIGHTS[:levels]

    def jfn(x):
        return jnp.sum(jlosses.relaxed_ms_ssim(x, jnp.asarray(b), start_level=start,
                                               data_range=1.0, size_average=False,
                                               weights=w) * jnp.arange(1.0, 3.0))

    ta = torch.from_numpy(a).requires_grad_(True)
    got = losses.relaxed_ms_ssim(ta, torch.from_numpy(b), start_level=start, data_range=1.0,
                                 size_average=False, weights=w)
    total = (got * torch.arange(1.0, 3.0)).sum()
    total.backward()
    ref, grad = jax.value_and_grad(jfn)(jnp.asarray(a))
    np.testing.assert_allclose(total.item(), float(ref), rtol=1e-5)
    grad = np.asarray(grad)
    np.testing.assert_allclose(ta.grad.numpy(), grad, atol=1e-5 * np.abs(grad).max())
    with pytest.raises(ValueError, match="too small"):
        losses.relaxed_ms_ssim(ta[:, :20], ta[:, :20], weights=losses.MS_SSIM_WEIGHTS)


def test_color_ops_match_jax():
    a, b = _pair(3, (2, 16, 20, 3))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(color.RGB2SH(ta).numpy(), np.asarray(jcolor.RGB2SH(ja)),
                               rtol=1e-6)
    np.testing.assert_allclose(color.SH2RGB(ta).numpy(), np.asarray(jcolor.SH2RGB(ja)),
                               rtol=1e-6)
    for got, ref in zip(color.calc_mean_std(ta), jcolor.calc_mean_std(ja)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    np.testing.assert_allclose(
        color.adaptive_instance_normalization(ta, tb).numpy(),
        np.asarray(jcolor.adaptive_instance_normalization(ja, jb)), atol=1e-5)
    # f32 normal equations: the fit agrees to ~1e-4
    np.testing.assert_allclose(color.color_correct(ta, tb).numpy(),
                               np.asarray(jcolor.color_correct(ja, jb)), atol=2e-4)


@pytest.mark.parametrize("delay_steps,delay_mult", [(0, 0.0), (5, 0.1)])
def test_expon_lr_schedule_matches_jax(delay_steps, delay_mult):
    ours = expon_lr_schedule(0.01, 0.001, delay_steps, delay_mult, 17)
    ref = jschedule(0.01, 0.001, delay_steps, delay_mult, 17)
    for step in (-1, 0, 1, 3, 8, 16, 17, 30):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6)
    assert expon_lr_schedule(0.0, 0.0)(3) == 0.0
