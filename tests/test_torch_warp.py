"""The port's flow warps against the JAX package's on the same seeded
inputs: the plain window warp (K3's plain version) forward and adjoint
against `window_warp_xla`, the window warp against the gather warp and the
adjoint against autograd of the gather warp, and the gather warp's sampler
against `grid_sample_2d`, out-of-frame taps included. Tolerance 1e-5
absolute on values of order 1: the same f32 arithmetic in another order
(grid_sample normalises coordinates to [-1, 1] and back)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclight_tpu.ops import resample as jresample
from tclight_tpu.ops import warp_kernel as jwarp
from tclight_torch.ops import kernels
from tclight_torch.ops import resample, warp_kernel
from tclight_torch.ops.flow import warp_flow

torch.set_num_threads(2)

TOL = 1e-5


def _case(seed=0, n=2, h=12, w=16, c=3, fmax=3.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, h, w, c)).astype(np.float32)
    f = rng.uniform(-fmax, fmax, (n, h, w, 2)).astype(np.float32)
    return x, f


@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
def test_kernel_fn_matches_jax(mode):
    s = np.linspace(-3, 3, 241).astype(np.float32)
    got = warp_kernel._kernel_fn(torch.from_numpy(s), mode).numpy()
    np.testing.assert_allclose(got, np.asarray(jwarp._kernel_fn(jnp.asarray(s), mode)),
                               atol=1e-7)


@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
@pytest.mark.parametrize("adjoint", [False, True])
def test_window_warp_plain_matches_xla(mode, adjoint):
    x, f = _case(c=3 if adjoint else 2)
    got = warp_kernel.window_warp_plain(torch.from_numpy(x), torch.from_numpy(f), 4,
                                        mode, adjoint)
    ref = jwarp.window_warp_xla(jnp.asarray(x), jnp.asarray(f), 4, mode, adjoint)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
def test_window_forward_is_the_gather_warp(mode):
    x, f = _case(1)
    xt, ft = torch.from_numpy(x), torch.from_numpy(f)
    win = warp_kernel.window_warp(xt, ft, 4, mode)
    np.testing.assert_allclose(win.numpy(), warp_flow(xt, ft, mode).numpy(), atol=TOL)


@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
def test_window_adjoint_is_autograd_of_the_gather_warp(mode):
    x, f = _case(2)
    g = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    ft = torch.from_numpy(f)
    (warp_flow(xt, ft, mode) * torch.from_numpy(g)).sum().backward()
    adj = warp_kernel.window_warp(torch.from_numpy(g), ft, 4, mode, adjoint=True)
    np.testing.assert_allclose(adj.numpy(), xt.grad.numpy(), atol=TOL)


def test_warp_flow_window_gradients():
    """The image gradient is the adjoint window sum; the flow gradient is
    zero (_warp_bwd); the plain path launches no kernel."""
    x, f = _case(4)
    g = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    ft = torch.from_numpy(f).requires_grad_(True)
    before = kernels.STATS["window_warp"].launches
    out = warp_flow(xt, ft, radius=4)
    (out * torch.from_numpy(g)).sum().backward()
    assert kernels.STATS["window_warp"].launches == before
    ref = jwarp.window_warp_xla(jnp.asarray(g), jnp.asarray(f), 4, adjoint=True)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), atol=TOL)
    assert (ft.grad == 0).all()


@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
def test_grid_sample_matches_jax(mode):
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 1, (2, 9, 13, 3)).astype(np.float32)
    # coordinates well outside the frame on every side
    coords = np.stack([rng.uniform(-4, 16, (2, 7, 5)), rng.uniform(-4, 12, (2, 7, 5))],
                      -1).astype(np.float32)
    got = resample.grid_sample_2d(torch.from_numpy(img), torch.from_numpy(coords), mode)
    ref = jresample.grid_sample_2d(jnp.asarray(img), jnp.asarray(coords), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    grid = resample.identity_grid(4, 6).numpy()
    np.testing.assert_array_equal(grid, np.asarray(jresample.identity_grid(4, 6)))


def test_window_warp_cuda_refuses_cpu_tensors():
    x, f = _case()
    with pytest.raises(ValueError, match="CUDA"):
        warp_kernel.window_warp_cuda(torch.from_numpy(x), torch.from_numpy(f), 4)
