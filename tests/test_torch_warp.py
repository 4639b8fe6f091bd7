"""The port's flow warps against the JAX package's on the same seeded
inputs: the plain window warp (K3's plain version) forward and adjoint
against `window_warp_xla`, the window warp against the gather warp and the
adjoint against autograd of the gather warp, and the gather warp's sampler
against `grid_sample_2d`, out-of-frame taps included. Tolerance 1e-5
absolute on values of order 1: the same f32 arithmetic in another order
(grid_sample normalises coordinates to [-1, 1] and back)."""

import re
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


def _bounded_window_sum(x, f, radius, mode, adjoint):
    """The plain window sum with each tap d kept only at the pixels whose
    tile's `tile_tap_bounds` admit it: what K3 sums."""
    n, h, w, c = x.shape
    rh = radius + warp_kernel.kernel_radius(mode)
    th, tw = warp_kernel.TILE
    bounds = warp_kernel.tile_tap_bounds(f, radius, mode, adjoint)
    # the bounds of each pixel's tile, (N, H, W, 4)
    px = bounds.repeat_interleave(th, 1).repeat_interleave(tw, 2)[:, :h, :w]
    xp = torch.nn.functional.pad(x, (0, 0, rh, rh, rh, rh))
    fp = torch.nn.functional.pad(f, (0, 0, rh, rh, rh, rh))
    out = torch.zeros_like(x)
    for dy in range(-rh, rh + 1):
        for dx in range(-rh, rh + 1):
            keep = ((px[..., 0] <= dy) & (dy <= px[..., 1]) & (px[..., 2] <= dx)
                    & (dx <= px[..., 3]))
            if not keep.any():
                continue
            xs = xp[:, rh + dy: rh + dy + h, rh + dx: rh + dx + w]
            if adjoint:
                fs = fp[:, rh + dy: rh + dy + h, rh + dx: rh + dx + w]
                wgt = (warp_kernel._kernel_fn(dy + fs[..., 1], mode)
                       * warp_kernel._kernel_fn(dx + fs[..., 0], mode))
            else:
                wgt = (warp_kernel._kernel_fn(dy - f[..., 1], mode)
                       * warp_kernel._kernel_fn(dx - f[..., 0], mode))
            out = out + torch.where(keep, wgt, 0.0)[..., None] * xs
    return out


@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("radius,fmax,smooth", [(4, 4.0, True), (4, 3.0, False),
                                                (24, 24.0, False), (24, 20.0, True)])
def test_tile_tap_bounds_keep_every_weighted_tap(mode, adjoint, radius, fmax, smooth):
    """K3's premise: summing only the taps inside each 32 x 64 tile's flow-
    range bounds (`tile_tap_bounds`: the tile's range for the forward, its
    halo's for the adjoint) gives the whole window sum, on 2 x 40 x 150
    frames (tiles ragged in both axes) with smooth and random flows; the
    skipped taps carry weight exactly 0, so the sums agree within f32
    noise (1e-6). Smooth flows leave most taps out."""
    rng = np.random.default_rng(radius + int(fmax))
    x = torch.from_numpy(rng.uniform(0, 1, (2, 40, 150, 3)).astype(np.float32))
    if smooth:
        yy, xx = np.meshgrid(np.arange(40), np.arange(150), indexing="ij")
        f = np.stack([fmax * np.sin(xx / 37.0 + yy / 23.0), 0.6 * fmax * np.cos(xx / 29.0)], -1)
        f = np.broadcast_to(f, (2, 40, 150, 2)) * np.array([1.0, -1.0])[:, None, None, None]
        f = torch.from_numpy(np.ascontiguousarray(f, np.float32))
    else:
        f = torch.from_numpy(rng.uniform(-fmax, fmax, (2, 40, 150, 2)).astype(np.float32))
    full = warp_kernel.window_warp_plain(x, f, radius, mode, adjoint)
    bounded = _bounded_window_sum(x, f, radius, mode, adjoint)
    np.testing.assert_allclose(bounded.numpy(), full.numpy(), rtol=0, atol=1e-6)
    b = warp_kernel.tile_tap_bounds(f, radius, mode, adjoint)
    rh = radius + warp_kernel.kernel_radius(mode)
    assert b.shape == (2, 2, 3, 4) and (b[..., 0] >= -rh).all() and (b[..., 1] <= rh).all()
    if smooth and radius == 24:  # the smooth tiles' bounds are far inside the window
        assert ((b[..., 1] - b[..., 0]) < 2 * rh).all()


def test_tile_matches_the_kernel_source():
    """`TILE` is the kernel's adjoint output tile."""
    src = (kernels.CSRC / "window_warp.cu").read_text()
    assert f"constexpr int TH = {warp_kernel.TILE[0]}, TW = {warp_kernel.TILE[1]};" in src


@pytest.mark.parametrize("radius,mode,gscale", [(4, "bicubic", 1.0), (24, "bicubic", 1.0),
                                                (4, "bilinear", 1e-30),
                                                (24, "bilinear", 1e30)])
def test_adjoint_fixed_point_sums_hold_the_window_sum(radius, mode, gscale):
    """K3's adjoint premise: each term w * g scaled by its tile's 2^k
    (`adjoint_fixed_point_exponent`) and rounded to an integer T, its low L
    bits summed in an unsigned 32-bit limb and T >> L in a signed one (in
    any order: integer sums are exact), overflows neither limb, is within
    ntap half-units of the f64 sum of the same f32 terms, and gives the
    plain window sum within 1e-6 of max |g|; on 2 x 40 x 150 frames with
    random flows, cotangents of order 1, 1e-30 (k clamped at 126) and
    1e30."""
    rng = np.random.default_rng(radius)
    g = torch.from_numpy((rng.uniform(-1, 1, (2, 40, 150, 3)) * gscale).astype(np.float32))
    f = torch.from_numpy(rng.uniform(-radius, radius, (2, 40, 150, 2)).astype(np.float32))
    _assert_fixed_point_holds(g, f, radius, mode)


@pytest.mark.parametrize("mode,gscale", [("bicubic", 1.0), ("bilinear", 1.0),
                                         ("bicubic", 1e-30), ("bicubic", 1e30)])
def test_adjoint_one_limb_sums_hold_the_window_sum(mode, gscale):
    """Below 64 taps a tile sums its terms in one signed 32-bit limb (L = 0,
    k = 31 - bitlen(ntap) - e1): on 2 x 40 x 150 frames with smooth flows of
    under a pixel's range per halo (as the post-optimization's Farneback
    flows), every tile takes it, its sums do not overflow, and they give the
    plain window sum within 1e-6 of max |g|."""
    rng = np.random.default_rng(7)
    g = torch.from_numpy((rng.uniform(-1, 1, (2, 40, 150, 3)) * gscale).astype(np.float32))
    yy, xx = np.meshgrid(np.arange(40), np.arange(150), indexing="ij")
    f = np.stack([-0.6 + 0.3 * np.sin(xx / 50.0), 0.2 * np.cos(yy / 30.0)], -1)
    f = torch.from_numpy(np.broadcast_to(f, (2, 40, 150, 2)).astype(np.float32).copy())
    k, low_bits = warp_kernel.adjoint_fixed_point_exponent(g, f, 4, mode)
    assert (low_bits == 0).all()
    _assert_fixed_point_holds(g, f, 4, mode)


def _assert_fixed_point_holds(g, f, radius, mode):
    """The limbs of `adjoint_fixed_point_exponent` (one, or low and high)
    overflow nowhere, their total is within ntap half-units of the f64 sum
    of the same f32 terms, and it gives the plain window sum within 1e-6 of
    max |g|."""
    n, h, w, _ = g.shape
    th, tw = warp_kernel.TILE
    rh = radius + warp_kernel.kernel_radius(mode)

    def per_pixel(t):
        return t.repeat_interleave(th, 1).repeat_interleave(tw, 2)[:, :h, :w, None]

    k, low_bits = warp_kernel.adjoint_fixed_point_exponent(g, f, radius, mode)
    k, low_bits = per_pixel(k), per_pixel(low_bits)
    bounds = warp_kernel.tile_tap_bounds(f, radius, mode, adjoint=True)
    ntap = per_pixel((bounds[..., 1] - bounds[..., 0] + 1) * (bounds[..., 3] - bounds[..., 2] + 1))
    up = torch.exp2(k.float())
    gp = torch.nn.functional.pad(g, (0, 0, rh, rh, rh, rh))
    fp = torch.nn.functional.pad(f, (0, 0, rh, rh, rh, rh))
    low = torch.zeros(g.shape, dtype=torch.int64)
    high = torch.zeros(g.shape, dtype=torch.int64)
    exact = torch.zeros(g.shape, dtype=torch.float64)
    for dy in range(-rh, rh + 1):
        for dx in range(-rh, rh + 1):
            gs = gp[:, rh + dy: rh + dy + h, rh + dx: rh + dx + w]
            fs = fp[:, rh + dy: rh + dy + h, rh + dx: rh + dx + w]
            wgt = (warp_kernel._kernel_fn(dy + fs[..., 1], mode)
                   * warp_kernel._kernel_fn(dx + fs[..., 0], mode))[..., None]
            term = wgt * (gs * up)  # f32, as the kernel rounds it
            t = torch.round(term).long()
            low += t & ((1 << low_bits) - 1)
            high += t >> low_bits
            exact += term.double()
    assert (low < 2 ** 32).all() and (high.abs() < 2 ** 31).all()
    total = (high << low_bits) + low
    assert ((total.double() - exact).abs() <= 0.5 * ntap).all()
    got = total.double() * torch.exp2(-k.double())
    ref = warp_kernel.window_warp_plain(g, f, radius, mode, adjoint=True).double()
    assert (got - ref).abs().max().item() <= 1e-6 * g.abs().max().item()


def test_k3_argtypes_match_the_c_entry_point():
    """ctypes passes what `K3_ARGTYPES` says: one type per C parameter."""
    src = (kernels.CSRC / "window_warp.cu").read_text()
    m = re.search(r'extern "C" int tclight_window_warp_f32\(([^)]*)\)', src)
    assert m and len(m.group(1).split(",")) == len(warp_kernel.K3_ARGTYPES)


def test_ablate_postopt_k3_variants_apply_to_the_kernel():
    """`ablate_postopt`'s K3 variants for this kernel find their texts in
    its source, and each changes it."""
    from tclight_torch import ablate_postopt

    texts = ablate_postopt.variant_sources("K3", list(ablate_postopt.K3_VARIANTS))
    assert {"base", "noatomic", "nocvt", "norange", "noscatter", "twolimb", "walkonly",
            "tile16x32"} <= set(texts)
    assert all(text != texts["base"] for name, text in texts.items() if name != "base")


def test_window_warp_cuda_refuses_cpu_tensors():
    x, f = _case()
    with pytest.raises(ValueError, match="CUDA"):
        warp_kernel.window_warp_cuda(torch.from_numpy(x), torch.from_numpy(f), 4)
