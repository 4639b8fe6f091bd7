"""The port's post-optimization against the JAX package's on the same
seeded inputs (frames, flows, masks and track ids as numpy arrays, the
same PostOptConfig and seed, so both draw the same epoch permutations).

Tolerances and their reasons:
- one loss and its gradient: 1e-5 relative (f32 sums in another order);
- the loss histories of 3 epochs: 1e-4 relative;
- the frames after exposure alignment: 1e-4 (the Adam steps amplify the
  f32 differences of the gradients by lr / sqrt(v));
- the frames after UVT: 1e-4. The UVT Adam runs with eps=1e-15, so a
  palette entry whose gradient is ~0 takes a full-lr step in the
  direction of its sign: a gradient that cancels exactly in one package
  and leaves an ulp of residue in the other moves a pixel by
  lr * 0.28 ~ 1e-2 per step (feature_lr * batch / n = 0.033, SH2RGB's
  scale 0.28). The port's adjoints are exact gathers and its gather warp
  samples an integer flow exactly, as JAX's do, so no such step happens
  here and the frames agree to ~1e-6; the bound would catch one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclight_tpu.pipeline import postopt as jpo
from tclight_torch.ops.flow import voxelization
from tclight_torch.pipeline import postopt as po

torch.set_num_threads(2)


def _cfg(mod, **kw):
    base = dict(epochs_exposure=3, epochs=3, batch_size=4, ms_ssim_levels=2)
    base.update(kw)
    return mod.PostOptConfig(**base)


def _video(n=6, h=48, w=64, seed=0):
    """A texture rolling 2 px per frame under a per-frame gain, its exact
    past flows, soft masks, and the track ids of the roll."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.15, 0.85, (h, w, 3)).astype(np.float32)
    gains = np.linspace(0.8, 1.2, n).astype(np.float32)
    frames = np.stack([np.clip(np.roll(base, 2 * t, axis=1) * g, 0, 1)
                       for t, g in enumerate(gains)]).astype(np.float32)
    past = np.zeros((n, h, w, 2), np.float32)
    past[1:, ..., 0] = -2.0
    masks = rng.uniform(0.5, 1.0, (n, h, w)).astype(np.float32)
    masks[0] = 1.0
    ids = np.stack([np.roll(np.arange(h * w).reshape(h, w), 2 * t, axis=1)
                    for t in range(n)])
    unq_inv = voxelization(ids.reshape(-1))
    return frames, past, masks, unq_inv


def test_flow_radius_and_epoch_batches_match_jax():
    rng = np.random.default_rng(0)
    for scale in (0.0, 3.3, 17.0, 200.0):
        f = (rng.standard_normal((2, 4, 5, 2)) * scale).astype(np.float32)
        assert po.flow_radius(f) == jpo.flow_radius(f)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for n, bs in ((6, 4), (8, 16), (17, 16)):
        for a, b in zip(po._epoch_batches(n, bs, r1), jpo._epoch_batches(n, bs, r2)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("radius", [None, 4])
def test_exposure_loss_and_gradient_match_jax(radius):
    frames, past, masks, _ = _video()
    rng = np.random.default_rng(1)
    exposure = (np.eye(3, 4)[None] + 0.05 * rng.standard_normal((6, 3, 4))).astype(np.float32)
    idxs = np.array([3, 0, 5, 1])
    bmask = np.array([True, True, True, False])
    cfg, jcfg = _cfg(po), _cfg(jpo)
    ex = torch.from_numpy(exposure).requires_grad_(True)
    loss = po.exposure_loss(ex, torch.from_numpy(frames), torch.from_numpy(past),
                            torch.from_numpy(masks[..., None]), torch.from_numpy(idxs),
                            torch.from_numpy(bmask), cfg, radius)
    loss.backward()
    jl, jg = jax.value_and_grad(jpo.exposure_loss)(
        jnp.asarray(exposure), jnp.asarray(frames), jnp.asarray(past),
        jnp.asarray(masks[..., None]), jnp.asarray(idxs), jnp.asarray(bmask), jcfg, radius)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(ex.grad.numpy(), jg, atol=1e-5 * np.abs(jg).max())


@pytest.mark.parametrize("radius", [None, 4])
def test_run_exposure_align_matches_jax(radius):
    frames, past, masks, _ = _video()
    aligned, exposure, hist, times = po.run_exposure_align(
        torch.from_numpy(frames), torch.from_numpy(past), torch.from_numpy(masks),
        _cfg(po), seed=3, warp_radius=radius)
    ja, jexp, jhist, _ = jpo.run_exposure_align(
        jnp.asarray(frames), jnp.asarray(past), jnp.asarray(masks), _cfg(jpo), seed=3,
        warp_radius=radius)
    assert hist.shape == jhist.shape == (3 * 2,) and len(times) == 3
    np.testing.assert_allclose(hist, jhist, rtol=1e-4)
    np.testing.assert_allclose(exposure.numpy(), np.asarray(jexp), atol=1e-4)
    np.testing.assert_allclose(aligned.numpy(), np.asarray(ja), atol=1e-4)


def test_run_uvt_matches_jax():
    frames, past, masks, unq_inv = _video()
    n_unique = int(unq_inv.max()) + 1
    cfg, jcfg = _cfg(po, lambda_tv=0.05), _cfg(jpo, lambda_tv=0.05)
    out, hist, times = po.run_uvt(torch.from_numpy(frames), torch.from_numpy(past),
                                  torch.from_numpy(masks), unq_inv, n_unique, cfg, seed=2)
    jout, jhist, _ = jpo.run_uvt(jnp.asarray(frames), jnp.asarray(past), jnp.asarray(masks),
                                 unq_inv, n_unique, jcfg, seed=2)
    assert hist.shape == jhist.shape == (3 * 2,) and len(times) == 3
    np.testing.assert_allclose(hist, jhist, rtol=1e-4)
    assert out.shape == jout.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4)


def test_palette_routes_preserve_exact_zeros_with_collisions():
    """The dense route's adjoint against autograd of a plain gather, with
    many collisions and a zero band in the cotangent."""
    rng = np.random.default_rng(3)
    b, hw, p_pad = 4, 700, 256
    inv = rng.integers(0, 200, (b, hw)).astype(np.int32)
    inv_map, op, oi = po.palette_pixel_index(inv, p_pad)
    jmap, jop, joi = jpo.palette_pixel_index(inv, p_pad)
    for x, y in ((inv_map, jmap), (op, jop), (oi, joi)):
        np.testing.assert_array_equal(x, y)
    feats = torch.from_numpy(rng.standard_normal((p_pad, 3)).astype(np.float32))
    g = rng.standard_normal((b, hw, 3)).astype(np.float32)
    g[:, 100:200] = 0.0
    f_ref = feats.clone().requires_grad_(True)
    f_ref[torch.from_numpy(inv).long()].backward(torch.from_numpy(g))
    f_got = feats.clone().requires_grad_(True)
    po._DenseGather.apply(f_got, *(torch.from_numpy(a) for a in (inv, inv_map, op, oi))
                          ).backward(torch.from_numpy(g))
    np.testing.assert_allclose(f_got.grad.numpy(), f_ref.grad.numpy(), rtol=1e-5, atol=1e-5)
    assert np.array_equal(f_got.grad.numpy() == 0, f_ref.grad.numpy() == 0)


def test_palette_init_and_render_roundtrip():
    frames = torch.from_numpy(np.stack([np.full((4, 4, 3), 0.25, np.float32),
                                        np.full((4, 4, 3), 0.75, np.float32)]))
    unq_inv = torch.from_numpy(np.repeat(np.arange(2, dtype=np.int32), 16))
    feats = po.init_palette(frames, unq_inv, 2, pad_to=128)
    out = po.render_palette(feats, unq_inv, (2, 4, 4, 3))
    np.testing.assert_allclose(out.numpy(), frames.numpy(), atol=1e-5)


def _static_video(n=4, h=48, w=48):
    rng = np.random.default_rng(0)
    base = rng.uniform(0.2, 0.8, (h, w, 3)).astype(np.float32)
    gains = np.linspace(0.7, 1.3, n).astype(np.float32)
    frames = np.stack([np.clip(base * g, 0, 1) for g in gains])
    return frames, np.zeros((n, h, w, 2), np.float32), np.ones((n, h, w), np.float32)


@pytest.mark.parametrize("route", ["dense", "sorted"])
def test_uvt_static_video_converges_to_shared_palette(route, monkeypatch):
    """Every pixel of a static video is one track across time: the UVT
    forces all frames onto one palette (temporal std ~ 0) near the
    temporal mean. A sign-noisy adjoint would random-walk the palette
    under Adam's eps=1e-15 and fail this."""
    if route == "sorted":
        monkeypatch.setattr(po, "_DENSE_MAP_MAX_BYTES", 0)
    frames, flows, masks = _static_video()
    n, h, w, _ = frames.shape
    unq_inv = np.tile(np.arange(h * w, dtype=np.int32), n)
    cfg = _cfg(po, epochs=15, lambda_flow=0.5, lambda_tv=0.0)
    out, _, _ = po.run_uvt(torch.from_numpy(frames), torch.from_numpy(flows),
                           torch.from_numpy(masks), unq_inv, h * w, cfg, seed=0)
    out = out.numpy()
    assert out.std(axis=0).max() < 1e-4
    np.testing.assert_allclose(out[0], frames.mean(axis=0), atol=0.08)


def test_uvt_zero_epochs_noop():
    frames, flows, masks = _static_video(n=2)
    out, losses, _ = po.run_uvt(torch.from_numpy(frames), torch.from_numpy(flows),
                                torch.from_numpy(masks), np.zeros(frames.size // 3, np.int32),
                                1, _cfg(po, epochs=0))
    np.testing.assert_array_equal(out.numpy(), frames)
    assert losses.size == 0
