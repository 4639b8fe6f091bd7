"""The port's flow machinery against the JAX package's on the same seeded
inputs: the gather warp, the consistency and soft masks (whole-video,
pairwise with a window radius, and chunked), the track propagation and
the voxelization. Warps agree within 1e-5 (f32 taps summed in another
order); soft masks within 1e-4: they are sigmoids of beta = 100 times flow
norms of order 1, whose slope of up to 25 turns the ~1e-6 f32 differences
of the norms and warps into ~5e-5; hard masks, track ids and unique maps
exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclight_tpu.ops import flow as jflow
from tclight_torch.ops import flow

torch.set_num_threads(2)


def _clip(n=5, h=24, w=32, seed=0):
    """A smooth texture shifted by a sub-pixel motion per frame, with
    noisy forward and past flows."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = np.stack([
        np.stack([0.5 + 0.4 * np.sin((xx - 1.3 * t) / 3.0 + c) * np.cos(yy / 4.0)
                  for c in range(3)], -1) for t in range(n)]).astype(np.float32)
    fwd = np.zeros((n, h, w, 2), np.float32)
    fwd[..., 0] = 1.3
    fwd += 0.2 * rng.standard_normal(fwd.shape).astype(np.float32)
    past = -fwd + 0.1 * rng.standard_normal(fwd.shape).astype(np.float32)
    return frames, fwd, past


def test_warp_flow_gather_matches_jax():
    frames, fwd, _ = _clip()
    got = flow.warp_flow(torch.from_numpy(frames), torch.from_numpy(fwd))
    ref = jflow.warp_flow(jnp.asarray(frames), jnp.asarray(fwd))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_hard_masks_match_jax():
    frames, fwd, past = _clip(seed=1)
    t = [torch.from_numpy(a) for a in (frames, fwd, past)]
    j = [jnp.asarray(a) for a in (frames, fwd, past)]
    for got, ref in zip(flow.compute_fwdbwd_mask(t[1], t[2]),
                        jflow.compute_fwdbwd_mask(j[1], j[2])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(flow.get_mask_bwds(*t).numpy(),
                                  np.asarray(jflow.get_mask_bwds(*j)))


def test_soft_masks_match_jax():
    frames, fwd, past = _clip(seed=2)
    got = flow.get_soft_mask_bwds(*(torch.from_numpy(a) for a in (frames, fwd, past)))
    ref = jflow.get_soft_mask_bwds(*(jnp.asarray(a) for a in (frames, fwd, past)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_soft_mask_pairs_with_window_radius_match_jax():
    """The window-warp form the card runs (K3's plain version here)."""
    frames, fwd, past = _clip(seed=3)
    args = (frames[:-1], frames[1:], fwd[:-1], past[1:])
    gmax = float(frames.max())
    got = flow.get_soft_mask_pairs(*(torch.from_numpy(a) for a in args), gmax, radius=4)
    ref = jflow.get_soft_mask_pairs(*(jnp.asarray(a) for a in args), jnp.float32(gmax),
                                    radius=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    assert flow.flow_radius(fwd, past) == 4
    assert flow.flow_radius(fwd * 100, past) is None


@pytest.mark.parametrize("chunk", [2, 8])
def test_soft_masks_chunked_match_jax(chunk):
    frames, fwd, past = _clip(n=7, seed=4)
    got = flow.get_soft_mask_bwds_chunked(frames, fwd, past, chunk=chunk, device="cpu")
    ref = jflow.get_soft_mask_bwds_chunked(frames, fwd, past, chunk=chunk)
    assert got.dtype == np.float32 and got.shape == frames.shape[:3]
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_get_flowid_matches_jax():
    """An integer shift gives each target one source pixel, so the
    propagation is deterministic in both packages."""
    rng = np.random.default_rng(5)
    n, h, w = 4, 12, 16
    base = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    frames = np.stack([np.roll(base, t, axis=1) for t in range(n)])
    fwd = np.zeros((n, h, w, 2), np.float32)
    fwd[..., 0] = 1.0
    masks = (rng.uniform(0, 1, (n, h, w)) > 0.2).astype(np.float32)
    got = flow.get_flowid(*(torch.from_numpy(a) for a in (frames, fwd, masks)))
    ref = jflow.get_flowid(*(jnp.asarray(a) for a in (frames, fwd, masks)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(flow.voxelization(got.numpy().reshape(-1)),
                                  jflow.voxelization(np.asarray(ref).reshape(-1)))


def test_voxelization_with_voxels_matches_jax():
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 50, 400)
    rgb = rng.uniform(0, 1, (400, 3)).astype(np.float32)
    coord = rng.uniform(0, 10, (400, 3)).astype(np.float32)
    inst = rng.integers(0, 2, 400)
    for kw in (dict(), dict(voxel_size=2.0), dict(instance_ids=inst)):
        np.testing.assert_array_equal(
            flow.voxelization(ids, rgb, coord, **kw), jflow.voxelization(ids, rgb, coord, **kw))
