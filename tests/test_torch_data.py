"""The port's data layer against the JAX package's: the native track code
(the port's own g++ build of its copy of flowid.cpp) numbers tracks as
the JAX package's native code and its jitted `get_flowid` do; Farneback
flows are identical; `load_data` gives the same flows, soft masks (within
1e-4, see tests/test_torch_flow.py) and track ids, through a flow cache
that either package reads from the other."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclight_tpu import native as jnative
from tclight_tpu.data import flow_backends as jbackends
from tclight_tpu.data.dataparsers import VideoDataParser as JParser
from tclight_tpu.ops import flow as jflow
from tclight_torch import native
from tclight_torch.data import flow_backends
from tclight_torch.data.dataparsers import VideoDataParser, make_data_parser
from tclight_torch.utils.video_io import save_frames

torch.set_num_threads(2)


def _frames(n=5, h=24, w=32, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.1, 0.9, (h, w, 3)).astype(np.float32)
    import cv2

    base = cv2.GaussianBlur(base, (0, 0), 1.5)
    return np.stack([np.roll(base, 2 * t, axis=1) for t in range(n)]).astype(np.float32)


def test_native_tracks_match_jax():
    frames = _frames()
    rng = np.random.default_rng(1)
    fwd = np.zeros(frames.shape[:3] + (2,), np.float32)
    fwd[..., 0] = 2.0 + 0.3 * rng.standard_normal(frames.shape[:3]).astype(np.float32)
    masks = rng.uniform(0, 1, frames.shape[:3]).astype(np.float32)
    ids = native.get_flowid_native(frames, fwd, masks)
    np.testing.assert_array_equal(ids, jnative.get_flowid_native(frames, fwd, masks))
    inv, nu = native.unique_inverse_native(ids)
    jinv, jnu = jnative.unique_inverse_native(ids)
    assert nu == jnu
    np.testing.assert_array_equal(inv, jinv)
    np.testing.assert_array_equal(inv, jflow.voxelization(ids.reshape(-1)))
    vals = rng.uniform(0, 1, (ids.size, 3)).astype(np.float32)
    np.testing.assert_allclose(native.segment_mean_native(vals, inv, nu),
                               jnative.segment_mean_native(vals, jinv, jnu), rtol=1e-6)
    assert native._lib_path().parent.name == "tclight_torch"


def test_native_tracks_match_jitted_flowid_on_integer_motion():
    frames = _frames(seed=2)
    fwd = np.zeros(frames.shape[:3] + (2,), np.float32)
    fwd[..., 0] = 2.0
    masks = np.ones(frames.shape[:3], np.float32)
    ref = np.asarray(jflow.get_flowid(jnp.asarray(frames), jnp.asarray(fwd),
                                      jnp.asarray(masks)))
    np.testing.assert_array_equal(native.get_flowid_native(frames, fwd, masks), ref)


def test_farneback_flows_match_jax_and_unported_backends_raise():
    """Farneback flows are identical; the network backends raise JAX's
    ValueError without a model, and with a tiny RAFT (JAX's weights carried
    across) they match JAX's within 1e-4 px (f32, 4 refinement steps)."""
    import jax

    from tclight_torch.models import bridge
    from tclight_torch.models.raft import RAFTConfig, RAFTFlowModel
    from tclight_tpu.models.raft import RAFT as JRAFT
    from tclight_tpu.models.raft import RAFTConfig as JRAFTConfig
    from tclight_tpu.models.raft import RAFTFlowModel as JRAFTFlowModel

    frames = _frames(n=3, seed=3)
    for direction in ("future", "past"):
        np.testing.assert_array_equal(
            flow_backends.compute_flow_pairs(frames, direction),
            jbackends.compute_flow_pairs(frames, direction))
    for backend in ("raft", "memflow"):
        with pytest.raises(ValueError, match="requires a loaded"):
            flow_backends.compute_flow_pairs(frames, "future", backend)
        with pytest.raises(ValueError, match="requires a loaded"):
            jbackends.compute_flow_pairs(frames, "future", backend)
    params = jax.jit(lambda k, x: JRAFT(JRAFTConfig.tiny()).init(k, x, x, iters=1))(
        jax.random.PRNGKey(0), jnp.asarray(frames[:1]))
    ours = RAFTFlowModel(bridge.raft_state_dict(params), RAFTConfig.tiny(), device="cpu")
    theirs = JRAFTFlowModel(params, JRAFTConfig.tiny())
    for direction in ("future", "past"):
        np.testing.assert_allclose(
            flow_backends.compute_flow_pairs(frames, direction, "raft", raft=ours),
            jbackends.compute_flow_pairs(frames, direction, "raft", raft=theirs), atol=1e-4)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_load_data_matches_jax_through_a_shared_flow_cache(tmp_path, writer):
    frames = _frames(n=6, h=32, w=40, seed=4)
    vid = tmp_path / "vid"
    save_frames(frames, vid)
    cfg = {"rgb_path": str(vid), "height": 32, "width": 40, "flow_model": "farneback"}
    ids = list(range(6))
    first, second = ((JParser(cfg), VideoDataParser(cfg)) if writer == "jax"
                     else (VideoDataParser(cfg), JParser(cfg)))
    kw = lambda p: {"device": "cpu"} if isinstance(p, VideoDataParser) else {}
    out_a = first.load_data(ids, **kw(first))
    cache = tmp_path / "vid_future_flow_farneback"
    assert sorted(f.name for f in cache.iterdir()) == [f"{i:05d}.npy" for i in ids]
    # the second parser computes no flow: it reads the first one's cache
    mtimes = {f: f.stat().st_mtime_ns for f in cache.iterdir()}
    out_b = second.load_data(ids, **kw(second))
    assert {f: f.stat().st_mtime_ns for f in cache.iterdir()} == mtimes
    for k in (0, 3, 4):
        np.testing.assert_array_equal(out_a[k], out_b[k])
    np.testing.assert_allclose(out_a[5], out_b[5], atol=1e-4)
    assert first.n_unique == second.n_unique
    np.testing.assert_array_equal(first.unq_inv, second.unq_inv)


def test_load_data_is_memoized_and_parser_factory(tmp_path):
    frames = _frames(n=3, seed=5)
    save_frames(frames, tmp_path / "vid")
    cfg = {"rgb_path": str(tmp_path / "vid"), "height": 24, "width": 32,
           "flow_model": "farneback", "scene_type": "video"}
    parser = make_data_parser(cfg)
    assert isinstance(parser, VideoDataParser)
    a = parser.load_data([0, 1, 2], device="cpu")
    assert parser.load_data([0, 1, 2], device="cpu") is a
    with pytest.raises(NotImplementedError):
        make_data_parser({"scene_type": "bogus"})
    # the synthetic scenes are ported (tests/test_torch_synthetic.py); the
    # parser's flow slot reaches the flow backends
    parser = make_data_parser({"scene_type": "interiornet", "data_dir": str(tmp_path)},
                              flow_backend="raft", raft="net")
    assert type(parser).__name__ == "InteriorNetDataParser"
    assert (parser.flow_backend, parser.raft) == ("raft", "net")
    parser = make_data_parser(cfg, flow_backend="memflow", raft="net")
    assert (parser.flow_backend, parser.raft) == ("memflow", "net")
