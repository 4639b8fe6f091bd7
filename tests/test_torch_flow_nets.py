"""The port's flow networks (models/raft.py, memflow_sk.py, memflow.py) and
the network backends of the data layer against the JAX package's, on the
same weights and inputs, on the CPU in f32.

- The correlation helpers at odd sizes (a pooled level drops a row), with
  coordinates that leave the plane: exact up to f32 rounding (1e-5).
- RAFTConfig.tiny() at 32x48 with JAX's parameters carried across
  (`bridge.raft_state_dict`), with and without init_flow; and a
  reference-keyed checkpoint (`raft.reference_state_dict` of random
  weights with random BatchNorm statistics, written as .pth) loaded by
  both packages' converters. Flows agree within 1e-4 px (4 refinement
  steps of f32 convolutions summed in another order).
- InferenceCoreSK streaming 4 frames at 64x64 with warm starts (full
  widths, decoder depth 3, gamma 0.5 so the memory attention counts):
  flows within 1e-4 px (measured: 1.5e-6 of flows up to 4.6 px), memory
  counts equal; `convert_memflow_params`
  (the port's copy) gives JAX's tree on a reference-keyed dict.
- memflow.InferenceCore (tiny) over 3 frames within 1e-4 px.
- compute_flow_pairs with both network backends within the same
  tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclight_torch.data import flow_backends
from tclight_torch.models import bridge, memflow, memflow_sk, raft
from tclight_tpu.data import flow_backends as jbackends
from tclight_tpu.models import memflow as jmemflow
from tclight_tpu.models import memflow_sk as jmemflow_sk
from tclight_tpu.models import raft as jraft

torch.set_num_threads(2)

RAFT_TOL = 1e-4
MEMFLOW_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _frames(n, h, w, seed=0):
    import cv2

    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.uniform(0.1, 0.9, (h, w, 3)).astype(np.float32), (0, 0), 1.5)
    return np.stack([np.roll(base, 2 * t, axis=1) for t in range(n)]).astype(np.float32)


def test_corr_pyramid_matches_jax(rng):
    f1 = rng.standard_normal((2, 7, 9, 16)).astype(np.float32)
    f2 = rng.standard_normal((2, 7, 9, 16)).astype(np.float32)
    ours = raft.corr_pyramid(_t(f1), _t(f2), 3)
    ref = jraft.corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 3)
    assert [tuple(p.shape) for p in ours] == [(2, 63, 7, 9), (2, 63, 3, 4), (2, 63, 1, 2)]
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5)


def test_corr_lookup_matches_jax_window_order_and_edges(rng):
    f1 = rng.standard_normal((1, 6, 7, 8)).astype(np.float32)
    f2 = rng.standard_normal((1, 6, 7, 8)).astype(np.float32)
    # coordinates inside, on and past every edge, with fractions
    coords = rng.uniform(-3.0, 10.0, (1, 6, 7, 2)).astype(np.float32)
    ours = raft.corr_lookup(raft.corr_pyramid(_t(f1), _t(f2), 2), _t(coords), 2)
    ref = jraft.corr_lookup(jraft.corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 2),
                            jnp.asarray(coords), 2)
    assert ours.shape == (1, 6, 7, 2 * 25)
    np.testing.assert_allclose(_np(ours), np.asarray(ref), atol=1e-5)
    # x-major window order: tap i * (2r+1) + j reads (dx, dy) = (i - r, j - r);
    # a plane holding x + 100 y gives each tap's position back, zero outside
    h, w, r = 5, 6, 1
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    plane = torch.from_numpy((xs + 100 * ys).astype(np.float32)).expand(1, h * w, h, w)
    centre = np.stack([xs, ys], -1)[None].astype(np.float32)
    out = _np(raft.corr_lookup([plane], _t(centre), r))[0]
    for i in range(3):
        for j in range(3):
            x, y = xs + i - r, ys + j - r
            inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            np.testing.assert_allclose(out[..., i * 3 + j], np.where(inside, x + 100 * y, 0))


def test_corr_lookup_chunked_matches_jax(rng):
    f1 = rng.standard_normal((2, 6, 7, 8)).astype(np.float32)
    f2 = rng.standard_normal((2, 6, 7, 8)).astype(np.float32)
    coords = rng.uniform(-2.0, 8.0, (2, 6, 7, 2)).astype(np.float32)
    # three chunks of 14 queries (JAX's form needs a chunk that divides them)
    ours = raft.corr_lookup_chunked(_t(f1), _t(f2), _t(coords), 2, 2, chunk=14)
    ref = jraft.corr_lookup_chunked(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(coords),
                                    2, 2, chunk=14)
    np.testing.assert_allclose(_np(ours), np.asarray(ref), atol=1e-5)
    # the port's takes any chunk: 16 leaves a ragged last chunk
    ragged = raft.corr_lookup_chunked(_t(f1), _t(f2), _t(coords), 2, 2, chunk=16)
    np.testing.assert_allclose(_np(ragged), _np(ours), atol=1e-6)


def test_convex_upsample_matches_jax(rng):
    flow = rng.standard_normal((2, 3, 5, 2)).astype(np.float32)
    mask = rng.standard_normal((2, 3, 5, 576)).astype(np.float32)
    ours = raft.convex_upsample(_t(flow), _t(mask))
    assert ours.shape == (2, 24, 40, 2)
    np.testing.assert_allclose(_np(ours), np.asarray(jraft.convex_upsample(
        jnp.asarray(flow), jnp.asarray(mask))), atol=1e-5)


@pytest.fixture(scope="module")
def tiny_raft():
    """JAX's tiny RAFT parameters, the JAX module and the port's."""
    a = jnp.zeros((1, 32, 48, 3), jnp.float32)
    params = jax.jit(lambda k, x: jraft.RAFT(jraft.RAFTConfig.tiny()).init(k, x, x, iters=1))(
        jax.random.PRNGKey(0), a)
    model = raft.RAFT(raft.RAFTConfig.tiny())
    model.load_state_dict(bridge.raft_state_dict(params))
    return params, jraft.RAFT(jraft.RAFTConfig.tiny()), model.eval()


@pytest.mark.parametrize("warm", [False, True])
def test_raft_tiny_forward_matches_jax(tiny_raft, warm):
    params, jmodel, model = tiny_raft
    frames = _frames(3, 32, 48, seed=1)
    a, b = frames[:2], frames[1:]
    init = (np.random.default_rng(2).uniform(-1.5, 1.5, (2, 4, 6, 2)).astype(np.float32)
            if warm else None)
    ref_up, ref8 = jax.jit(lambda p, x, y, f: jmodel.apply(p, x, y, init_flow=f))(
        params, jnp.asarray(a), jnp.asarray(b), None if init is None else jnp.asarray(init))
    with torch.no_grad():
        up, f8 = model(_t(a), _t(b), init_flow=None if init is None else _t(init))
    assert up.shape == (2, 32, 48, 2) and f8.shape == (2, 4, 6, 2)
    np.testing.assert_allclose(_np(f8), np.asarray(ref8), atol=RAFT_TOL)
    np.testing.assert_allclose(_np(up), np.asarray(ref_up), atol=RAFT_TOL)


def test_convert_raft_params_loads_in_both_packages(tmp_path):
    """A reference-keyed raft checkpoint (with the DDP `module.` prefix and
    random BatchNorm statistics) loads in both packages; the converters
    agree leaf for leaf and the flows within RAFT_TOL."""
    from tclight_torch.eval import loaders

    torch.manual_seed(0)
    model = raft.RAFT(raft.RAFTConfig.tiny())
    sd = raft.reference_state_dict(model)
    gen = torch.Generator().manual_seed(1)
    for k in sd:
        if k.startswith("cnet.") and (".norm" in k or ".downsample.1." in k):
            sd[k] = torch.rand(sd[k].shape, generator=gen) + 0.5
    sd = {f"module.{k}": v for k, v in sd.items()}
    path = tmp_path / "raft-things.pth"
    torch.save(sd, path)
    numpy_sd = {k: v.numpy() for k, v in sd.items()}
    _assert_exporter_inverts(raft.RAFT(raft.RAFTConfig.tiny()), numpy_sd,
                             raft.convert_raft_params, bridge.raft_state_dict,
                             raft.reference_state_dict)

    ours_tree = raft.convert_raft_params(numpy_sd)
    ref_tree = jraft.convert_raft_params(numpy_sd)
    flat = lambda t: {k: np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(t)}
    assert flat(ours_tree).keys() == flat(ref_tree).keys()
    for k, v in flat(ref_tree).items():
        np.testing.assert_array_equal(flat(ours_tree)[k], v)

    name, ours = loaders.load_flow_backend("raft", path, device="cpu")
    assert name == "raft" and ours.config == raft.RAFTConfig.tiny()
    theirs = jraft.RAFTFlowModel(ref_tree, jraft.RAFTConfig.tiny())
    frames = _frames(3, 32, 48, seed=3)
    np.testing.assert_allclose(ours.batched_flow(frames[:2], frames[1:]),
                               theirs.batched_flow(frames[:2], frames[1:]), atol=RAFT_TOL)


def _load(module, sd):
    module.load_state_dict(sd)
    return module


def _assert_exporter_inverts(module, numpy_sd, convert, to_state_dict, export):
    """The port's exporter inverts the converter and the bridge: the model
    a checkpoint loads into, exported and loaded again, has the same
    weights (BatchNorm refolded: within f32 rounding)."""
    first = to_state_dict(convert(numpy_sd))
    again = to_state_dict(convert({k: v.numpy() for k, v in
                                   export(_load(module, first)).items()}))
    assert again.keys() == first.keys()
    for k, v in first.items():
        np.testing.assert_allclose(again[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def memflow_pair():
    """A MemFlowNetSK at full widths, decoder depth 3, on random weights
    with random BatchNorm statistics and gamma 0.5, as a reference-keyed
    state dict and in both packages."""
    torch.manual_seed(0)
    cfg = memflow_sk.MemFlowSKConfig(decoder_depth=3)
    model = memflow_sk.MemFlowNetSK(cfg)
    with torch.no_grad():
        model.gamma.fill_(0.5)
    sd = memflow_sk.reference_state_dict(model)
    gen = torch.Generator().manual_seed(1)
    for k in sd:
        if k.startswith("cnet.") and (".norm" in k or ".downsample.1." in k):
            sd[k] = torch.rand(sd[k].shape, generator=gen) + 0.5
    numpy_sd = {f"module.{k}": v.numpy() for k, v in sd.items()}
    ours = _load(memflow_sk.MemFlowNetSK(cfg), bridge.memflow_sk_state_dict(
        memflow_sk.convert_memflow_params(numpy_sd)))
    jcfg = jmemflow_sk.MemFlowSKConfig(decoder_depth=3)
    jcore = jmemflow_sk.InferenceCoreSK(jmemflow_sk.MemFlowNetSK(jcfg),
                                        jmemflow_sk.convert_memflow_params(numpy_sd))
    return numpy_sd, memflow_sk.InferenceCoreSK(ours, device="cpu"), jcore


def test_convert_memflow_params_matches_jax(memflow_pair):
    numpy_sd, core, _ = memflow_pair
    ours = memflow_sk.convert_memflow_params(numpy_sd)
    ref = jmemflow_sk.convert_memflow_params(numpy_sd)
    flat = lambda t: {k: np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(t)}
    assert flat(ours).keys() == flat(ref).keys()
    for k, v in flat(ref).items():
        np.testing.assert_array_equal(flat(ours)[k], v)
    _assert_exporter_inverts(memflow_sk.MemFlowNetSK(core.model.cfg), numpy_sd,
                             memflow_sk.convert_memflow_params,
                             bridge.memflow_sk_state_dict, memflow_sk.reference_state_dict)


def test_inference_core_sk_streams_like_jax(memflow_pair):
    _, core, jcore = memflow_pair
    frames = _frames(4, 64, 64, seed=4)
    core.reset()
    jcore.reset()
    for i in range(3):
        ours = core.step(frames[i], frames[i + 1])
        ref = jcore.step(frames[i], frames[i + 1])
        assert ours.shape == (64, 64, 2)
        np.testing.assert_allclose(ours, ref, atol=MEMFLOW_TOL)
        assert core.mem.count == int(jcore.mem.count) == 64
        np.testing.assert_allclose(core.flow_prev, jcore.flow_prev, atol=MEMFLOW_TOL)
    core.reset()
    assert core.mem is None and core.flow_prev is None


def test_compute_flow_pairs_with_networks_match_jax(memflow_pair, tiny_raft):
    """Both network backends in both directions; the MemFlow core is reset
    at each call, as in JAX."""
    _, core, jcore = memflow_pair
    frames = _frames(3, 64, 64, seed=5)
    for direction in ("future", "past"):
        np.testing.assert_allclose(
            flow_backends.compute_flow_pairs(frames, direction, "memflow", raft=core),
            jbackends.compute_flow_pairs(frames, direction, "memflow", raft=jcore),
            atol=MEMFLOW_TOL)
    params, _, model = tiny_raft
    ours = raft.RAFTFlowModel(model.state_dict(), raft.RAFTConfig.tiny(), device="cpu")
    theirs = jraft.RAFTFlowModel(params, jraft.RAFTConfig.tiny())
    frames = _frames(6, 32, 48, seed=6)  # 5 pairs: two batches of 4 and 1
    for direction in ("future", "past"):
        got = flow_backends.compute_flow_pairs(frames, direction, "raft", raft=ours)
        np.testing.assert_allclose(
            got, jbackends.compute_flow_pairs(frames, direction, "raft", raft=theirs),
            atol=RAFT_TOL)
        assert not got[-1 if direction == "future" else 0].any()
    for backend in ("raft", "memflow"):
        with pytest.raises(ValueError, match="requires a loaded"):
            flow_backends.compute_flow_pairs(frames, "future", backend)
    assert flow_backends.available_backends() == jbackends.available_backends()


def test_memflow_inference_core_matches_jax(rng):
    cfg = jmemflow.MemFlowConfig.tiny()
    frames = _frames(3, 16, 24, seed=7)
    params = jax.jit(lambda k, x, y: jmemflow.MemFlowNet(cfg).init(k, x, y, iters=1))(
        jax.random.PRNGKey(0), jnp.asarray(frames[:1]), jnp.asarray(frames[1:2]))
    model = _load(memflow.MemFlowNet(memflow.MemFlowConfig.tiny()),
                  bridge.memflow_state_dict(params))
    core = memflow.InferenceCore(model, device="cpu")
    jcore = jmemflow.InferenceCore(jmemflow.MemFlowNet(cfg), params)
    for i in range(2):
        ours, ref = core.step(frames[i], frames[i + 1]), jcore.step(frames[i], frames[i + 1])
        assert ours.shape == (16, 24, 2)
        np.testing.assert_allclose(ours, ref, atol=RAFT_TOL)
        np.testing.assert_allclose(_np(core.memory.keys), np.asarray(jcore.memory.keys),
                                   atol=RAFT_TOL)
        assert core.memory.count == int(jcore.memory.count) == i + 1
    # the splat of the warm start
    flow = rng.uniform(-2, 2, (5, 7, 2)).astype(np.float32)
    np.testing.assert_array_equal(memflow.forward_interpolate(flow),
                                  jmemflow.forward_interpolate(flow))
    np.testing.assert_array_equal(memflow_sk.forward_interpolate_np(flow),
                                  jmemflow_sk.forward_interpolate_np(flow))
