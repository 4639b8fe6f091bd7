"""The yt pass of the port's Generator (tclight_torch/pipeline/generator.py)
against the JAX package's: the temporal windows, the yt chunk size, the
yt-noise sweep with the UNet pass replaced by a recording stub (the two
permutes, the overlap handling and the order of the draws from the plan
generator), and the AdaIN fusion. The whole pass through the tiny UNet is
held by `test_generator_with_yt_pass_matches_jax` in
tests/test_torch_pipeline.py."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclight_tpu.ops.color import adaptive_instance_normalization as jadain
from tclight_tpu.pipeline.generator import Generator as JGenerator
from tclight_torch.models.unet import ToMeSpec
from tclight_torch.pipeline.generator import Generator

torch.set_num_threads(2)


def _bare(cls, **attrs):
    """A Generator of either package without its models: only the
    attributes the yt helpers read."""
    gen = cls.__new__(cls)
    base = dict(win_size_t=64, chunk_size_t=0, chunk_size=4, chunk_ord="mix-4",
                global_rand=0.5, tome_spec=types.SimpleNamespace(merge_global=True))
    for k, v in {**base, **attrs}.items():
        setattr(gen, k, v)
    return gen


@pytest.mark.parametrize("n,win", [(30, 64), (30, 8), (8, 4), (6, 4), (17, 5), (9, 9),
                                   (10, 3), (5, 2), (1, 64), (64, 64), (100, 7)])
def test_yt_windows_match_jax(n, win):
    ours = _bare(Generator, win_size_t=win)._yt_windows(n)
    ref = _bare(JGenerator, win_size_t=win)._yt_windows(n)
    assert ours[0] == ref[0]
    assert [int(s) for s in ours[1]] == [int(s) for s in ref[1]]
    assert [int(o) for o in ours[2]] == [int(o) for o in ref[2]]
    # the windows cover every frame
    w, starts, _ = ours
    assert int(starts[0]) == 0 and int(starts[-1]) + w == n


@pytest.mark.parametrize("cs,cs_t,w,win", [(4, 0, 120, 30), (4, 0, 3, 8), (2, 4, 16, 4),
                                           (4, 12, 10, 8)])
def test_yt_chunk_size_matches_jax(cs, cs_t, w, win):
    ours = _bare(Generator, chunk_size=cs, chunk_size_t=cs_t)._yt_chunk_size(w, win)
    ref = _bare(JGenerator, chunk_size=cs, chunk_size_t=cs_t)._yt_chunk_size(w, win)
    assert ours == ref


@pytest.mark.parametrize("n,win", [(6, 4), (10, 4), (8, 8)])
def test_temporal_noises_sweep_matches_jax(n, win):
    """`_temporal_noises` of both packages, each UNet pass replaced by a stub
    that returns a function of its input, its chunk plan and its randfs
    and flips: the outputs agree exactly (the permutes, a later window's
    overwrite of the overlap, scaled by sqrt(0.5)), and the stubs saw the
    same plans and draws in the same order."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 5, 6, 4)).astype(np.float32)
    cc = rng.standard_normal((n, 5, 6, 4)).astype(np.float32)
    seen_j, seen_t = [], []

    def stub(xt, cct, plan, randfs, flips, seen):
        seen.append((np.asarray(plan.indices).tolist(), np.asarray(randfs).tolist(),
                     np.asarray(flips).tolist()))
        col = np.arange(xt.shape[0], dtype=np.float32)[:, None, None, None]
        return col, 1.0 + 0.5 * float(np.sum(randfs)) + float(np.sum(flips))

    def run_slots_j(xt, cct, embeds, t, plan, randfs, flips, yt=False):
        col, c = stub(xt, cct, plan, randfs, flips, seen_j)
        return xt * c + cct * 0.25 + jnp.asarray(col)

    def step_core_t(xt, cct, embeds, t, plan, randfs, flips, models=None):
        col, c = stub(xt, cct, plan, randfs, flips, seen_t)
        return xt * c + cct * 0.25 + torch.from_numpy(col)

    jgen = _bare(JGenerator, win_size_t=win)
    jgen._run_slots = run_slots_j
    jgen._yt_bind = lambda cs_t: False
    tgen = _bare(Generator, win_size_t=win)
    tgen._step_core = step_core_t
    tgen._yt_bind = lambda cs_t: None
    ref = jgen._temporal_noises(jnp.asarray(x), jnp.asarray(cc), None, 500.0,
                                np.random.default_rng(3))
    out = tgen._temporal_noises(torch.from_numpy(x), torch.from_numpy(cc), None, 500.0,
                                np.random.default_rng(3))
    assert seen_t == seen_j and len(seen_t) == len(tgen._yt_windows(n)[1])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_yt_bind_carries_the_attention_backend():
    from tclight_torch.pipeline.iclight import ICLightModels

    spec = ToMeSpec(n_frames=2)
    models = ICLightModels(unet=None, vae=None, text_encoder=None, tokenizer=None,
                           scheduler=None, tome_spec=spec, attn_backend="int8pv")
    gen = _bare(Generator, chunk_size=2, tome_spec=spec, attn_backend="int8pv",
                models=models, _yt_models=None)
    assert gen._yt_bind(2) is models
    bound = gen._yt_bind(4)
    assert bound.tome_spec == ToMeSpec(n_frames=4) and bound.attn_backend == "int8pv"
    assert gen._yt_bind(4) is bound  # kept for the next step


@pytest.mark.parametrize("alpha", [0.4, 0.4 * 0.01 ** 0.5, 0.0])
def test_fuse_yt_matches_jax(alpha):
    """AdaIN of the yt prediction onto the xy one's statistics, then the
    sqrt(alpha) / sqrt(1 - alpha) mix in f32 (JAX `_build_fuse_step_fn`
    without its scheduler step). f32 summation order: 1e-5."""
    rng = np.random.default_rng(1)
    xy = rng.standard_normal((5, 9, 12, 4)).astype(np.float32) * 1.3 + 0.2
    yt = rng.standard_normal((5, 9, 12, 4)).astype(np.float32) * 0.7 - 0.1
    a = jnp.float32(alpha)
    ref = jnp.sqrt(a) * jadain(jnp.asarray(yt), jnp.asarray(xy)) \
        + jnp.sqrt(1.0 - a) * jnp.asarray(xy)
    out = Generator._fuse_yt(torch.from_numpy(xy), torch.from_numpy(yt), alpha)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
