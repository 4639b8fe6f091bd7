"""Port models (tclight_torch/models) against the JAX package on the same
weights, handed over with tclight_torch/models/bridge.py: the tiny UNet with
ToMe off, and with ToMe on, carried banks and cfg_dedup; the 4-level
`__graft_entry__` topology at odd latent sizes (the nearest-resize
upsample); the tiny VAE and CLIP text model. f32 throughout; tolerance
1e-4 relative to the output's magnitude (f32 summation order through a
few dozen layers).

A bank is compared up to a permutation of its rows: the unmerged tokens
are ordered by an argsort of their best match score, and two scores
within f32 rounding of each other can swap places. That permutes the
bank rows without changing any output (attention is permutation
equivariant and the unmerge follows the same order), which the eps
comparison checks."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclight_tpu.models import clip_text as jclip
from tclight_tpu.models import unet as junet
from tclight_tpu.models import vae as jvae
from tclight_torch.models import bridge
from tclight_torch.models import clip_text as tclip
from tclight_torch.models import unet as tunet
from tclight_torch.models import vae as tvae
from tclight_torch.pipeline.iclight import init_like_flax

torch.set_num_threads(2)

RTOL = 1e-4


def _close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=RTOL,
                               atol=RTOL * float(np.abs(ref).max()))


def _close_up_to_row_order(out, ref):
    """The rows of `out` and `ref` are the same multiset (per batch): every
    row occurs as often in one as in the other. Banks hold repeated rows
    (merged src tokens copy their dst token)."""
    ref = np.asarray(ref)
    atol = RTOL * float(np.abs(ref).max())
    for ob, rb in zip(np.asarray(out), ref):
        d_rr = np.abs(rb[:, None, :] - rb[None, :, :]).max(-1)
        d_ro = np.abs(rb[:, None, :] - ob[None, :, :]).max(-1)
        np.testing.assert_array_equal((d_ro <= atol).sum(1), (d_rr <= atol).sum(1))
        assert (d_ro.min(axis=0) <= atol).all(), "a port row matches no JAX row"


def _weights(module, seed=0):
    """Random weights at flax's init scales, every leaf then moved by noise
    so that zero biases and unit norm scales also carry information.
    Returns the flax tree for the JAX package and a fresh port module
    loaded from that tree through the bridge."""
    gen = torch.Generator().manual_seed(seed)
    init_like_flax(module, gen)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    tree = bridge.module_to_flax(module)
    fresh = type(module)(module.config)
    fresh.load_state_dict(bridge.flax_to_state_dict(tree))
    for (k, a), b in zip(module.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
    return tree, fresh.eval()


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def tiny_unet():
    return _weights(tunet.UNet2DCondition(tunet.UNetConfig.tiny(8)))


def test_tiny_unet_tome_off(tiny_unet):
    params, model = tiny_unet
    rng = np.random.default_rng(1)
    x, ctx = _randn(rng, 4, 16, 16, 8), _randn(rng, 4, 77, 32)
    ref, _ = jax.jit(junet.UNet2DCondition(junet.UNetConfig.tiny(8)).apply)(
        params, jnp.asarray(x), jnp.asarray(500.0), jnp.asarray(ctx))
    with torch.no_grad():
        out, banks = model(torch.from_numpy(x), 500.0, torch.from_numpy(ctx))
    assert banks == {}
    _close(out.numpy(), ref)


def _run_slots(apply_j, model, spec_t, slots, cfg_dedup):
    """Run chunk slots through both UNets, carrying each one's banks."""
    banks_j = banks_t = None
    for i, (x, ctx, randf, flip) in enumerate(slots):
        eps_j, banks_j = apply_j(jnp.asarray(x), jnp.asarray(300.0), jnp.asarray(ctx),
                                 randf=jnp.int32(randf), flip=jnp.bool_(flip),
                                 banks=banks_j, use_global=i > 0,
                                 cfg_dedup=cfg_dedup)
        with torch.no_grad():
            eps_t, banks_t = model(torch.from_numpy(x), 300.0, torch.from_numpy(ctx),
                                   tome_spec=spec_t, randf=randf, flip=flip,
                                   banks=banks_t, use_global=i > 0,
                                   cfg_dedup=cfg_dedup)
        _close(eps_t.numpy(), eps_j)
        assert sorted(banks_t) == sorted(banks_j)
        for key in banks_j:
            _close_up_to_row_order(banks_t[key].numpy(), banks_j[key])


def test_tiny_unet_tome_banks_cfg_dedup(tiny_unet):
    params, model = tiny_unet
    rng = np.random.default_rng(2)
    kw = dict(n_frames=4, local_ratio=0.5, merge_global=True, global_ratio=0.5)
    unet_j = junet.UNet2DCondition(junet.UNetConfig.tiny(8),
                                   tome_spec=junet.ToMeSpec(**kw))
    apply_j = jax.jit(lambda *a, **k: unet_j.apply(params, *a, **k),
                      static_argnames=("use_global", "cfg_dedup"))
    # cfg_dedup: x is the shared half (4 frames), context the CFG batch (8)
    slots = [(_randn(rng, 4, 16, 16, 8), _randn(rng, 8, 77, 32), randf, flip)
             for randf, flip in ((1, False), (2, True), (0, False))]
    _run_slots(apply_j, model, tunet.ToMeSpec(**kw), slots, cfg_dedup=True)


def test_graft_topology_odd_latents_with_tome():
    """The 4-level SD topology of __graft_entry__.entry at a 20x12 latent:
    the level-3 -> 2 upsample resizes 2x1 to the 5x3 skip. A chunk slot
    that merges against the banks of an earlier one."""
    rng = np.random.default_rng(3)
    dims = dict(in_channels=8, block_out_channels=(32, 64, 128, 128),
                layers_per_block=2, num_heads=4, context_dim=256, norm_groups=16)
    params, model = _weights(tunet.UNet2DCondition(tunet.UNetConfig(**dims)), seed=3)
    kw = dict(n_frames=4, local_ratio=0.6, merge_global=True, global_ratio=0.5,
              max_downsample=2)
    unet_j = junet.UNet2DCondition(junet.UNetConfig(**dims),
                                   tome_spec=junet.ToMeSpec(**kw))
    spec = tunet.ToMeSpec(**kw)
    # the banks of a first chunk slot, made by the port and handed to both
    with torch.no_grad():
        _, banks = model(torch.from_numpy(_randn(rng, 8, 20, 12, 8)), 300.0,
                         torch.from_numpy(_randn(rng, 8, 77, 256)), tome_spec=spec,
                         randf=1)
    x, ctx = _randn(rng, 8, 20, 12, 8), _randn(rng, 8, 77, 256)
    eps_j, banks_j = jax.jit(unet_j.apply, static_argnames=("use_global",))(
        params, jnp.asarray(x), jnp.asarray(300.0), jnp.asarray(ctx),
        randf=jnp.int32(3), flip=jnp.bool_(True),
        banks={k: jnp.asarray(v.numpy()) for k, v in banks.items()}, use_global=True)
    with torch.no_grad():
        eps_t, banks_t = model(torch.from_numpy(x), 300.0, torch.from_numpy(ctx),
                               tome_spec=spec, randf=3, flip=True, banks=banks,
                               use_global=True)
    _close(eps_t.numpy(), eps_j)
    assert sorted(banks_t) == sorted(banks_j) == sorted(banks)
    for key in banks_j:
        _close_up_to_row_order(banks_t[key].numpy(), banks_j[key])


def test_tiny_vae_encode_decode():
    rng = np.random.default_rng(4)
    vae_j = jvae.AutoencoderKL(jvae.VAEConfig.tiny())
    params, model = _weights(tvae.AutoencoderKL(tvae.VAEConfig.tiny()), seed=4)
    assert bridge.vae_state_dict(params).keys() == model.state_dict().keys()
    x = rng.uniform(-1, 1, (2, 32, 24, 3)).astype(np.float32)
    mean_j, logvar_j = jax.jit(functools.partial(vae_j.apply, method=vae_j.encode))(
        params, jnp.asarray(x))
    img_j = jax.jit(functools.partial(vae_j.apply, method=vae_j.decode))(params, mean_j)
    with torch.no_grad():
        mean_t, logvar_t = model.encode(torch.from_numpy(x))
        img_t = model.decode(torch.from_numpy(np.array(mean_j)))
    _close(mean_t.numpy(), mean_j)
    _close(logvar_t.numpy(), logvar_j)
    _close(img_t.numpy(), img_j)


def test_tiny_clip_text():
    rng = np.random.default_rng(5)
    cfg = jclip.CLIPTextConfig.tiny()
    clip_j = jclip.CLIPTextModel(cfg)
    params, model = _weights(tclip.CLIPTextModel(tclip.CLIPTextConfig.tiny()), seed=5)
    assert bridge.clip_text_state_dict(params).keys() == model.state_dict().keys()
    ids = rng.integers(0, cfg.vocab_size, size=(2, 77))
    ref = jax.jit(clip_j.apply)(params, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        out = model(torch.from_numpy(ids))
    _close(out.numpy(), ref)


def test_pnp_and_controlnet_arguments_raise():
    """The PnP and ControlNet hooks are ported (ROADMAP A10; held against
    JAX in tests/test_torch_editing.py): they run, on a [source | uncond |
    cond] batch and with a mid residual, and give finite eps of the input's
    shape; what still raises is combining them with the CFG-prefix dedup,
    which JAX forbids too."""
    model = tunet.UNet2DCondition(tunet.UNetConfig.tiny(8))
    x, ctx = torch.randn(3, 8, 8, 8), torch.randn(3, 77, 32)
    with torch.no_grad():
        for kw in ({"pnp_attn": True}, {"pnp_conv": True}, {"pnp_attn": True, "pnp_conv": True},
                   {"mid_residual": torch.randn(3, 4, 4, 64)}):
            eps, _ = model(x, 1.0, ctx, **kw)
            assert eps.shape == (3, 8, 8, 4) and torch.isfinite(eps).all()
            with pytest.raises(ValueError, match="cfg_dedup"):
                model(x[:1], 1.0, ctx[:2], cfg_dedup=True, **kw)
