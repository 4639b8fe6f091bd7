"""The port's Cosmos diffusion world models (tclight_torch/cosmos/) against
the JAX package's (tclight_tpu/cosmos/) on the CPU in f32, on the same
weights (the port's Cosmos-layout state dicts through JAX's own
converters) and the same inputs and noise (JAX's draws injected).

Tolerance, unless a test says otherwise: max abs within 1e-4 of max
|reference|. Every DiT here has its adaLN gates drawn non-zero
(`init_dit_`): the reference zero-initialises them, and a DiT so
initialised is the identity in every block.

- EDM: the sigma ladder and scaling equal; Euler / Heun / multistep and
  every RES solver (with churn on JAX's noise) on a nonlinear x0 function.
- DiT: the tiny DiT over 576 tokens (so self-attention takes the flash
  path, the plain version of K1 here), with fps, a padding mask and the
  cross-attention mask; the video2world input (ROADMAP C10): one more
  channel, the condition mask and the augment-sigma embedder, given the
  same mask in both packages. Zeroing the self-attention moves it.
- Converters both ways; Haar patching; the CV tokenizer's encode / decode
  and its chunked, normalised and joint wrappers; the conditioner,
  guardrails, offloading; the pipeline; the tiny text2world and
  video2world command lines of both packages in one process.
"""

import dataclasses
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclight_torch.cosmos import conditioner as tcond
from tclight_torch.cosmos import convert_dit as tcdit
from tclight_torch.cosmos import convert_dv as tcdv
from tclight_torch.cosmos import cv_tokenizer as tcv
from tclight_torch.cosmos import dit as tdit
from tclight_torch.cosmos import dv_tokenizer as tdv
from tclight_torch.cosmos import edm as tedm
from tclight_torch.cosmos import guardrails as tguard
from tclight_torch.cosmos import offload as toff
from tclight_torch.cosmos import pipelines as tpipe
from tclight_tpu.cosmos import cv_tokenizer as jcv
from tclight_tpu.cosmos import dit as jdit
from tclight_tpu.cosmos import dv_tokenizer as jdv
from tclight_tpu.cosmos import edm as jedm
from tclight_tpu.cosmos.convert_dit import convert_general_dit as jconvert_dit
from tclight_tpu.cosmos.convert_dv import convert_dv_tokenizer as jconvert_dv

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _close(got, ref, rel=1e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


def _dit_pair(seed=0, **overrides):
    """A port DiT with drawn weights and JAX's on the same state dict."""
    model = tdit.GeneralDIT(tdit.DiTConfig.tiny(**overrides))
    tdit.init_dit_(model, torch.Generator().manual_seed(seed))
    model.eval().requires_grad_(False)
    jmodel = jdit.GeneralDIT(dataclasses.replace(jdit.DiTConfig.tiny(), **overrides))
    return model, jmodel, jconvert_dit(tcdit.reference_state_dict(model))


def _tiny_cv_cfg(pkg):
    return pkg.cv_config_8x8x8(channels=16, channels_mult=(1, 1, 1), num_res_blocks=1,
                               attn_resolutions=(8,), resolution=64, patch_size=2,
                               spatial_compression=8, temporal_compression=4, z_channels=8,
                               embedding_dim=4)


@pytest.fixture(scope="module")
def cv_pair():
    """The tiny CV tokenizer (a spatial and a temporal attention block at
    its coarsest level) with drawn weights, biases and norms, and JAX's."""
    module = tcv.CausalContinuousVideoTokenizer(_tiny_cv_cfg(tcv))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.05, generator=gen)
            elif p.dim() == 1:
                p.normal_(1.0, 0.1, generator=gen)
            else:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
    module.eval().requires_grad_(False)
    jmodule = jcv.CausalContinuousVideoTokenizer(_tiny_cv_cfg(jcv))
    return module, jmodule, jconvert_dv(tcdv.reference_state_dict(module))


# ---------------------------------------------------------------- EDM


def test_rho_timesteps_and_scaling_match_jax():
    for n in (2, 10, 35):
        np.testing.assert_array_equal(tedm.rho_timesteps(80.0, 0.002, n),
                                      jedm.rho_timesteps(80.0, 0.002, n))
    ts = tedm.rho_timesteps(80.0, 0.002, 10)
    assert ts[-1] == 0.0 and (np.diff(ts) < 0).all()
    sig = np.array([0.002, 1.0, 80.0], np.float32)
    for a, b in zip(tedm.EDMScaling(0.5)(torch.from_numpy(sig)),
                    jedm.EDMScaling(0.5)(jnp.asarray(sig))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def _x0_fns():
    """The same nonlinear x0 function in both packages."""
    w = np.random.default_rng(4).standard_normal((2, 2)).astype(np.float32)

    def jf(x, s):
        return jnp.tanh(x @ w) * (1.0 + 0.1 * s)

    def tf(x, s):
        return torch.tanh(x @ torch.from_numpy(w)) * (1.0 + 0.1 * float(s))

    return jf, tf


@pytest.mark.parametrize("solver", ["euler", "heun", "multistep"])
def test_edm_samplers_match_jax(solver):
    jf, tf = _x0_fns()
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, 4, 4, 2)))
    sig = tedm.rho_timesteps(n=12)
    ref = np.asarray(jedm.sample_edm(jf, jnp.asarray(noise), sig, solver=solver))
    _close(tedm.sample_edm(tf, torch.from_numpy(noise), sig, solver=solver), ref)
    # a constant x0 is recovered
    x0 = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (1, 4, 4, 2)).astype(np.float32))
    out = tedm.sample_edm(lambda x, s: x0, torch.from_numpy(noise), tedm.rho_timesteps(n=20),
                          solver=solver)
    np.testing.assert_allclose(out.numpy(), x0.numpy(), atol=1e-3)


@pytest.mark.parametrize("cfg", [
    *[dict(rk=rk) for rk in ("1euler", "2mid", "2mid_stable", "2heun_edm", "2heun_naive",
                             "3kutta_naive")],
    dict(is_multi=True), dict(rk="2mid", s_churn=2.0, s_t_min=0.05, s_t_max=50.0)])
def test_sample_res_matches_jax(cfg):
    """Every RES solver and the multistep update; with churn, the port
    takes the noise JAX drew at each step."""
    jf, tf = _x0_fns()
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, 4, 4, 2))) * 80.0
    sig = tedm.rho_timesteps(n=8)[:-1]
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jedm.sample_res(jf, jnp.asarray(x), sig, jedm.SolverConfig(**cfg), key=key))
    churn = [torch.from_numpy(np.asarray(jax.random.normal(k, x.shape, jnp.float32)))
             for k in jax.random.split(key, len(sig) - 1)]
    got = tedm.sample_res(tf, torch.from_numpy(x), sig, tedm.SolverConfig(**cfg),
                          churn_noises=churn)
    _close(got, ref)


# ---------------------------------------------------------------- DiT


def test_dit_matches_jax():
    """576 tokens (9 x 8 x 8): the self-attention takes the flash path;
    with fps, a padding mask and the cross-attention mask (a second DiT
    with use_cross_attn_mask). Zeroing every self-attention's output moves
    the prediction."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 16, 16, 4)).astype(np.float32)
    cn = np.array([0.3, -0.4], np.float32)
    ctx = rng.standard_normal((2, 12, 32)).astype(np.float32)
    pad = (rng.random((2, 16, 16)) > 0.8).astype(np.float32)
    cmask = np.ones((2, 12), bool)
    cmask[1, 7:] = False
    for overrides, kw in (({}, {}), ({"use_cross_attn_mask": True, "affline_emb_norm": False},
                                     {"fps": 12.0, "padding_mask": pad, "crossattn_mask": cmask})):
        model, jmodel, params = _dit_pair(max_frames=16, **overrides)
        ref = np.asarray(jmodel.apply(params, jnp.asarray(x), jnp.asarray(cn), jnp.asarray(ctx),
                                      **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                         for k, v in kw.items()}))
        tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        args = (torch.from_numpy(x), torch.from_numpy(cn), torch.from_numpy(ctx))
        with torch.inference_mode():
            got = model(*args, **tkw)
        _close(got, ref)
    with torch.inference_mode():
        for blk in model.blocks.values():
            torch.nn.init.zeros_(blk.blocks[0].block.attn.to_out[0].weight)
        moved = model(*args, **tkw)
    assert np.abs(moved.numpy() - ref).max() > 0.05 * np.abs(ref).max()


def test_dit_condition_mask_matches_jax():
    """C10: the video2world DiT, one input channel more than the latent
    and the augment-sigma embedder, with the condition mask (ones on the
    conditioning frames) and an augment sigma, given alike to JAX's
    GeneralDIT; the pipeline's `condition_mask` is that mask."""
    model, jmodel, params = _dit_pair(max_frames=16, in_channels=5,
                                      add_augment_sigma_embedding=True)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 9, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 8, 32)).astype(np.float32)
    mask = tpipe.condition_mask((1, 9, 16, 16, 4), 2, "cpu")
    assert mask[:, :2].eq(1).all() and mask[:, 2:].eq(0).all()
    aug = np.array([0.25], np.float32)
    ref = np.asarray(jmodel.apply(params, jnp.asarray(x), jnp.asarray([0.1]), jnp.asarray(ctx),
                                  condition_video_input_mask=jnp.asarray(mask.numpy()),
                                  condition_video_augment_sigma=jnp.asarray(aug)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.tensor([0.1]), torch.from_numpy(ctx),
                    condition_video_input_mask=mask,
                    condition_video_augment_sigma=torch.from_numpy(aug))
    _close(got, ref)
    assert tdit.VideoExtendGeneralDIT(tdit.DiTConfig.tiny()).cfg.add_augment_sigma_embedding


def test_dit_configs_match_jax():
    for name in ("tiny", "faditv2_7b", "faditv2_14b", "video2world_7b"):
        a = dataclasses.asdict(getattr(tdit.DiTConfig, name)())
        b = dataclasses.asdict(getattr(jdit.DiTConfig, name)())
        a.pop("dtype"), b.pop("dtype")
        assert a == b, name
    cfg = tdit.DiTConfig.faditv2_7b()
    assert (cfg.model_channels // cfg.num_heads, cfg.num_heads, cfg.num_blocks) == (128, 32, 28)
    for args in ((128, 4, 6, 8), (128, 3, 5, 7, 2.0, 2.0, 2.0, 24, 12.0)):
        np.testing.assert_array_equal(tdit.video_rope_angles(*args), jdit.video_rope_angles(*args))


def test_convert_general_dit_roundtrip():
    """The port's state dict through JAX's converter and back through
    `from_flax` is the same dict; `convert_general_dit` drops the RoPE
    buffers and refuses unknown keys."""
    model = tdit.GeneralDIT(tdit.DiTConfig.tiny(add_augment_sigma_embedding=True,
                                                use_adaln_lora=False))
    tdit.init_dit_(model, torch.Generator().manual_seed(2))
    sd = tcdit.reference_state_dict(model)
    back = tcdit.from_flax(jax.tree.map(np.asarray, jconvert_dit(sd)))
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    loaded = tcdit.convert_general_dit({**sd, "pos_embedder.seq": np.zeros(3)}, model)
    assert set(loaded) == set(sd)
    with pytest.raises(ValueError, match="unconverted"):
        tcdit.convert_general_dit({**sd, "blocks.block0.extra.weight": np.zeros(3)}, model)


# ---------------------------------------------------------------- tokenizer


@pytest.mark.parametrize("patch,method", [(2, "haar"), (4, "haar"), (2, "rearrange")])
def test_haar_matches_jax(patch, method):
    x = np.random.default_rng(0).standard_normal((2, 9, 8, 12, 3)).astype(np.float32)
    ref = np.asarray(jdv.patcher3d(jnp.asarray(x), patch, method))
    got = tdv.patcher3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3), patch, method)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), ref, atol=1e-6)
    back = tdv.unpatcher3d(got, patch, method).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(back, np.asarray(jdv.unpatcher3d(jnp.asarray(ref), patch, method)),
                               atol=1e-6)
    np.testing.assert_allclose(back, x, atol=1e-5)


def test_cv_tokenizer_matches_jax(cv_pair):
    """Encode 9 frames at 64 x 64 and decode JAX's latent."""
    module, jmodule, params = cv_pair
    video = np.random.default_rng(0).uniform(-1, 1, (1, 9, 64, 64, 3)).astype(np.float32)
    jz = np.asarray(jmodule.apply(params, jnp.asarray(video),
                                  method=jcv.CausalContinuousVideoTokenizer.encode))
    jrec = np.asarray(jmodule.apply(params, jnp.asarray(jz),
                                    method=jcv.CausalContinuousVideoTokenizer.decode))
    with torch.inference_mode():
        _close(module.encode(torch.from_numpy(video)), jz)
        _close(module.decode(torch.from_numpy(jz.copy())), jrec)
    assert jz.shape == (1, 3, 8, 8, 4) and jrec.shape == video.shape


def test_convert_dv_tokenizer_roundtrip(cv_pair):
    module, _, params = cv_pair
    sd = tcdv.reference_state_dict(module)
    back = tcdv.from_flax(jax.tree.map(np.asarray, params))
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    loaded = tcdv.convert_dv_tokenizer({**sd, "encoder.patcher3d.wavelets": np.zeros(2)}, module)
    assert set(loaded) == set(sd)
    with pytest.raises(ValueError, match="unconverted"):
        tcdv.convert_dv_tokenizer({**sd, "encoder.extra.weight": np.zeros(2)}, module)


def test_cv_tokenizer_wrappers(cv_pair):
    """The chunked wrapper equals each chunk alone; scalar and per-chunk-
    position mean / std; the joint tokenizer's T == 1 dispatch."""
    module = cv_pair[0]
    video = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (1, 10, 32, 32, 3)).astype(np.float32))
    tok = tcv.VideoTokenizer(module, pixel_chunk_duration=5, temporal_compression_factor=4,
                             max_enc_batch_size=1, max_dec_batch_size=1)
    lat = tok.encode(video)
    assert lat.shape == (1, 4, 4, 4, 4)
    assert tok.get_latent_num_frames(10) == 4 and tok.get_pixel_num_frames(4) == 10
    with torch.inference_mode():
        np.testing.assert_allclose(lat[:, 2:4].numpy(), module.encode(video[:, 5:10]).numpy(),
                                   atol=1e-5)
        rec = tok.decode(lat)
        np.testing.assert_allclose(rec[:, :5].numpy(), module.decode(lat[:, :2]).numpy(),
                                   atol=1e-5)
    assert rec.shape == video.shape
    mean = torch.tensor([0.1, 0.4]).reshape(2, 1, 1, 1)
    std = torch.tensor([1.5, 2.5]).reshape(2, 1, 1, 1)
    for m, s in ((0.3, 2.0), (mean, std)):
        norm = tcv.VideoTokenizer(module, pixel_chunk_duration=5, temporal_compression_factor=4,
                                  latent_mean=m, latent_std=s)
        got = norm.encode(video)
        for c in range(2):
            sl = slice(2 * c, 2 * c + 2)
            mc = m if isinstance(m, float) else m
            np.testing.assert_allclose(got[:, sl].numpy(), ((lat[:, sl] - mc) / s).numpy(),
                                       atol=1e-5)
        np.testing.assert_allclose(norm.decode(got).numpy(), rec.numpy(), atol=1e-4)
    joint = tcv.JointImageVideoTokenizer.shared_jit(
        module, image_mean_std=(0.1, 1.5), video_mean_std=(0.3, 2.0), pixel_chunk_duration=5,
        temporal_compression_factor=4)
    np.testing.assert_array_equal(joint.encode(video).numpy(),
                                  joint.video_vae.encode(video).numpy())
    frame = video[:, :1]
    with torch.inference_mode():
        np.testing.assert_allclose(joint.encode(frame).numpy(),
                                   ((module.encode(frame) - 0.1) / 1.5).numpy(), atol=1e-5)
    assert joint.decode(joint.encode(frame)).shape == frame.shape
    assert (joint.get_latent_num_frames(1), joint.get_latent_num_frames(10),
            joint.latent_chunk_duration, joint.latent_ch) == (1, 4, 2, 4)


# ---------------------------------------------------------------- the rest


def test_conditioner_cfg_pair():
    fields = {"crossattn": tcond.ConditionField(torch.as_tensor, dropout_rate=0.2),
              "fps": tcond.ConditionField(torch.as_tensor, dropout_rate=0.0)}
    c = tcond.GeneralConditioner(fields)
    inputs = {"crossattn": np.ones((2, 4, 8), np.float32),
              "fps": np.full((2, 1), 24.0, np.float32)}
    cond, uncond = c.get_condition_uncondition(inputs)
    assert cond.crossattn_emb.eq(1).all() and uncond.crossattn_emb.eq(0).all()
    assert uncond.extras["fps"].eq(24).all()
    dropped = c({"crossattn": torch.ones(64, 2)}, generator=torch.Generator().manual_seed(0),
                train=True).crossattn_emb
    assert 0 < int(dropped[:, 0].eq(0).sum()) < 64


def test_guardrails():
    runner = tguard.presets_text()
    assert runner.is_safe("a beautiful sunset over the ocean").is_safe
    assert not runner.is_safe("graphic GORE everywhere").is_safe
    assert not tguard.Blocklist(["exploding"])("things keep explode-ing... exploded!").is_safe
    frames = np.zeros((2, 8, 8, 3), np.float32)
    np.testing.assert_array_equal(tguard.presets_video().postprocess(frames), frames)
    assert tguard.presets_video().is_safe(frames).is_safe
    checker = tguard.AegisChecker(predict=lambda t: tguard.SafetyResult("bad" not in t))
    assert not tguard.GuardrailRunner([checker]).is_safe("a bad prompt").is_safe
    # an existing directory loads the model, as JAX's checker does: this one
    # holds no weights
    with pytest.raises(FileNotFoundError, match="no model weights"):
        tguard.AegisChecker(ROOT, device="cpu")("a prompt")


def test_host_params_offload_roundtrip():
    module = torch.nn.Linear(4, 2)
    hp = toff.HostParams(module, offload=True, device="cpu")
    with hp.on_device() as m:
        assert m is module
    assert hp.nbytes == (4 * 2 + 2) * 4
    seen = []

    class Comp:
        def acquire(self):
            seen.append("acquire")

        def release(self):
            seen.append("release")

    with toff.offload_component(Comp(), True):
        pass
    with toff.offload_component(Comp(), False):
        pass
    assert seen == ["acquire", "release"]
    assert toff.OffloadPolicy.everything().network


def test_text2world_pipeline_offload_and_guardrail():
    """The pipeline with every component offloaded equals the resident
    one; a blocked prompt gives None."""
    model, _, _ = _dit_pair(3)
    ctx = np.random.default_rng(0).standard_normal((1, 6, 32)).astype(np.float32)

    def make(policy):
        return tpipe.DiffusionText2WorldPipeline(
            dit=model, encode_text=lambda p: ctx,
            decode_fn=lambda z: torch.clamp(z[..., :3] * 0.5 + 0.5, 0, 1).numpy(),
            text_guardrail=tguard.presets_text(), n_steps=3, latent_shape=(1, 4, 8, 8, 4),
            offload=policy, device="cpu")

    out = make(toff.OffloadPolicy())("a calm lake at sunrise")
    assert out.shape == (1, 4, 8, 8, 3) and np.isfinite(out).all()
    np.testing.assert_array_equal(make(toff.OffloadPolicy.everything())("a calm lake at sunrise"),
                                  out)
    assert make(toff.OffloadPolicy())("graphic gore footage") is None


@pytest.fixture
def cli_pair(tmp_path, monkeypatch):
    """Both packages' command lines on the same tiny weights, written as
    Cosmos `model.pt` state dicts; the same text features (a fixed
    `hash`, so the run does not depend on the process's hash salt); JAX's
    initial noise injected into the port; the latents the decoders take,
    their outputs and the written frames recorded."""
    import tclight_torch.cosmos.inference_cli as tcli
    import tclight_torch.utils.video_io as tvio
    import tclight_tpu.cosmos.inference_cli as jcli
    import tclight_tpu.utils.video_io as jvio

    ck = tmp_path / "ck"
    model = tdit.GeneralDIT(tdit.DiTConfig.tiny())
    tdit.init_dit_(model, torch.Generator().manual_seed(5))
    sd = {k: torch.from_numpy(v) for k, v in tcdit.reference_state_dict(model).items()}
    for sub in ("Text2World", "Video2World"):
        (ck / f"Cosmos-1.0-Diffusion-7B-{sub}").mkdir(parents=True)
        torch.save(sd, ck / f"Cosmos-1.0-Diffusion-7B-{sub}" / "model.pt")
    cv = tcv.CausalContinuousVideoTokenizer(_tiny_cv_cfg(tcv))
    tcli.random_tokenizer_(cv, torch.Generator().manual_seed(6))
    (ck / "Cosmos-1.0-Tokenizer-CV8x8x8").mkdir()
    torch.save(dict(cv.state_dict()), ck / "Cosmos-1.0-Tokenizer-CV8x8x8" / "model.pt")

    rec: dict = {}
    # a module global `hash` shadows the builtin in both CLIs' text encoders
    for cli in (tcli, jcli):
        monkeypatch.setattr(cli, "hash", lambda s: zlib.crc32(str(s).encode()), raising=False)
    monkeypatch.setattr(jvio, "save_video", lambda f, p, fps=25: rec.update(jax=np.asarray(f)))
    monkeypatch.setattr(tvio, "save_video", lambda f, p, fps=25: rec.update(torch=np.asarray(f)))
    monkeypatch.setattr(tpipe, "draw_noise", lambda seed, shape, device: torch.from_numpy(
        np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))))
    for pkg, key in ((jcv, "jax"), (tcv, "torch")):
        orig = pkg.VideoTokenizer.decode

        def decode(self, latent, _orig=orig, _key=key):
            out = _orig(self, latent)
            rec[f"{_key}_latent"], rec[f"{_key}_video"] = np.asarray(latent), np.asarray(out)
            return out

        monkeypatch.setattr(pkg.VideoTokenizer, "decode", decode)
    monkeypatch.syspath_prepend(str(ROOT))
    return ck, rec


def _check_cli_frames(rec, run_jax, monkeypatch):
    """The sampled latents and the decoded videos within 1e-4 of max
    |reference|. The frames are held against a witness of f32 rounding:
    JAX's own command line rerun twice, its initial noise moved by one ulp
    up and then down (`nextafter`). The sampled latents start at 80 x
    noise, and the 2-step Heun at guidance 7 amplifies such a move to
    0.4-2.2e-4 in the frames (CPU); the port's frames must lie no further
    from JAX's than the larger of the two moves."""
    for key in ("latent", "video"):
        ref = rec[f"jax_{key}"]
        np.testing.assert_allclose(rec[f"torch_{key}"], ref, rtol=0,
                                   atol=1e-4 * float(np.abs(ref).max()), err_msg=key)
    assert rec["torch"].shape == (5, 32, 32, 3)
    frames = rec["jax"]
    normal = jax.random.normal
    spread = 0.0
    for to in (jnp.inf, -jnp.inf):
        monkeypatch.setattr(jax.random, "normal", lambda key, shape, *a, _to=to, **k: (
            jnp.nextafter(normal(key, shape, *a, **k), _to)))
        assert run_jax() == 0
        spread = max(spread, float(np.abs(rec["jax"] - frames).max()))
    assert 0 < spread < 1e-3, spread
    err = float(np.abs(rec["torch"] - frames).max())
    assert err <= spread, (err, spread)


def test_text2world_cli_matches_jax(cli_pair, tmp_path, monkeypatch):
    """tools/text2world.py and `python -m tclight_torch.cosmos.text2world`
    with the JAX smoke test's arguments (limits in _check_cli_frames)."""
    import tools.text2world as jt2w
    from tclight_torch.cosmos import text2world

    ck, rec = cli_pair
    argv = ["--prompt", "a tiny demo world", "--height", "32", "--width", "32",
            "--num_video_frames", "5", "--num_steps", "2", "--video_save_folder",
            str(tmp_path / "out"), "--disable_guardrail", "--offload_diffusion_transformer",
            "--offload_tokenizer", "--checkpoint_dir", str(ck)]
    assert jt2w.main(argv) == 0
    assert text2world.main(argv, device="cpu") == 0
    _check_cli_frames(rec, lambda: jt2w.main(argv), monkeypatch)
    assert (tmp_path / "out" / "output.txt").read_text() == "a tiny demo world"


def test_video2world_cli_matches_jax(cli_pair, tmp_path, monkeypatch):
    """tools/video2world.py and `python -m tclight_torch.cosmos.video2world`
    on a conditioning image (at `tiny` the DiT is not widened, in either)."""
    import cv2

    import tools.video2world as jv2w
    from tclight_torch.cosmos import video2world

    ck, rec = cli_pair
    src = tmp_path / "cond.png"
    cv2.imwrite(str(src), np.random.default_rng(0).uniform(0, 255, (32, 32, 3)).astype(np.uint8))
    argv = ["--prompt", "pan right", "--input_image_or_video_path", str(src), "--height", "32",
            "--width", "32", "--num_video_frames", "5", "--num_steps", "2",
            "--video_save_folder", str(tmp_path / "out"), "--checkpoint_dir", str(ck)]
    assert jv2w.main(argv) == 0
    assert video2world.main(argv, device="cpu") == 0
    _check_cli_frames(rec, lambda: jv2w.main(argv), monkeypatch)
    np.testing.assert_array_equal(
        video2world.load_condition(str(src), 32, 32, 5),
        jv2w._load_condition(str(src), 32, 32, 5))


def test_video2world_pipeline_feeds_the_condition_mask():
    """C10 at the pipeline: a DiT one input channel wider than the latent
    (the 7B / 14B video2world net's layout, at tiny widths) gets the
    condition mask from the port's pipeline, and its conditioning frame
    is clamped into every x0 prediction; JAX's pipeline calls the same
    DiT without the mask and fails on the embedder's shape (the reference
    fault: `x_embedder/kernel` (24, 64) against (20, 64))."""
    from tclight_tpu.cosmos.pipelines import DiffusionText2WorldPipeline as JPipe

    model, jmodel, params = _dit_pair(4, in_channels=5, add_augment_sigma_embedding=True)
    ctx = np.random.default_rng(0).standard_normal((1, 6, 32)).astype(np.float32)
    shape = (1, 4, 8, 8, 4)
    cond = torch.randn(1, 1, 8, 8, 4, generator=torch.Generator().manual_seed(0))
    seen = []
    forward = model.forward

    def spy(*a, **kw):
        seen.append(kw.get("condition_video_input_mask"))
        return forward(*a, **kw)

    model.forward = spy
    pipe = tpipe.DiffusionText2WorldPipeline(
        dit=model, encode_text=lambda p: ctx, decode_fn=lambda z: z.numpy(), n_steps=3,
        latent_shape=shape, device="cpu")
    out = pipe("pan right", condition_latent=cond)
    assert out.shape == shape and np.isfinite(out).all()
    assert seen and all(m is not None and m.shape == (1, 4, 8, 8, 1) for m in seen)
    assert all(m[:, :1].eq(1).all() and m[:, 1:].eq(0).all() for m in seen)
    jpipe = JPipe(dit=jmodel, dit_params=params, encode_text=lambda p: ctx,
                  decode_fn=lambda z: np.asarray(z), n_steps=3, latent_shape=shape)
    with pytest.raises(Exception, match="x_embedder"):
        jpipe("pan right", condition_latent=jnp.asarray(cond.numpy()))


def test_cv8x8x8_decodes_a_whole_chunk():
    """C11: the port's CV8x8x8 layout (Haar patch 4) returns every frame
    of a causal chunk; JAX's (patch 2) encodes them to the same latent
    frames, but its mirrored decoder upsamples time once for the
    encoder's two downsamplings: 9 frames (1 + 8) come back as 5, and the
    CLI's 121 as 61. Checked at the layout's levels with narrow channels
    (8) on 16 x 16 frames; the widths do not change the frame count."""
    video = np.random.default_rng(0).uniform(-1, 1, (1, 9, 16, 16, 3)).astype(np.float32)
    module = tcv.CausalContinuousVideoTokenizer(tcv.cv_config_8x8x8(channels=8))
    tok = tcv.VideoTokenizer(module, pixel_chunk_duration=9, temporal_compression_factor=8)
    lat = tok.encode(torch.from_numpy(video))
    assert lat.shape == (1, 2, 2, 2, 16)
    assert tok.decode(lat).shape == video.shape
    # JAX's shapes by abstract evaluation of its init and forward
    jmodule = jcv.CausalContinuousVideoTokenizer(jcv.cv_config_8x8x8(channels=8))
    (jrec, jlat), _ = jax.eval_shape(
        lambda v: jmodule.init_with_output(jax.random.PRNGKey(0), v),
        jax.ShapeDtypeStruct(video.shape, jnp.float32))
    assert jlat.shape == (1, 2, 2, 2, 16)
    assert jrec.shape[1] == 5
