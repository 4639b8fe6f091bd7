"""Single-image relighting against the JAX package (ROADMAP A11): every
helper of tclight_torch/pipeline/single_image.py, `process` (fc: from
noise, and from a light-direction ramp by img2img, each with the
high-resolution pass) and `process_bg` (fbc) on the tiny stack with the
JAX package's noise injected, and a headless run of each port demo on the
CPU.

The relighters run at 64 x 64 (the demos' width / height sliders), 2 steps,
high-resolution pass at 1.5x (round(1.5) * 64: 128 x 128): the stretched
img2img schedules then run 1
(low-resolution, denoise 0.9) and 2 (high-resolution, denoise 0.5) steps.
`run_rmbg_composite` is held with both packages' `compute_alpha_mattes`
replaced by one matte (RMBG itself: tests/test_torch_background.py). f32;
tolerances at each test."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tclight_tpu.models.briarmbg as jrmbg
import tclight_torch.models.briarmbg as trmbg
from tclight_tpu.diffusion.schedulers import DPMSolverMultistepScheduler as JDPM
from tclight_tpu.models.clip_text import CLIPTextConfig as JCLIPCfg
from tclight_tpu.models.clip_text import CLIPTextModel as JCLIP
from tclight_tpu.models.unet import UNet2DCondition as JUNet
from tclight_tpu.models.unet import UNetConfig as JUNetCfg
from tclight_tpu.models.vae import AutoencoderKL as JVAE
from tclight_tpu.models.vae import VAEConfig as JVAECfg
from tclight_tpu.pipeline import single_image as jsi
from tclight_tpu.pipeline.iclight import DummyTokenizer as JTokenizer
from tclight_tpu.pipeline.iclight import ICLightModels as JModels
from tclight_torch.models import bridge
from tclight_torch.pipeline import single_image as tsi
from tclight_torch.pipeline.iclight import build_tiny_iclight

torch.set_num_threads(2)

STEPS, SIZE, SEED = 2, 64, 11


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_backgrounds_match_jax(rng):
    """Every fc ramp and fbc background source, equal to JAX's."""
    for src in tsi.BGSource:
        np.testing.assert_array_equal(tsi.gradient_background(24, 40, src),
                                      jsi.gradient_background(24, 40, jsi.BGSource(src.value)))
    bg = rng.uniform(0, 1, (24, 40, 3)).astype(np.float32)
    for src in tsi.BGSourceFBC:
        np.testing.assert_array_equal(
            tsi.fbc_background(24, 40, src, bg),
            jsi.fbc_background(24, 40, jsi.BGSourceFBC(src.value), bg))
    with pytest.raises(ValueError):
        tsi.fbc_background(24, 40, tsi.BGSourceFBC.UPLOAD)


def test_image_helpers_match_jax(rng, monkeypatch):
    """resize_and_center_crop (both crop axes), normals_from_relights
    within 1e-6, and run_rmbg_composite's grey composite (sigma 0 and 16)
    within 1e-6 under one shared matte."""
    img = rng.uniform(0, 1, (50, 70, 3)).astype(np.float32)
    for tw, th in ((64, 32), (32, 64), (70, 50)):
        np.testing.assert_array_equal(tsi.resize_and_center_crop(img, tw, th),
                                      jsi.resize_and_center_crop(img, tw, th))
    lights = [rng.uniform(0.05, 1, (20, 30, 3)).astype(np.float32) for _ in range(4)]
    matting = rng.uniform(0, 1, (20, 30, 1)).astype(np.float32)
    normal, ratios = tsi.normals_from_relights(*lights, matting)
    jnormal, jratios = jsi.normals_from_relights(*lights, matting)
    np.testing.assert_allclose(normal, jnormal, rtol=0, atol=1e-6)
    for a, b in zip(ratios, jratios):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)

    def matte(*args):
        return np.clip(args[-1].mean(-1), 0, 1).astype(np.float32)

    monkeypatch.setattr(trmbg, "compute_alpha_mattes", matte)
    monkeypatch.setattr(jrmbg, "compute_alpha_mattes", matte)
    for sigma in (0.0, 16.0):
        out, alpha = tsi.run_rmbg_composite(None, img, sigma)
        ref, jalpha = jsi.run_rmbg_composite(None, None, img, sigma)
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(alpha, jalpha)
        assert out.dtype == np.float32 and alpha.shape == (50, 70, 1)


def _pair(in_channels: int):
    models = build_tiny_iclight(seed=3, num_inference_steps=STEPS, in_channels=in_channels,
                                device="cpu")
    jmodels = JModels(
        unet=JUNet(JUNetCfg.tiny(in_channels=in_channels)),
        unet_params=bridge.module_to_flax(models.unet),
        vae=JVAE(JVAECfg.tiny()), vae_params=bridge.module_to_flax(models.vae),
        text_encoder=JCLIP(JCLIPCfg.tiny()),
        text_params=bridge.module_to_flax(models.text_encoder),
        tokenizer=JTokenizer(vocab_size=1000), scheduler=JDPM(num_inference_steps=STEPS))
    return tsi.SingleImageRelighter(models, steps=STEPS), jsi.SingleImageRelighter(
        jmodels, steps=STEPS)


def _jax_pass(seed: int, shape, n_steps: int):
    """The noise a JAX pass draws: its init noise from PRNGKey(seed), and
    one SDE draw per step from the split chain of the same key."""
    init = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    key, steps = jax.random.PRNGKey(seed), []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        steps.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return init, steps


# (pass 0 steps, pass 1 steps): from noise 2 steps, img2img at 0.9 over
# round(2 / 0.9) = 2 steps from position 1, high-resolution img2img at 0.5
# over 4 steps from position 2
CASES = [("fc", "None", 2), ("fc", "Left Light", 1), ("fbc", "Use Background Image", 2)]


@pytest.mark.parametrize("mode,source,low_steps", CASES)
def test_relighter_matches_jax(rng, mode, source, low_steps):
    """`process` / `process_bg` at 64 x 64 with the high-resolution pass to
    128 x 128, the JAX package's noise injected: the image within 1e-3 of
    JAX's (f32 through VAE, a few UNet steps and VAE again, twice)."""
    fg = rng.uniform(0, 1, (40, 48, 3)).astype(np.float32)
    ours, theirs = _pair(8 if mode == "fc" else 12)
    lat = (1, SIZE // 2, SIZE // 2, 4)
    noises = [_jax_pass(SEED, lat, low_steps),
              _jax_pass(SEED + 1, (1, SIZE, SIZE, 4), 2)]
    kw = dict(seed=SEED, image_width=SIZE, image_height=SIZE)
    if mode == "fc":
        out = ours.process(fg, "warm light", tsi.BGSource(source), noises=noises, **kw)
        ref = theirs.process(fg, "warm light", jsi.BGSource(source), **kw)
    else:
        bg = rng.uniform(0, 1, (30, 50, 3)).astype(np.float32)
        out = ours.process_bg(fg, bg, "warm light", tsi.BGSourceFBC(source), noises=noises,
                              **kw)
        ref = theirs.process_bg(fg, bg, "warm light", jsi.BGSourceFBC(source), **kw)
    assert out.shape == (128, 128, 3) and np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-3)


@pytest.mark.parametrize("demo", ["gradio_demo_iclight", "gradio_demo_bg_iclight"])
def test_demo_runs_headless_on_cpu(tmp_path, monkeypatch, demo):
    """`python -m tclight_torch.<demo>` without --serve on the CPU, tiny
    random stack (no ICLIGHT_MODEL_DIR): it writes the relit image at the
    high-resolution size; without its inputs it returns 2."""
    import cv2
    import importlib

    monkeypatch.delenv("ICLIGHT_MODEL_DIR", raising=False)
    mod = importlib.import_module(f"tclight_torch.{demo}")
    img = (np.random.default_rng(1).uniform(0, 1, (40, 48, 3)) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "fg.png"), img)
    cv2.imwrite(str(tmp_path / "bg.png"), img[::-1])
    out = tmp_path / "out.png"
    common = ["--device", "cpu", "--image_width", "64", "--image_height", "64", "--steps", "2",
              "--output", str(out)]
    inputs = (["--input", str(tmp_path / "fg.png")] if demo == "gradio_demo_iclight"
              else ["--fg", str(tmp_path / "fg.png"), "--bg", str(tmp_path / "bg.png")])
    assert mod.main(inputs + common) == 0
    assert cv2.imread(str(out)).shape == (128, 128, 3)
    assert mod.main(common) == 2
