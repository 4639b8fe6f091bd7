"""The generic-SD editing path end to end against the JAX package
(ROADMAP A10): the DDIM inversion (its cache files and its reconstruction),
then PnP and ControlNet generation on `build_tiny_sd`, with the same
weights (bridged with `models/bridge.py`), video and config. The inversion
cache is shared between the packages, and both directions are held: the
port's PnP run on the cache JAX wrote, and JAX's on the cache the port
wrote, each against the other package on the same cache.

The runs set both merge ratios to 0: every ToMe stage runs (matching, the
bank carry, the unmerge maps) but no token is dropped, so no f32 near-tie
can flip a merge (ROADMAP C1). DDIM is deterministic: no noise is drawn,
and the init latents come from the cache. f32 throughout; cached latents
agree within 1e-4 of their largest magnitude, frames within 1e-3 (f32
summation order through two steps of UNet, as tests/test_torch_pipeline.py
holds the IC-Light path)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclight_tpu.config import ConfigDict as JConfigDict
from tclight_tpu.data.dataparsers import VideoDataParser as JParser
from tclight_tpu.diffusion.schedulers import DDIMStateScheduler as JDDIM
from tclight_tpu.models.clip_text import CLIPTextConfig as JCLIPCfg
from tclight_tpu.models.clip_text import CLIPTextModel as JCLIP
from tclight_tpu.models.controlnet import ControlNetModel as JControlNet
from tclight_tpu.models.unet import UNet2DCondition as JUNet
from tclight_tpu.models.unet import UNetConfig as JUNetCfg
from tclight_tpu.models.vae import AutoencoderKL as JVAE
from tclight_tpu.models.vae import VAEConfig as JVAECfg
from tclight_tpu.pipeline.generator import Generator as JGenerator
from tclight_tpu.pipeline.iclight import DummyTokenizer as JTokenizer
from tclight_tpu.pipeline.iclight import ICLightModels as JModels
from tclight_tpu.pipeline.invert import Inverter as JInverter
from tclight_torch.config import ConfigDict
from tclight_torch.data.dataparsers import VideoDataParser
from tclight_torch.models import bridge
from tclight_torch.models.controlnet import ControlNetModel
from tclight_torch.pipeline import invert
from tclight_torch.pipeline.generator import Generator
from tclight_torch.pipeline.iclight import build_tiny_sd
from tclight_torch.utils.video_io import load_video, save_frames
from test_torch_editing import _perturbed

torch.set_num_threads(2)

N, SIZE, STEPS = 4, 32, 2
FRAME_IDS = list(range(N))


def _config(tmp_path: Path, vid: Path, control: str, **gen) -> dict:
    return {
        "sd_version": "1.5", "work_dir": str(tmp_path / "wd"),
        "data": {"scene_type": "video", "rgb_path": str(vid), "height": SIZE, "width": SIZE,
                 "fps": 8},
        "inversion": {"steps": STEPS, "save_steps": STEPS, "save_intermediate": True,
                      "batch_size": 3, "prompt": "a photo", "recon": True, "force": False},
        "generation": dict(
            control=control, pnp_attn_t=0.5, pnp_f_t=0.8, guidance_scale=3.0,
            n_timesteps=STEPS, chunk_size=4, chunk_ord="mix-4", local_merge_ratio=0.0,
            merge_global=True, global_merge_ratio=0.0, align_batch=False, max_downsample=2,
            noise_mode="same", alpha_t=0.0, negative_prompt="blurry",
            prompt={"edit": "a watercolor painting"}, save_frame=False, **gen),
        "post_opt": {"apply_opt": False},
        "seed": 3,
    }


def _jax_models(models) -> JModels:
    jm = JModels(
        unet=JUNet(JUNetCfg.tiny(in_channels=4)), unet_params=bridge.module_to_flax(models.unet),
        vae=JVAE(JVAECfg.tiny()), vae_params=bridge.module_to_flax(models.vae),
        text_encoder=JCLIP(JCLIPCfg.tiny()),
        text_params=bridge.module_to_flax(models.text_encoder),
        tokenizer=JTokenizer(vocab_size=1000), scheduler=JDDIM(num_inference_steps=STEPS),
        model_key="1.5")
    if models.controlnet is not None:
        jm.controlnet = JControlNet(JUNetCfg.tiny(in_channels=4))
        jm.controlnet_params = bridge.module_to_flax(models.controlnet)
    return jm


def _close(out, ref, atol):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def inverted(tmp_path_factory):
    """The tiny SD stack, a 4-frame rolling video and both packages'
    inversion caches (with their reconstructions) of it."""
    tmp = tmp_path_factory.mktemp("editing")
    rng = np.random.default_rng(0)
    base = rng.uniform(0.2, 0.8, (SIZE, SIZE, 3)).astype(np.float32)
    vid = tmp / "vid"
    save_frames(np.stack([np.roll(base, 2 * t, axis=1) for t in range(N)]), vid)
    models = build_tiny_sd(seed=0, num_inference_steps=STEPS, device="cpu")
    jmodels = _jax_models(models)
    cfg = _config(tmp, vid, "pnp")
    caches = {"jax": tmp / "cache_jax", "torch": tmp / "cache_torch"}
    JInverter(jmodels, JConfigDict(cfg), data_parser=JParser(cfg["data"]))(
        str(caches["jax"]), FRAME_IDS)
    invert.Inverter(models, ConfigDict(cfg), data_parser=VideoDataParser(cfg["data"]),
                    device="cpu")(caches["torch"], FRAME_IDS)
    return tmp, vid, models, jmodels, caches


def test_inverter_writes_the_jax_cache(inverted):
    """The same files (every generation timestep, noisy_latents_{t}.npy,
    (N, h, w, 4) f32) with the same latents within 1e-4 of their largest
    magnitude, and reconstructions within 2/255 (8-bit PNGs of frames
    within 1e-3); a second call finds the cache and skips it unless
    `force`."""
    _, vid, models, _, caches = inverted
    names = sorted(p.name for p in caches["jax"].glob("*.npy"))
    assert names == sorted(p.name for p in caches["torch"].glob("*.npy"))
    ts = JDDIM(num_inference_steps=STEPS).timesteps()
    assert {invert.latent_filename(caches["jax"], t).name for t in ts} <= set(names)
    for name in names:
        ref, out = np.load(caches["jax"] / name), np.load(caches["torch"] / name)
        assert out.dtype == np.float32 and out.shape == ref.shape == (N, SIZE // 2, SIZE // 2, 4)
        _close(out, ref, 1e-4 * float(np.abs(ref).max()))
    rec_j = load_video(str(caches["jax"] / "recon"), SIZE, SIZE)
    rec_t = load_video(str(caches["torch"] / "recon"), SIZE, SIZE)
    _close(rec_t, rec_j, 2.0 / 255.0)

    cfg = _config(inverted[0], vid, "pnp")
    target = invert.latent_filename(caches["torch"], ts[0])
    stamp = target.stat().st_mtime_ns
    inv = invert.Inverter(models, ConfigDict(cfg), data_parser=VideoDataParser(cfg["data"]),
                          device="cpu")
    inv(caches["torch"], FRAME_IDS)
    assert target.stat().st_mtime_ns == stamp
    inv.force = True
    inv(caches["torch"], FRAME_IDS)
    assert target.stat().st_mtime_ns != stamp


def _run(gen_cls, models, cfg_cls, cfg, parser_cls, cache, out_dir, **kw):
    c = cfg_cls(cfg)
    gen = gen_cls(models, c, data_parser=parser_cls(c["data"]), **kw)
    return gen, gen(str(cache), str(out_dir), FRAME_IDS)["edit"]


def test_pnp_generation_matches_jax_on_both_caches(inverted):
    """PnP ([source | uncond | cond] batches, Q/K injection in step 0 and
    conv injection in step 0 of 2) from each package's cache: the port
    against JAX on the same cache, within 1e-3; PnP moves the frames away
    from the plain run's, and without the cache the port refuses, as JAX
    does."""
    tmp, vid, models, jmodels, caches = inverted
    cfg = _config(tmp, vid, "pnp")
    # one Generator a package serves both caches (JAX compiles its steps once)
    gen_j = JGenerator(jmodels, JConfigDict(cfg), data_parser=JParser(cfg["data"]))
    gen_t = Generator(models, ConfigDict(cfg), data_parser=VideoDataParser(cfg["data"]),
                      device="cpu")
    assert gen_t.tome_spec.align_batch and gen_j.tome_spec.align_batch
    outs = {}
    for cache_name, cache in caches.items():
        for name, gen in (("jax", gen_j), ("torch", gen_t)):
            outs[(name, cache_name)] = gen(str(cache), str(tmp / f"pnp_{name}_{cache_name}"),
                                           FRAME_IDS)["edit"]
    for cache_name in caches:
        out = outs[("torch", cache_name)]
        assert out.shape == (N, SIZE, SIZE, 3) and np.isfinite(out).all()
        _close(out, outs[("jax", cache_name)], 1e-3)
    _, plain = _run(Generator, models, ConfigDict, _config(tmp, vid, "none"), VideoDataParser,
                    caches["torch"], tmp / "plain_t", device="cpu")
    assert np.abs(plain - outs[("torch", "torch")]).max() > 1e-3
    with pytest.raises(FileNotFoundError, match="PnP needs latents"):
        _run(Generator, models, ConfigDict, cfg, VideoDataParser, tmp / "no_cache",
             tmp / "fail", device="cpu")


def test_controlnet_generation_matches_jax(inverted):
    """A canny ControlNet (control_scale 0.7) on the tiny SD stack from the
    port's cache: the frames against JAX's within 1e-3, the control images
    resized to 8x the latent size (the tiny VAE downsamples by 2), and the
    ControlNet moving the frames."""
    tmp, vid, models, _, caches = inverted
    cmodels = build_tiny_sd(seed=0, num_inference_steps=STEPS, device="cpu")
    cmodels.controlnet = _perturbed(ControlNetModel(cmodels.unet.config), 9)
    cfg = _config(tmp, vid, "canny", control_scale=0.7)
    gen_j, out_j = _run(JGenerator, _jax_models(cmodels), JConfigDict, cfg, JParser,
                        caches["torch"], tmp / "ctrl_j")
    gen_t, out_t = _run(Generator, cmodels, ConfigDict, cfg, VideoDataParser, caches["torch"],
                        tmp / "ctrl_t", device="cpu")
    assert gen_t._control_images.shape == (N, SIZE * 4, SIZE * 4, 3)
    np.testing.assert_array_equal(gen_t._control_images.numpy(),
                                  np.asarray(gen_j._control_images))
    _close(out_t, out_j, 1e-3)
    _, plain = _run(Generator, models, ConfigDict, _config(tmp, vid, "none"), VideoDataParser,
                    caches["torch"], tmp / "plain_c", device="cpu")
    assert np.abs(plain - out_t).max() > 1e-3
