"""The slice end to end: the port's Generator against the JAX package's on
the same tiny weights (handed over with tclight_torch/models/bridge.py), the
same video and config (the golden-regression config of
tests/test_golden_regression.py with the post-optimization off), and the
JAX package's init and SDE noise injected into the port. Clean latents and
decoded frames agree within 1e-3 (f32 summation order through two
sampling steps of UNet + ToMe + VAE). Also drives the port's CLI on the CPU
and checks its mp4.

The parity run sets both merge ratios to 0: every ToMe stage still runs
(matching, the bank carry from slot to slot, the unmerge row maps), but no
token is dropped. With the golden ratios the two packages do not agree,
and cannot: chunk slots are padded by repeating their last frame, so the
src tokens of a repeated frame all score ~1 against their own copies in
the dst frame, and WHICH of them fill the r merge places is decided by
f32 rounding differences between XLA's and torch's dot products. On chunk
plans without repeated frames the UNet step agrees to ~1e-5 with the golden
ratios (tests/test_torch_models.py holds the merging UNet on such inputs)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclight_tpu.config import ConfigDict as JConfigDict
from tclight_tpu.data.dataparsers import VideoDataParser as JParser
from tclight_tpu.diffusion.schedulers import DPMSolverMultistepScheduler as JDPM
from tclight_tpu.models.clip_text import CLIPTextConfig as JCLIPCfg
from tclight_tpu.models.clip_text import CLIPTextModel as JCLIP
from tclight_tpu.models.unet import UNet2DCondition as JUNet
from tclight_tpu.models.unet import UNetConfig as JUNetCfg
from tclight_tpu.models.vae import AutoencoderKL as JVAE
from tclight_tpu.models.vae import VAEConfig as JVAECfg
from tclight_tpu.pipeline.generator import Generator as JGenerator
from tclight_tpu.pipeline.iclight import DummyTokenizer as JTokenizer
from tclight_tpu.pipeline.iclight import ICLightModels as JModels
from tclight_torch.config import ConfigDict
from tclight_torch.data.dataparsers import VideoDataParser
from tclight_torch.models import bridge
from tclight_torch.pipeline.generator import Generator
from tclight_torch.pipeline.iclight import build_tiny_iclight
from tclight_torch.utils.video_io import save_frames

torch.set_num_threads(2)

N_FRAMES, SIZE, STEPS, SEED = 6, 32, 2, 7


def _video(tmp_path) -> Path:
    rng = np.random.default_rng(0)
    base = rng.uniform(0.2, 0.8, (SIZE, SIZE, 3)).astype(np.float32)
    frames = np.stack([np.roll(base, 2 * t, axis=1) for t in range(N_FRAMES)])
    vid_dir = tmp_path / "vid"
    save_frames(frames, vid_dir)
    return vid_dir


def _config(tmp_path, vid_dir) -> dict:
    return {
        "work_dir": str(tmp_path / "wd"),
        "data": {"scene_type": "video", "rgb_path": str(vid_dir),
                 "height": SIZE, "width": SIZE, "fps": 8},
        "generation": dict(
            guidance_scale=2.0, n_timesteps=STEPS, chunk_size=4,
            chunk_ord="mix-4", local_merge_ratio=0.0, merge_global=True,
            global_merge_ratio=0.0, align_batch=True, max_downsample=2,
            noise_mode="same", alpha_t=0.0, negative_prompt="bad quality",
            prompt={"golden": "warm sunset light"}, save_frame=False),
        "post_opt": {"apply_opt": False},
        "seed": SEED,
    }


def _recording(gen, store):
    orig = gen.ddim_sample

    def wrapped(*args, **kwargs):
        store.append(orig(*args, **kwargs))
        return store[-1]

    gen.ddim_sample = wrapped


def test_generator_matches_jax(tmp_path):
    vid_dir = _video(tmp_path)
    cfg = _config(tmp_path, vid_dir)
    models = build_tiny_iclight(seed=0, num_inference_steps=STEPS, device="cpu")
    jmodels = JModels(
        unet=JUNet(JUNetCfg.tiny(in_channels=8)),
        unet_params=bridge.module_to_flax(models.unet),
        vae=JVAE(JVAECfg.tiny()), vae_params=bridge.module_to_flax(models.vae),
        text_encoder=JCLIP(JCLIPCfg.tiny()),
        text_params=bridge.module_to_flax(models.text_encoder),
        tokenizer=JTokenizer(vocab_size=1000),
        scheduler=JDPM(num_inference_steps=STEPS))

    jcfg = JConfigDict(cfg)
    jgen = JGenerator(jmodels, jcfg, data_parser=JParser(jcfg.data))
    j_latents: list = []
    _recording(jgen, j_latents)
    out_j = jgen(None, str(tmp_path / "out_j"), list(range(N_FRAMES)))["golden"]

    # the noise the JAX Generator drew: init from PRNGKey(seed), one SDE
    # draw per step from the split chain of PRNGKey(seed)
    init = np.asarray(jgen.prepare_init_noise(N_FRAMES, SIZE, SIZE, SEED))
    key, step_noises = jax.random.PRNGKey(SEED), []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        step_noises.append(np.asarray(jax.random.normal(sub, init.shape, jnp.float32)))

    tcfg = ConfigDict(cfg)
    gen = Generator(models, tcfg, data_parser=VideoDataParser(tcfg.data), device="cpu")
    t_latents: list = []
    _recording(gen, t_latents)
    out_t = gen(None, str(tmp_path / "out_t"), list(range(N_FRAMES)),
                init_noise=torch.from_numpy(init.copy()), step_noises=step_noises)["golden"]

    np.testing.assert_allclose(t_latents[0].numpy(), np.asarray(j_latents[0]), atol=1e-3)
    assert out_t.shape == out_j.shape == (N_FRAMES, SIZE, SIZE, 3)
    np.testing.assert_allclose(out_t, np.asarray(out_j), atol=1e-3)
    out_dir = tmp_path / "out_t" / "lmr_0.0_gmr_0.0_alpha_t_0.0_opt_golden"
    for name in ("output.mp4", "output_gt.mp4", "config.yaml"):
        assert (out_dir / name).is_file(), name


def test_step_with_golden_ratios_matches_on_distinct_frames(tmp_path):
    """One xy denoising pass with the golden merge ratios (0.5 / 0.5) over a
    chunk plan whose slots hold no repeated frame: every slot merges, the
    second against the bank of the first, with cfg_dedup."""
    from tclight_tpu.pipeline.chunks import ChunkPlan as JPlan
    from tclight_torch.pipeline.chunks import ChunkPlan

    cfg = _config(tmp_path, _video(tmp_path))
    cfg["generation"].update(local_merge_ratio=0.5, global_merge_ratio=0.5)
    models = build_tiny_iclight(seed=1, device="cpu")
    jmodels = JModels(
        unet=JUNet(JUNetCfg.tiny(in_channels=8)),
        unet_params=bridge.module_to_flax(models.unet),
        vae=JVAE(JVAECfg.tiny()), vae_params=None, text_encoder=None,
        text_params=None, tokenizer=None, scheduler=JDPM(num_inference_steps=STEPS))
    jgen = JGenerator(jmodels, JConfigDict(cfg))
    gen = Generator(models, ConfigDict(cfg), device="cpu")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 16, 16, 4)).astype(np.float32)
    cc = rng.standard_normal((8, 16, 16, 4)).astype(np.float32)
    emb = [rng.standard_normal((1, 77, 32)).astype(np.float32) for _ in range(2)]
    idx = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    valid = np.ones((2, 4), bool)
    randfs, flips = np.array([1, 2]), np.array([False, True])
    ref = jax.jit(jgen._step_core)(
        jmodels.unet_params, jnp.asarray(x), jnp.asarray(cc),
        tuple(jnp.asarray(e) for e in emb), jnp.float32(500.0), jnp.asarray(idx),
        jnp.asarray(valid), jnp.asarray(randfs, jnp.int32), jnp.asarray(flips))
    out = gen._step_core(torch.from_numpy(x), torch.from_numpy(cc),
                         tuple(torch.from_numpy(e) for e in emb), 500.0,
                         ChunkPlan(idx, valid), randfs, flips)
    ref = np.asarray(ref)
    assert JPlan(idx, valid).n_slots == 2
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()))


def _cli_args(tmp_path, vid_dir):
    return ["--config", "configs/tclight_default.yaml", "-i", str(vid_dir),
            "-p", "warm sunset light", "post_opt.apply_opt=false",
            f"generation.n_timesteps={STEPS}", f"data.height={SIZE}",
            f"data.width={SIZE}", f"work_dir={tmp_path / 'wd'}",
            "generation.save_frame=false"]


def test_cli_runs_tiny_on_cpu(tmp_path, monkeypatch):
    import cv2

    from tclight_torch.run import main

    monkeypatch.chdir(Path(__file__).resolve().parent.parent)
    monkeypatch.setenv("TCLIGHT_TINY", "1")
    vid_dir = _video(tmp_path)
    assert main(_cli_args(tmp_path, vid_dir), device="cpu") == 0
    mp4s = sorted((tmp_path / "wd").rglob("output.mp4"))
    assert len(mp4s) == 1
    cap = cv2.VideoCapture(str(mp4s[0]))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == N_FRAMES


def test_unported_options_raise(tmp_path):
    vid_dir = _video(tmp_path)
    models = build_tiny_iclight(device="cpu")
    for key, value in (("alpha_t", 0.4), ("control", "pnp"), ("background_cond", True)):
        cfg = _config(tmp_path, vid_dir)
        cfg["generation"][key] = value
        with pytest.raises(NotImplementedError):
            Generator(models, ConfigDict(cfg), device="cpu")
    cfg = _config(tmp_path, vid_dir)
    cfg["post_opt"]["apply_opt"] = True
    with pytest.raises(NotImplementedError):
        Generator(models, ConfigDict(cfg), device="cpu")
    cfg = _config(tmp_path, vid_dir)
    cfg["generation"]["prompt"] = {"default": None}
    gen = Generator(models, ConfigDict(cfg), data_parser=VideoDataParser(cfg["data"]),
                    device="cpu")
    with pytest.raises(NotImplementedError, match="prompt"):
        gen(None, str(tmp_path / "out"), list(range(N_FRAMES)))
