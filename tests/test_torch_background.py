"""Background-conditioned relighting against the JAX package (ROADMAP A11):
BriaRMBG (its forward, its converter, the reference-layout exporter and
`load_rmbg`), `compute_alpha_mattes` and `Generator.composite_background`
of the fbc Generator, and the fbc Generator end to end with
`background_cond` (the composite, then the background latents as concat
conditions) on the tiny stack.

RMBG runs at full width (RMBG-1.4 has one size) on random weights with
moved BatchNorm statistics, written as a reference checkpoint; f32. The
matting resolution of `compute_alpha_mattes` does not shrink with the frame
(about 1M pixels: 896 x 1152 for 720 x 960 frames), so each package mattes
one frame, once, in `test_composite_background_matches_jax`, which records
the mattes both packages' `compute_alpha_mattes` return (a recording
wrapper that changes no result). The end-to-end Generator run replaces
both packages' `compute_alpha_mattes` by one cheap matte (the frame's mean
colour), so that it holds the Generator's wiring at 4 frames; the real
mattes are held by the test before it. Tolerances at each test."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tclight_tpu.models.briarmbg as jrmbg
import tclight_torch.models.briarmbg as trmbg
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

N, H, W, STEPS, SEED = 4, 24, 32, 2, 5


@pytest.fixture(scope="module")
def rmbg_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("rmbg") / "model.pth"
    model = trmbg.random_rmbg(0, "cpu")
    torch.save(trmbg.reference_state_dict(model), path)
    return model, path


def test_rmbg_matches_jax(rmbg_ckpt):
    """The exporter's state dict is what both converters read into the same
    variables; `load_rmbg` reads the checkpoint into equal weights; the six
    side outputs at 72 x 88 (odd sizes from level 3 down: the ceil-mode
    pooling and the bilinear upsampling) agree with JAX's within 1e-5
    (sigmoids in [0, 1]; f32 ~2e-7 measured). `random_rmbg`'s side outputs
    spread over (0, 1): at least half of each map's values lie in (0.01,
    0.99), so the comparison is not one of saturated or flat maps."""
    model, path = rmbg_ckpt
    sd = {k: v.numpy() for k, v in trmbg.reference_state_dict(model).items()}
    ours, theirs = trmbg.convert_rmbg_params(sd), jrmbg.convert_rmbg_params(sd)
    for coll in ("params", "batch_stats"):
        a, b = bridge.flax_to_state_dict(ours[coll]), bridge.flax_to_state_dict(theirs[coll])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)
    loaded = trmbg.load_rmbg(path, "cpu")
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(loaded.state_dict()[k].numpy(), v.numpy(), err_msg=k)
    x = np.random.default_rng(0).uniform(0, 255, (1, 72, 88, 3)).astype(np.float32)
    with torch.no_grad():
        out = loaded(torch.from_numpy(x))
    ref = jax.jit(jrmbg.BriaRMBG().apply)(theirs, jnp.asarray(x))
    assert len(out) == len(ref) == 6
    for a, b in zip(out, ref):
        assert a.shape == b.shape == (1, 72, 88, 1)
        assert ((a > 0.01) & (a < 0.99)).float().mean() >= 0.5
        assert a.std() >= 0.05
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    assert trmbg.working_size(720, 960) == (896, 1152)


def _video(path: Path, n: int, seed: int) -> Path:
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.1, 0.9, (H, W, 3)).astype(np.float32)
    save_frames(np.stack([np.roll(base, 2 * t, axis=1) for t in range(n)]), path)
    return path


def _config(tmp_path: Path, vid: Path, bg: Path, ckpt) -> dict:
    return {
        "work_dir": str(tmp_path / "wd"),
        "data": {"scene_type": "video", "rgb_path": str(vid), "height": H, "width": W,
                 "fps": 8},
        "generation": dict(
            guidance_scale=2.0, n_timesteps=STEPS, chunk_size=4, chunk_ord="mix-4",
            local_merge_ratio=0.0, merge_global=True, global_merge_ratio=0.0,
            align_batch=True, max_downsample=2, noise_mode="same", alpha_t=0.0,
            negative_prompt="bad quality", prompt={"bg": "sunset behind"}, save_frame=False,
            background_cond=True, background_image_path=str(bg),
            rmbg_ckpt=None if ckpt is None else str(ckpt)),
        "post_opt": {"apply_opt": False},
        "seed": SEED,
    }


def _jax_models(models) -> JModels:
    return JModels(
        unet=JUNet(JUNetCfg.tiny(in_channels=12)),
        unet_params=bridge.module_to_flax(models.unet),
        vae=JVAE(JVAECfg.tiny()), vae_params=bridge.module_to_flax(models.vae),
        text_encoder=JCLIP(JCLIPCfg.tiny()),
        text_params=bridge.module_to_flax(models.text_encoder),
        tokenizer=JTokenizer(vocab_size=1000), scheduler=JDPM(num_inference_steps=STEPS))


def test_composite_background_matches_jax(tmp_path, rmbg_ckpt, monkeypatch):
    """The fbc Generators' `composite_background` on one frame over a
    2-frame background video: the mattes (896 x 1152 matting, resized back;
    half of them at least in (0.01, 0.99)) within 1e-4 of JAX's, the
    composite within 1e-4, and the frames
    changed; without a checkpoint on disk both return the frames as they
    are."""
    recorded = {}

    def recording(name, fn):
        def wrapped(*args, **kwargs):
            recorded[name] = fn(*args, **kwargs)
            return recorded[name]
        return wrapped

    monkeypatch.setattr(jrmbg, "compute_alpha_mattes",
                        recording("jax", jrmbg.compute_alpha_mattes))
    monkeypatch.setattr(trmbg, "compute_alpha_mattes",
                        recording("torch", trmbg.compute_alpha_mattes))
    vid, bg = _video(tmp_path / "vid", 1, 0), _video(tmp_path / "bg", 2, 1)
    models = build_tiny_iclight(in_channels=12, num_inference_steps=STEPS, device="cpu")
    outs = {}
    for ckpt in (rmbg_ckpt[1], tmp_path / "missing.pth"):
        cfg = _config(tmp_path, vid, bg, ckpt)
        jgen = JGenerator(_jax_models(models), JConfigDict(cfg), data_parser=JParser(cfg["data"]))
        tgen = Generator(models, ConfigDict(cfg), data_parser=VideoDataParser(cfg["data"]),
                         device="cpu")
        frames = tgen.data_parser.load_video(frame_ids=[0])
        outs[ckpt] = (tgen.composite_background(frames),
                      np.asarray(jgen.composite_background(frames)), frames)
    out, ref, frames = outs[rmbg_ckpt[1]]
    assert recorded["torch"].shape == recorded["jax"].shape == (1, H, W)
    assert ((recorded["torch"] > 0.01) & (recorded["torch"] < 0.99)).mean() >= 0.5
    np.testing.assert_allclose(recorded["torch"], recorded["jax"], rtol=0, atol=1e-4)
    assert out.shape == frames.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    assert np.abs(out - frames).max() > 1e-3
    out, ref, frames = outs[tmp_path / "missing.pth"]
    np.testing.assert_array_equal(out, frames)
    np.testing.assert_array_equal(ref, frames)


def _mean_matte(*args):
    """The frame's mean colour as a matte: a cheap stand-in for RMBG."""
    frames = args[-1]
    return np.clip(np.asarray(frames).mean(-1), 0.0, 1.0).astype(np.float32)


def test_fbc_generator_with_background_cond_matches_jax(tmp_path, rmbg_ckpt, monkeypatch):
    """The fbc Generator with `background_cond` end to end, the port
    against JAX (the JAX package's init and SDE noise injected), with both
    packages' mattes replaced by `_mean_matte`: the saved ground truth is
    the composite, and the relit frames agree within 1e-3 (f32 through two
    sampling steps, as tests/test_torch_pipeline.py holds the fc path)."""
    import cv2

    monkeypatch.setattr(jrmbg, "compute_alpha_mattes", lambda model, variables, frames:
                        _mean_matte(frames))
    monkeypatch.setattr(trmbg, "compute_alpha_mattes", lambda model, frames: _mean_matte(frames))
    vid, bg = _video(tmp_path / "vid", N, 0), _video(tmp_path / "bg", 3, 1)
    cfg = _config(tmp_path, vid, bg, rmbg_ckpt[1])
    models = build_tiny_iclight(in_channels=12, num_inference_steps=STEPS, device="cpu")
    jgen = JGenerator(_jax_models(models), JConfigDict(cfg), data_parser=JParser(cfg["data"]))
    out_j = jgen(None, str(tmp_path / "out_j"), list(range(N)))["bg"]
    init = np.asarray(jgen.prepare_init_noise(N, H, W, SEED))
    key, step_noises = jax.random.PRNGKey(SEED), []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        step_noises.append(np.asarray(jax.random.normal(sub, init.shape, jnp.float32)))
    tgen = Generator(models, ConfigDict(cfg), data_parser=VideoDataParser(cfg["data"]),
                     device="cpu")
    out_t = tgen(None, str(tmp_path / "out_t"), list(range(N)),
                 init_noise=torch.from_numpy(init.copy()), step_noises=step_noises)["bg"]
    assert out_t.shape == (N, H, W, 3)
    np.testing.assert_allclose(out_t, np.asarray(out_j), rtol=0, atol=1e-3)

    frames = tgen.data_parser.load_video(frame_ids=list(range(N)))
    bgs = tgen.data_parser.load_video(path=str(bg))
    bgs = np.concatenate([bgs, bgs])[:N]
    alpha = _mean_matte(frames)[..., None]
    composite = alpha * frames + (1 - alpha) * bgs
    gt = next((tmp_path / "out_t").rglob("output_gt.mp4"))
    cap = cv2.VideoCapture(str(gt))
    ok, first = cap.read()
    cap.release()
    assert ok
    first = cv2.cvtColor(first, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
    # an mp4 (lossy) of the composite: near it, and farther from the frames
    assert np.abs(first - composite[0]).mean() < np.abs(first - frames[0]).mean()
