"""The sd-depth path (ROADMAP A10b) against the JAX package: the 5-channel
tiny SD stack whose fifth channel is the frames' depth maps at latent
size, through the DDIM inversion and the Generator, with the same
weights (bridged), video and config, on the CPU in f32.

- With an injected `depth_fn` (the counterpart of tests/test_dpt.py's
  `test_sd_depth_pipeline_e2e`): the inversion caches within 1e-4 of
  their largest magnitude, the frames within 1e-3 (as
  test_torch_editing_e2e.py holds the 4-channel path), the depth caches
  equal; each package reads the other's depth cache.
- With a tiny-hybrid DPT checkpoint (`generation.depth_ckpt`; JAX's
  `dpt_config_for_state_dict` knows only the published widths, so it is
  handed the tiny config): the same, the depth caches within 1e-4.
- `load_sd(sd_version="depth")` widens a written UNet's conv_in to 5
  channels (the fifth zero), and `python -m tclight_torch.run` runs
  `sd_version=depth` on the tiny stack with the DPT checkpoint.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tclight_torch.config import ConfigDict
from tclight_torch.data.dataparsers import VideoDataParser
from tclight_torch.models import bridge, dpt
from tclight_torch.pipeline import invert
from tclight_torch.pipeline.generator import Generator
from tclight_torch.pipeline.iclight import build_tiny_sd, load_sd, write_model_dir
from tclight_tpu.config import ConfigDict as JConfigDict
from tclight_tpu.data.dataparsers import VideoDataParser as JParser
from tclight_tpu.diffusion.schedulers import DDIMStateScheduler as JDDIM
from tclight_tpu.models import dpt as jdpt
from tclight_tpu.models.clip_text import CLIPTextConfig as JCLIPCfg
from tclight_tpu.models.clip_text import CLIPTextModel as JCLIP
from tclight_tpu.models.unet import UNet2DCondition as JUNet
from tclight_tpu.models.unet import UNetConfig as JUNetCfg
from tclight_tpu.models.vae import AutoencoderKL as JVAE
from tclight_tpu.models.vae import VAEConfig as JVAECfg
from tclight_tpu.pipeline.generator import Generator as JGenerator
from tclight_tpu.pipeline.iclight import DummyTokenizer as JTokenizer
from tclight_tpu.pipeline.iclight import ICLightModels as JModels
from tclight_tpu.pipeline.invert import Inverter as JInverter
from test_torch_editing import _cli_args, _frames, _video
from test_torch_editing_e2e import FRAME_IDS, N, SIZE, STEPS, _close, _config

torch.set_num_threads(2)

DEPTH_TOL = 1e-4


def _jax_depth_models(models) -> JModels:
    return JModels(
        unet=JUNet(JUNetCfg.tiny(in_channels=5)), unet_params=bridge.module_to_flax(models.unet),
        vae=JVAE(JVAECfg.tiny()), vae_params=bridge.module_to_flax(models.vae),
        text_encoder=JCLIP(JCLIPCfg.tiny()),
        text_params=bridge.module_to_flax(models.text_encoder),
        tokenizer=JTokenizer(vocab_size=1000), scheduler=JDDIM(num_inference_steps=STEPS),
        model_key="depth")


def fake_depth(frames, latent_hw):
    """tests/test_dpt.py's stand-in estimator: the frames' mean channel,
    strided down to latent size, in [-1, 1]."""
    lh, lw = latent_hw
    d = frames.mean(axis=-1, keepdims=True)
    d = d[:, :: d.shape[1] // lh, :: d.shape[2] // lw][:, :lh, :lw]
    return (2.0 * d - 1.0).astype(np.float32)


def _runs(tmp: Path, cfg: dict, depth_fn=None):
    """Both packages' inversion of the 4-frame video into their own cache,
    then their Generators from the port's cache: (cache dirs, outputs,
    Generators)."""
    models = build_tiny_sd(seed=0, num_inference_steps=STEPS, device="cpu", sd_version="depth")
    assert models.unet.config.in_channels == 5 and models.model_key == "depth"
    jmodels = _jax_depth_models(models)
    caches = {"jax": tmp / "cache_jax", "torch": tmp / "cache_torch"}
    jinv = JInverter(jmodels, JConfigDict(cfg), data_parser=JParser(cfg["data"]))
    inv = invert.Inverter(models, ConfigDict(cfg), data_parser=VideoDataParser(cfg["data"]),
                          device="cpu")
    if depth_fn is not None:
        jinv.depth_fn = inv.depth_fn = depth_fn
    jinv(str(caches["jax"]), FRAME_IDS)
    inv(caches["torch"], FRAME_IDS)
    gen_j = JGenerator(jmodels, JConfigDict(cfg), data_parser=JParser(cfg["data"]))
    gen_t = Generator(models, ConfigDict(cfg), data_parser=VideoDataParser(cfg["data"]),
                      device="cpu")
    if depth_fn is not None:
        gen_j.depth_fn = gen_t.depth_fn = depth_fn
    outs = {"jax": gen_j(str(caches["torch"]), str(tmp / "out_jax"), FRAME_IDS)["edit"],
            "torch": gen_t(str(caches["torch"]), str(tmp / "out_torch"), FRAME_IDS)["edit"]}
    return caches, outs, gen_j, gen_t


def _check(caches, outs, tmp: Path, depth_tol: float) -> None:
    names = sorted(p.name for p in caches["jax"].glob("*.npy"))
    assert names and names == sorted(p.name for p in caches["torch"].glob("*.npy"))
    for name in names:
        ref = np.load(caches["jax"] / name)
        _close(np.load(caches["torch"] / name), ref, 1e-4 * float(np.abs(ref).max()))
    assert outs["torch"].shape == (N, SIZE, SIZE, 3) and np.isfinite(outs["torch"]).all()
    _close(outs["torch"], outs["jax"], 1e-3)
    name = f"depth_{N}_{SIZE // 2}x{SIZE // 2}.npy"
    dj, dt = (np.load(tmp / f"out_{p}" / "depth" / name) for p in ("jax", "torch"))
    assert dt.shape == (N, SIZE // 2, SIZE // 2, 1) and np.ptp(dt) > 0.5
    _close(dt, dj, depth_tol)


def test_sd_depth_pipeline_matches_jax(tmp_path):
    vid = _video(tmp_path / "vid")
    cfg = _config(tmp_path, vid, "none")
    caches, outs, gen_j, gen_t = _runs(tmp_path, cfg, fake_depth)
    _check(caches, outs, tmp_path, 0.0)
    # the depth channel moves the frames: a zero depth map gives others
    gen_z = Generator(gen_t.models, ConfigDict(cfg), data_parser=VideoDataParser(cfg["data"]),
                      device="cpu")
    gen_z.depth_fn = lambda frames, hw: np.zeros((len(frames), *hw, 1), np.float32)
    zero = gen_z(str(caches["torch"]), str(tmp_path / "out_zero"), FRAME_IDS)["edit"]
    assert np.abs(zero - outs["torch"]).max() > 1e-3
    # each package reads the other's depth cache (neither has a depth_fn or
    # a depth_ckpt now: a miss would raise)
    frames = VideoDataParser(cfg["data"]).load_video(frame_ids=FRAME_IDS)
    gen_t.depth_fn = gen_j.depth_fn = None
    hw = (SIZE // 2, SIZE // 2)
    name = f"depth_{N}_{hw[0]}x{hw[1]}.npy"
    np.testing.assert_array_equal(gen_t.prepare_depth(frames, hw, tmp_path / "out_jax"),
                                  np.load(tmp_path / "out_jax" / "depth" / name))
    np.testing.assert_array_equal(np.asarray(gen_j.prepare_depth(frames, hw,
                                                                 tmp_path / "out_torch")),
                                  np.load(tmp_path / "out_torch" / "depth" / name))
    with pytest.raises(FileNotFoundError, match="depth_ckpt"):
        gen_t.prepare_depth(frames, hw, tmp_path / "no_cache")


@pytest.fixture(scope="module")
def dpt_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("dpt") / "dpt.pth"
    torch.save(dpt.reference_state_dict(dpt.random_dpt(dpt.DPTConfig.tiny_hybrid(), 21, "cpu")),
               path)
    return path


def test_sd_depth_from_a_dpt_checkpoint_matches_jax(tmp_path, monkeypatch, dpt_ckpt):
    monkeypatch.setattr(jdpt, "dpt_config_for_state_dict",
                        lambda sd: jdpt.DPTConfig.tiny_hybrid())
    vid = _video(tmp_path / "vid")
    cfg = _config(tmp_path, vid, "none", depth_ckpt=str(dpt_ckpt))
    caches, outs, _, _ = _runs(tmp_path, cfg)
    _check(caches, outs, tmp_path, DEPTH_TOL)


def test_cli_runs_sd_depth_on_cpu(tmp_path, monkeypatch, dpt_ckpt):
    """`load_sd(sd_version="depth")` on a written 4-channel model_dir: conv_in
    widened to 5 channels, the first four the written ones, the fifth 0;
    then `python -m tclight_torch.run` with `sd_version=depth` (the tiny
    stack, TCLIGHT_TINY) and the DPT checkpoint: the inversion cache, the
    depth cache and an mp4 of every frame."""
    from tclight_torch.run import main

    models = build_tiny_sd(seed=2, device="cpu")
    write_model_dir(models, tmp_path / "model")
    loaded = load_sd(tmp_path / "model", "depth", 2, device="cpu")
    w = loaded.unet.state_dict()["conv_in.weight"]
    assert loaded.model_key == "depth" and w.shape[1] == 5
    assert torch.equal(w[:, :4], models.unet.state_dict()["conv_in.weight"])
    assert not w[:, 4].any()
    for k, v in models.unet.state_dict().items():
        if k != "conv_in.weight":
            assert torch.equal(loaded.unet.state_dict()[k], v), k

    monkeypatch.chdir(Path(__file__).resolve().parent.parent)
    monkeypatch.setenv("TCLIGHT_TINY", "1")
    vid = _video(tmp_path / "vid")
    args = _cli_args(tmp_path, vid) + ["sd_version=depth", f"generation.depth_ckpt={dpt_ckpt}",
                                       "generation.control=none"]
    assert main(args, device="cpu") == 0
    mp4s = sorted((tmp_path / "wd").rglob("output.mp4"))
    assert len(mp4s) == 1 and _frames(mp4s[0]) == 4
    assert invert.check_latent_exists(tmp_path / "wd" / "latents",
                                      JDDIM(num_inference_steps=2).timesteps()[0], range(4))
    depth = np.load(next((tmp_path / "wd").rglob("depth_4_16x16.npy")))
    assert depth.shape == (4, 16, 16, 1) and depth.min() == -1.0 and depth.max() == 1.0
