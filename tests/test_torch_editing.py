"""The generic-SD editing path's parts against the JAX package on the same
weights and inputs (ROADMAP A10): the DDIM schedulers and DPM-Solver's
add_noise, the UNet's PnP and ControlNet hooks (on the tiny two-level
config and on a three-level one, where the second-coarsest level is not
the finest, so a misplaced injection site shows), the ControlNet, its
converter and exporter, the control preprocessors, the inversion cache's
indexing, `load_sd` and the CLI on `sd_version: "1.5"`. The end-to-end
runs (inversion, PnP and ControlNet generation, both cache directions) are
in tests/test_torch_editing_e2e.py.

Weights: port modules on random weights (`init_like_flax`, every leaf then
moved by noise), handed to the JAX modules with `bridge.module_to_flax`.
f32 throughout. Tolerances are stated at each test: schedulers 1e-6
(f32 scalar arithmetic in both), models 1e-4 of the output's largest
magnitude (f32 summation order through a few dozen layers, as
tests/test_torch_models.py holds the UNet)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tclight_tpu.data import controlnet_utils as jctrl
from tclight_tpu.diffusion import schedulers as jsched
from tclight_tpu.models import controlnet as jcontrolnet
from tclight_tpu.models.unet import UNet2DCondition as JUNet
from tclight_tpu.models.unet import UNetConfig as JUNetCfg
from tclight_tpu.pipeline import invert as jinvert
from tclight_torch.data import controlnet_utils
from tclight_torch.diffusion import schedulers
from tclight_torch.models import bridge, controlnet, convert
from tclight_torch.models.unet import UNet2DCondition, UNetConfig
from tclight_torch.pipeline import invert
from tclight_torch.pipeline.iclight import (build_tiny_sd, init_like_flax, load_sd,
                                           write_model_dir)
from tclight_torch.utils.video_io import save_frames

torch.set_num_threads(2)

RTOL = 1e-4

# the tiny config and a three-level one (levels 0, 1, 2; the PnP sites sit
# at level 1 there, at level 0 in the tiny one)
CONFIGS = {
    "tiny": dict(block_out_channels=(32, 64)),
    "three_level": dict(block_out_channels=(32, 64, 64)),
}


def _close(out, ref, rtol=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


def _perturbed(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Random flax-scaled weights, every leaf moved by noise (zero biases
    and unit norms carry information too)."""
    gen = torch.Generator().manual_seed(seed)
    init_like_flax(module, gen)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return module.eval().requires_grad_(False)


def _configs(name: str, in_channels: int = 4):
    kw = dict(in_channels=in_channels, layers_per_block=1, num_heads=2, context_dim=32,
              norm_groups=8, **CONFIGS[name])
    return UNetConfig(**kw), JUNetCfg(**kw)


# ------------------------------------------------------------ schedulers


@pytest.mark.parametrize("steps", [4, 25])
def test_ddim_step_and_inversion_match_jax(steps):
    """DDIM forward and inversion steps at every index (the t_prev / t_next
    < 0 guards included: alpha-bar 1), add_noise, the leading-spaced
    timesteps, the state scheduler's protocol, and DPM-Solver's add_noise,
    against JAX within 1e-6."""
    rng = np.random.default_rng(steps)
    eps, x = (rng.standard_normal((2, 6, 6, 4)).astype(np.float32) for _ in range(2))
    t_eps, t_x = torch.from_numpy(eps), torch.from_numpy(x)
    ours, ref = schedulers.DDIMScheduler(num_inference_steps=steps), jsched.DDIMScheduler(
        num_inference_steps=steps)
    np.testing.assert_array_equal(ours.timesteps(), ref.timesteps())
    for i in range(steps):
        for inversion in (False, True):
            _close(ours.step(t_eps, i, t_x, inversion=inversion).numpy(),
                   ref.step(jnp.asarray(eps), i, jnp.asarray(x), inversion=inversion), 1e-6)
    t = int(ours.timesteps()[1])
    _close(ours.add_noise(t_x, t_eps, t).numpy(),
           ref.add_noise(jnp.asarray(x), jnp.asarray(eps), t), 1e-6)

    state_s = schedulers.DDIMStateScheduler(num_inference_steps=steps)
    state_j = jsched.DDIMStateScheduler(num_inference_steps=steps)
    np.testing.assert_array_equal(state_s.timesteps(), state_j.timesteps())
    assert not state_s.sde
    s, sj = state_s.init_state(t_x), state_j.init_state(jnp.asarray(x))
    xs, xj = t_x, jnp.asarray(x)
    for _ in range(2):
        s, xs = state_s.step(s, t_eps, xs)
        sj, xj = state_j.step(sj, jnp.asarray(eps), xj)
    assert s == int(sj) == 2
    _close(xs.numpy(), xj, 1e-6)

    dpm = schedulers.DPMSolverMultistepScheduler(num_inference_steps=steps)
    jdpm = jsched.DPMSolverMultistepScheduler(
        num_inference_steps=steps)
    for k in (0, steps // 2):
        _close(dpm.add_noise(t_x, t_eps, k).numpy(),
               jdpm.add_noise(jnp.asarray(x), jnp.asarray(eps), k), 1e-6)


# ------------------------------------------------------------ UNet hooks


def _unet_pair(name: str, seed: int = 0):
    cfg, jcfg = _configs(name)
    unet = _perturbed(UNet2DCondition(cfg), seed)
    return unet, JUNet(jcfg), bridge.module_to_flax(unet)


def _residuals(unet: UNet2DCondition, x: np.ndarray, rng) -> tuple[list, np.ndarray]:
    """Random NHWC residuals shaped like the UNet's skips and mid output."""
    ch = unet.config.block_out_channels
    h, w = x.shape[1:3]
    shapes = [(h, w, ch[0])]
    for lvl, c in enumerate(ch):
        shapes += [(h, w, c)] * unet.config.layers_per_block
        if lvl < len(ch) - 1:
            h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1
            shapes.append((h, w, c))
    down = [0.5 * rng.standard_normal((x.shape[0],) + s).astype(np.float32) for s in shapes]
    mid = 0.5 * rng.standard_normal((x.shape[0], h, w, ch[-1])).astype(np.float32)
    return down, mid


@pytest.mark.parametrize("hook", ["pnp_attn", "pnp_conv", "residuals"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_unet_editing_hooks_match_jax(name, hook):
    """The UNet with one editing hook on, against JAX within 1e-4, on a
    [source | uncond | cond] batch of 3 x 2 frames at 24 x 24 latents (576
    tokens at level 0: the flash path's plain version); and the hook moves
    the output (it is not a no-op)."""
    unet, junet, params = _unet_pair(name)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 24, 24, 4)).astype(np.float32)
    ctx = rng.standard_normal((6, 77, 32)).astype(np.float32)
    kw_t, kw_j = {}, {}
    if hook == "residuals":
        down, mid = _residuals(unet, x, rng)
        kw_t = dict(down_residuals=[torch.from_numpy(r) for r in down],
                    mid_residual=torch.from_numpy(mid))
        kw_j = dict(down_residuals=[jnp.asarray(r) for r in down], mid_residual=jnp.asarray(mid))
    else:
        kw_t = kw_j = {hook: True}
    with torch.no_grad():
        out, _ = unet(torch.from_numpy(x), 500.0, torch.from_numpy(ctx), **kw_t)
        plain, _ = unet(torch.from_numpy(x), 500.0, torch.from_numpy(ctx))
    ref, _ = junet.apply(params, jnp.asarray(x), jnp.asarray(500.0), jnp.asarray(ctx), **kw_j)
    _close(out.numpy(), ref)
    assert np.abs(out.numpy() - plain.numpy()).max() > 1e-3
    with pytest.raises(ValueError, match="cfg_dedup"):
        unet(torch.from_numpy(x[:3]), 500.0, torch.from_numpy(ctx), cfg_dedup=True, **kw_t)


def test_pnp_hooks_inject_the_source_third():
    """With both PnP hooks on, the source third attends with its own Q/K
    and keeps its own features, so its eps is the one without injection
    (within 1e-5); the other two thirds' eps move."""
    unet, _, _ = _unet_pair("three_level", seed=3)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 24, 24, 4)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((3, 77, 32)).astype(np.float32))
    with torch.no_grad():
        inj, _ = unet(x, 300.0, ctx, pnp_attn=True, pnp_conv=True)
        plain, _ = unet(x, 300.0, ctx)
    _close(inj[:1].numpy(), plain[:1].numpy(), 1e-5)
    assert np.abs(inj[1:].numpy() - plain[1:].numpy()).max() > 1e-3


# ------------------------------------------------------------ ControlNet


def _controlnet_pair(seed: int = 4):
    cfg, jcfg = _configs("tiny")
    model = _perturbed(controlnet.ControlNetModel(cfg), seed)
    return model, jcontrolnet.ControlNetModel(jcfg), bridge.module_to_flax(model)


def test_controlnet_matches_jax():
    """ControlNet residuals (12 for SD1.5; 4 + mid for the tiny config) on
    2 frames of 16 x 16 latents and 128 x 128 control images, against JAX
    within 1e-4, each NHWC."""
    model, jmodel, params = _controlnet_pair()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    img = rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    with torch.no_grad():
        down, mid = model(torch.from_numpy(x), 300.0, torch.from_numpy(ctx),
                          torch.from_numpy(img))
    jdown, jmid = jmodel.apply(params, jnp.asarray(x), jnp.asarray(300.0), jnp.asarray(ctx),
                               jnp.asarray(img))
    assert len(down) == len(jdown) == 4
    for a, b in zip(down, jdown):
        assert a.shape == b.shape
        _close(a.numpy(), b)
    _close(mid.numpy(), jmid)


def test_controlnet_converter_and_exporter(tmp_path):
    """The exporter writes diffusers keys that both packages' converters
    read back into the model's own tree (JAX's and the port's converter
    agree leaf for leaf), and `load_controlnet` reads the written
    safetensors file into equal weights."""
    model, _, params = _controlnet_pair()
    ref = {k: v.numpy() for k, v in controlnet.reference_state_dict(model).items()}
    assert any(k.startswith("controlnet_down_blocks.") for k in ref)
    assert "controlnet_cond_embedding.blocks.5.weight" in ref
    ours = controlnet.convert_controlnet(ref, n_levels=2)
    theirs = jcontrolnet.convert_controlnet(ref, n_levels=2)
    for tree in (ours, theirs):
        flat = bridge.flax_to_state_dict(tree)
        assert flat.keys() == bridge.flax_to_state_dict(params).keys()
        for k, v in bridge.flax_to_state_dict(params).items():
            np.testing.assert_array_equal(flat[k].numpy(), v.numpy(), err_msg=k)
    convert.write_safetensors(controlnet.reference_state_dict(model), tmp_path / "c.safetensors")
    loaded = controlnet.load_controlnet(tmp_path / "c.safetensors", model.config, "cpu")
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(loaded.state_dict()[k].numpy(), v.numpy(), err_msg=k)


@pytest.mark.parametrize("kind,kw", [("canny", {}), ("canny", {"low": 20, "high": 60}),
                                     ("tile", {}), ("tile", {"resample_rate": 0.5}),
                                     ("ip2p", {})])
def test_control_preprocess_matches_jax(kind, kw):
    """canny (cv2 on the same uint8 frames), tile (identity, and a 0.5
    resample blur) and ip2p, equal to JAX's; the model-backed types without
    a `model_fn` refused with JAX's error, with one its output; 'none'
    refused."""
    rng = np.random.default_rng(6)
    frames = np.clip(rng.uniform(0, 1, (2, 40, 56, 3)) + np.linspace(0, 0.5, 56)[None, None, :,
                                                                               None],
                     0, 1).astype(np.float32)
    out = controlnet_utils.control_preprocess(frames, kind, **kw)
    np.testing.assert_array_equal(out, jctrl.control_preprocess(frames, kind, **kw))
    assert out.shape == frames.shape and out.dtype == np.float32
    assert controlnet_utils.CONTROLNET_DICT == jctrl.CONTROLNET_DICT
    for model_backed in controlnet_utils.MODEL_BACKED:
        with pytest.raises(NotImplementedError, match="needs a local model"):
            controlnet_utils.control_preprocess(frames, model_backed)
        with pytest.raises(NotImplementedError, match="needs a local model"):
            jctrl.control_preprocess(frames, model_backed)
        np.testing.assert_array_equal(controlnet_utils.control_preprocess(
            frames, model_backed, model_fn=lambda f: 1.0 - f), 1.0 - frames)
    with pytest.raises(ValueError):
        controlnet_utils.control_preprocess(frames, "none")


# ------------------------------------------------------------ the inversion cache


def test_latent_cache_indexes_by_frame_id(tmp_path):
    """`latent_filename` rounds t; `load_latent` picks rows by frame id (not
    position), `check_latent_exists` counts rows, as JAX's do on the same
    file."""
    arr = np.arange(6 * 2 * 2 * 4, dtype=np.float32).reshape(6, 2, 2, 4)
    np.save(invert.latent_filename(tmp_path, 500.6), arr)
    assert invert.latent_filename(tmp_path, 500.6) == jinvert.latent_filename(tmp_path, 500.6)
    assert invert.latent_filename(tmp_path, 500.6).name == "noisy_latents_501.npy"
    for ids in (None, [1, 3], [5, 0, 2]):
        np.testing.assert_array_equal(invert.load_latent(tmp_path, 501, ids),
                                      jinvert.load_latent(tmp_path, 501, ids))
    for ids in (None, [0] * 6, [0] * 7):
        assert (invert.check_latent_exists(tmp_path, 501.0, ids)
                == jinvert.check_latent_exists(tmp_path, 501.0, ids))
    assert not invert.check_latent_exists(tmp_path, 1.0)


# ------------------------------------------------------------ loading and the CLI


def test_load_sd_reads_a_written_model_dir(tmp_path):
    """`write_model_dir` writes the tiny SD stack and its ControlNet in the
    checkpoint layout; `load_sd` reads them back into equal weights, a DDIM
    scheduler and `model_key` "1.5". A missing ControlNet file is refused;
    sd_version depth reads the same files into the 5-channel stack."""
    models = build_tiny_sd(seed=2, num_inference_steps=3, device="cpu")
    models.controlnet = _perturbed(controlnet.ControlNetModel(models.unet.config), 7)
    write_model_dir(models, tmp_path, control="canny")
    loaded = load_sd(tmp_path, "1.5", 3, control="canny", device="cpu")
    assert loaded.model_key == "1.5" and not loaded.scheduler.sde
    assert loaded.scheduler.num_inference_steps == 3
    for name in ("unet", "vae", "text_encoder", "controlnet"):
        own, back = getattr(models, name).state_dict(), getattr(loaded, name).state_dict()
        assert own.keys() == back.keys()
        for k in own:
            np.testing.assert_array_equal(back[k].numpy(), own[k].numpy(), err_msg=f"{name}.{k}")
    with pytest.raises(FileNotFoundError, match="controlnet_tile"):
        load_sd(tmp_path, "1.5", 3, control="tile", device="cpu")
    depth = load_sd(tmp_path, "depth", 3, device="cpu")
    assert depth.model_key == "depth" and depth.unet.config.in_channels == 5
    np.testing.assert_array_equal(depth.unet.state_dict()["conv_in.weight"][:, :4].numpy(),
                                  models.unet.state_dict()["conv_in.weight"].numpy())


def _video(path: Path, n: int = 4, size: int = 32) -> Path:
    rng = np.random.default_rng(0)
    base = rng.uniform(0.2, 0.8, (size, size, 3)).astype(np.float32)
    save_frames(np.stack([np.roll(base, 2 * t, axis=1) for t in range(n)]), path)
    return path


def _cli_args(tmp_path, vid_dir, steps=2):
    return ["--config", "configs/tclight_default.yaml", "-i", str(vid_dir), "-p",
            "a watercolor painting", "sd_version=1.5", "post_opt.apply_opt=false",
            f"generation.n_timesteps={steps}", "data.height=32", "data.width=32",
            f"work_dir={tmp_path / 'wd'}", "generation.save_frame=false",
            "generation.frame_range=[0,4,1]", f"inversion.steps={steps}",
            f"inversion.save_steps={steps}", "inversion.save_intermediate=true",
            "generation.local_merge_ratio=0.0", "generation.global_merge_ratio=0.0"]


def _frames(mp4: Path) -> int:
    import cv2

    cap, n = cv2.VideoCapture(str(mp4)), 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


@pytest.mark.parametrize("control", ["pnp", "canny"])
def test_cli_runs_sd15_editing_on_cpu(tmp_path, monkeypatch, control):
    """`python -m tclight_torch.run` with `sd_version: "1.5"` on the CPU:
    the DDIM inversion writes the cache at every generation timestep, then
    the Generator runs PnP (the tiny random SD stack, TCLIGHT_TINY) or a
    canny ControlNet (a model_dir of tiny checkpoints), and writes an mp4
    of every frame; the run's config.yaml lists the inversion's seconds
    among its stage times. (`sd_version: depth`: test_torch_depth.py.)"""
    from tclight_torch.run import main

    monkeypatch.chdir(Path(__file__).resolve().parent.parent)
    vid = _video(tmp_path / "vid")
    args = _cli_args(tmp_path, vid) + [f"generation.control={control}"]
    if control == "pnp":
        monkeypatch.setenv("TCLIGHT_TINY", "1")
    else:
        models = build_tiny_sd(seed=1, device="cpu")
        models.controlnet = _perturbed(controlnet.ControlNetModel(models.unet.config), 8)
        write_model_dir(models, tmp_path / "model", control="canny")
        args.append(f"model_dir={tmp_path / 'model'}")
    assert main(args, device="cpu") == 0
    cache = tmp_path / "wd" / "latents"
    ts = schedulers.DDIMStateScheduler(num_inference_steps=2).timesteps()
    assert all(invert.check_latent_exists(cache, t, range(4)) for t in ts)
    assert np.load(invert.latent_filename(cache, ts[0])).shape == (4, 16, 16, 4)
    mp4s = sorted((tmp_path / "wd").rglob("output.mp4"))
    assert len(mp4s) == 1 and _frames(mp4s[0]) == 4
    stage_times = yaml.safe_load((mp4s[0].parent / "config.yaml").read_text())["stage_times"]
    assert stage_times["inversion"] > 0 and stage_times["sampling"] > 0
