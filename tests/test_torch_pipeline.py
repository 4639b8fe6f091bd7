"""The slices end to end: the port's Generator against the JAX package's on
the same tiny weights (handed over with tclight_torch/models/bridge.py), the
same video and config (the golden-regression config of
tests/test_golden_regression.py, with the post-optimization off and on),
and the JAX package's init and SDE noise injected into the port. Clean
latents and decoded frames agree within 1e-3 (f32 summation order through
two sampling steps of UNet + ToMe + VAE); with the post-optimization the
tolerance and its reason are stated at the test, as for the yt pass
(alpha_t > 0) and the int8 attention. Also drives the port's CLI on the
CPU and checks its mp4.

The parity runs set both merge ratios to 0: every ToMe stage still runs
(matching, the bank carry from slot to slot, the unmerge row maps), but no
token is dropped. The golden ratios are held by
`test_golden_ratios_agree_with_the_jax_matcher` (ROADMAP C1)."""

from pathlib import Path
from types import SimpleNamespace

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


def _jax_models(models):
    return JModels(
        unet=JUNet(JUNetCfg.tiny(in_channels=8)),
        unet_params=bridge.module_to_flax(models.unet),
        vae=JVAE(JVAECfg.tiny()), vae_params=bridge.module_to_flax(models.vae),
        text_encoder=JCLIP(JCLIPCfg.tiny()),
        text_params=bridge.module_to_flax(models.text_encoder),
        tokenizer=JTokenizer(vocab_size=1000),
        scheduler=JDPM(num_inference_steps=STEPS))


def _run_pair(tmp_path, cfg):
    """Both Generators on the same weights, video and config, with the JAX
    package's init and SDE noise injected into the port. Returns
    (port latents, JAX latents, port frames, JAX frames, port Generator,
    JAX Generator)."""
    models = build_tiny_iclight(seed=0, num_inference_steps=STEPS, device="cpu")
    jcfg = JConfigDict(cfg)
    jgen = JGenerator(_jax_models(models), jcfg, data_parser=JParser(jcfg.data))
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
    return t_latents[0].numpy(), np.asarray(j_latents[0]), out_t, np.asarray(out_j), gen, jgen


def test_generator_matches_jax(tmp_path):
    vid_dir = _video(tmp_path)
    lat_t, lat_j, out_t, out_j, _, _ = _run_pair(tmp_path, _config(tmp_path, vid_dir))
    np.testing.assert_allclose(lat_t, lat_j, atol=1e-3)
    assert out_t.shape == out_j.shape == (N_FRAMES, SIZE, SIZE, 3)
    np.testing.assert_allclose(out_t, out_j, atol=1e-3)
    out_dir = tmp_path / "out_t" / "lmr_0.0_gmr_0.0_alpha_t_0.0_opt_golden"
    for name in ("output.mp4", "output_gt.mp4", "config.yaml"):
        assert (out_dir / name).is_file(), name


@pytest.mark.parametrize("extra", [
    {},                                   # the yt pass binds the xy models
    {"chunk_size": 2, "chunk_size_t": 4},  # ... or its own ToMeSpec of 4 columns
])
def test_generator_with_yt_pass_matches_jax(tmp_path, extra):
    """The multi-axis pass (alpha_t > 0): every step also runs the yt pass
    over two overlapping 4-frame windows of the 6 frames (starts 0 and 2),
    the 16 latent columns chunked 4 at a time, and fuses it into the xy
    prediction with AdaIN and the decayed weight. The chunk plans, randfs
    and flips of both passes come from one host generator in the JAX
    package's order, so the pair agrees within 1e-3, as the xy pair (the
    worst seen is 9e-5 of latents of order 76)."""
    cfg = _config(tmp_path, _video(tmp_path))
    cfg["generation"].update(alpha_t=0.3, win_size_t=4, **extra)
    lat_t, lat_j, out_t, out_j, gen, _ = _run_pair(tmp_path, cfg)
    np.testing.assert_allclose(lat_t, lat_j, atol=1e-3)
    np.testing.assert_allclose(out_t, out_j, atol=1e-3)
    assert gen._yt_windows(N_FRAMES) == (4, [0, 2], [2])
    models_t = gen._yt_bind(gen._yt_chunk_size(SIZE // 2, 4))
    assert (models_t is gen.models) == (not extra)
    assert models_t.tome_spec.n_frames == 4


def _count_int8_calls(monkeypatch) -> list:
    """Record the arguments of every call of the plain int8 attention,
    which the port's CPU path reaches for backend "int8" / "int8pv"."""
    from tclight_torch.ops import attention as tattn

    calls, plain = [], tattn.flash_attention_int8_plain

    def counted(*a):
        calls.append(a)
        return plain(*a)

    monkeypatch.setattr(tattn, "flash_attention_int8_plain", counted)
    return calls


@pytest.mark.parametrize("extra", [
    {"alpha_t": 0.3, "win_size_t": 4, "attn_qk_int8": True},
    {"attn_qk_int8": True, "attn_pv_int8": True},
])
def test_generator_with_int8_attention_matches_jax(tmp_path, extra, monkeypatch):
    """The int8 attention in the Generator (with the yt pass, and QK+PV on
    the xy path): the 4-frame slots' self-attention has 1024 + bank keys,
    so it takes the int8 backend in both packages (the call count shows the
    port's). Held at 1e-3 of the largest latent and 1e-3 in the frames
    (the worst seen: 3.8e-2 of latents of order 67, i.e. 5.7e-4 of it, and
    6.3e-4 in the frames). Against the fp pair's 9e-5 this is the
    quantization grid: the packages' f32 activations differ by ulps, an
    activation at a rounding tie of its int8 grid lands one step (1/127 of
    its scale) apart, and two sampling steps carry that on."""
    calls = _count_int8_calls(monkeypatch)
    cfg = _config(tmp_path, _video(tmp_path))
    cfg["generation"].update(extra)
    lat_t, lat_j, out_t, out_j, gen, jgen = _run_pair(tmp_path, cfg)
    pv = bool(extra.get("attn_pv_int8"))
    assert gen.attn_backend == ("int8pv" if pv else "int8")
    assert jgen.attn_backend == "pallas_" + gen.attn_backend
    assert calls and {c[4] for c in calls} == {pv}
    np.testing.assert_allclose(lat_t, lat_j, rtol=0, atol=1e-3 * np.abs(lat_j).max())
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-3)


def _postopt_config(tmp_path, vid_dir) -> dict:
    """The golden-regression post_opt block (3 + 3 epochs, 2 MS-SSIM
    levels for 32x32 frames) on Farneback flows."""
    cfg = _config(tmp_path, vid_dir)
    cfg["data"]["flow_model"] = "farneback"
    cfg["post_opt"] = {
        "apply_opt": True, "epochs_exposure": 3, "epochs": 3, "batch_size": 4,
        "lambda_dssim": 0.2, "lambda_flow": 0.8, "lambda_tv": 0.05, "feature_lr": 0.05,
        "exposure_lr_init": 0.01, "exposure_lr_final": 0.001,
        "exposure_lr_delay_steps": 0, "exposure_lr_delay_mult": 0.0,
        "ms_ssim_levels": 2}
    return cfg


def test_generator_with_postopt_matches_jax(tmp_path):
    """The whole slice with the post-optimization on: flows, soft masks and
    tracks, 3 exposure epochs and 3 UVT epochs after sampling. The loss
    histories agree within 1e-4 relative, and 99.9% of the frame values
    within 1e-3, all within 2.5e-3 (the worst seen is 2.04e-3). The few
    values beyond 1e-3 belong to tracks seen in every frame, whose flow-L1
    residual |warp(prev) - cur| the UVT drives to ~0: the sign of that
    residual, hence of its L1 subgradient, is then decided by f32
    rounding, which differs between the packages, and Adam (eps=1e-15)
    normalises the flipped contribution to a step of up to lr * 0.28 ~
    1e-2 in RGB. Without the flow term the tail is gone
    (`test_generator_with_postopt_without_flow_loss_matches_jax`)."""
    vid_dir = _video(tmp_path)
    lat_t, lat_j, out_t, out_j, gen, jgen = _run_pair(tmp_path,
                                                      _postopt_config(tmp_path, vid_dir))
    np.testing.assert_allclose(lat_t, lat_j, atol=1e-3)
    err = np.abs(out_t - out_j)
    assert np.quantile(err, 0.999) <= 1e-3 and err.max() <= 2.5e-3, (err.max(), err.mean())
    for stage in ("exposure", "uvt"):
        hist, jhist = gen.last_postopt_losses[stage], jgen.last_postopt_losses[stage]
        assert hist.shape == jhist.shape == (3 * 2,)
        np.testing.assert_allclose(hist, jhist, rtol=1e-4)
    for key in ("exposure", "exposure_epochs", "uvt", "uvt_epochs"):
        assert key in gen.stage_times
    # the CPU takes the gather warp and the dense palette route, as JAX does
    # off the TPU
    assert len(gen.stage_times["uvt_epochs"]) == 3


def test_generator_with_postopt_without_flow_loss_matches_jax(tmp_path):
    """The witness for the tail above: the same pair with lambda_flow = 0,
    so that no L1 of a flow residual is optimized, agrees in every frame
    value within 1e-5 (the worst seen is 2.9e-6: f32 summation order)."""
    cfg = _postopt_config(tmp_path, _video(tmp_path))
    cfg["post_opt"]["lambda_flow"] = 0.0
    _, _, out_t, out_j, gen, jgen = _run_pair(tmp_path, cfg)
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gen.last_postopt_losses["uvt"],
                               jgen.last_postopt_losses["uvt"], rtol=1e-4)


def test_golden_ratios_agree_with_the_jax_matcher(tmp_path, monkeypatch):
    """ROADMAP C1, settled. At the golden merge ratios (0.5 / 0.5) the pair
    parts: latents by 1.346 (of 67.4), frames by 0.025, and by as much when
    the port's matcher is the JAX package's own `online_argmax_scores_xla`
    fed the port's tokens. The parting is in the ToMe matching's ordering:
    chunk slots are padded by repeating a frame, so the src tokens of a
    repeated frame all score 1 +- a few ulp against their own copies, and
    which of them take the r merge places follows those ulps, which follow
    the two frameworks' f32 rounding of the UNet activations.

    Here JAX runs unchanged and records, at each matching, the scores it
    ordered. The port scores its own tokens with `online_argmax_scores_xla`
    and then orders JAX's recorded scores, so it makes JAX's merge choices.
    The pair then agrees within 1e-3; the port's own scores never differ
    from JAX's by more than 2^-20 (8 f32 ulps of 1), and yet its own
    ordering would have chosen otherwise from the first matching on. So
    the parting is f32 near-ties decided differently, not a fault of the
    port's merge logic."""
    import tclight_tpu.ops.tome as jtome
    from einops import rearrange

    from tclight_tpu.ops.match_kernel import online_argmax_scores_xla
    from tclight_torch.ops import tome

    # JAX's own matchings, unchanged, with the scores each one ordered
    # (recomputed beside it in the same program) recorded in call order
    jax_matches, jax_greedy_match = [], jtome._greedy_match

    def recording_greedy_match(metric, a_idx, b_idx, r, align_batch):
        out = jax_greedy_match(metric, a_idx, b_idx, r, align_batch)
        mn = metric * jax.lax.rsqrt(jnp.sum(metric.astype(jnp.float32) ** 2, axis=-1,
                                            keepdims=True) + 1e-20).astype(metric.dtype)
        s2 = rearrange(jnp.einsum("bsc,bdc->bsd", mn[:, a_idx], mn[:, b_idx],
                                  preferred_element_type=jnp.float32), "b s d -> s (b d)")
        jax.debug.callback(lambda *v: jax_matches.append([np.asarray(x) for x in v]),
                           jnp.max(s2, axis=-1), jnp.argmax(s2, axis=-1), out[1][0],
                           ordered=True)
        return out

    # the port's matcher scores its own tokens with JAX's
    # online_argmax_scores_xla, then hands on the scores JAX ordered at
    # the same call, so that the port makes JAX's merge choices
    port_matches = []

    def port_matcher(a, bt):
        m, _ = online_argmax_scores_xla(jnp.asarray(a.float().numpy()),
                                        jnp.asarray(bt.float().numpy()))
        m = np.asarray(m)
        m_j, i_j, src_j = jax_matches[len(port_matches)]
        assert m.shape == m_j.shape
        own = np.argsort(-m, kind="stable")[: len(src_j)]
        port_matches.append((np.abs(m - m_j).max(), set(own) != set(src_j)))
        return torch.from_numpy(m_j.copy()), torch.from_numpy(i_j.astype(np.int32))

    monkeypatch.setattr(jtome, "_greedy_match", recording_greedy_match)
    monkeypatch.setattr(tome, "online_argmax_scores", port_matcher)
    cfg = _config(tmp_path, _video(tmp_path))
    cfg["generation"].update(local_merge_ratio=0.5, global_merge_ratio=0.5)
    lat_t, lat_j, out_t, out_j, _, _ = _run_pair(tmp_path, cfg)
    assert len(port_matches) == len(jax_matches) > 0
    for m_j, _, src_j in jax_matches:  # the recorded scores are those JAX ordered
        np.testing.assert_array_equal(np.argsort(-m_j, kind="stable")[: len(src_j)], src_j)
    # with JAX's choices the pair agrees
    np.testing.assert_allclose(lat_t, lat_j, atol=1e-3)
    np.testing.assert_allclose(out_t, out_j, atol=1e-3)
    # left to itself the port would have chosen otherwise at some matchings,
    # with every score within 2^-20 (8 f32 ulps of 1) of JAX's
    gaps = np.array([g for g, _ in port_matches])
    parts = [k for k, (_, differs) in enumerate(port_matches) if differs]
    print(f"C1: {len(port_matches)} matchings, own choice differs at {parts}, "
          f"max |port score - JAX score| {gaps.max():.3e}, at the first parting "
          f"{gaps[parts[0]] if parts else float('nan'):.3e}")
    assert parts and gaps.max() <= 2.0 ** -20


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


def test_cli_runs_tiny_with_postopt_on_cpu(tmp_path, monkeypatch):
    """The CLI with the post-optimization on (Farneback flows, 2 + 2 epochs):
    an mp4 of every frame, finite loss histories beside it as arrays and
    as the two PNG plots JAX draws (ROADMAP C4), and the RAFT default
    refused while its flow cache is empty."""
    import cv2

    from tclight_torch.run import main

    monkeypatch.chdir(Path(__file__).resolve().parent.parent)
    monkeypatch.setenv("TCLIGHT_TINY", "1")
    vid_dir = _video(tmp_path)
    args = [a for a in _cli_args(tmp_path, vid_dir) if a != "post_opt.apply_opt=false"]
    with pytest.raises(NotImplementedError, match="A9"):
        main(args, device="cpu")  # the default config's flow_model is raft
    args += ["data.flow_model=farneback", "post_opt.epochs_exposure=2", "post_opt.epochs=2",
             "post_opt.batch_size=4", "post_opt.ms_ssim_levels=2"]
    assert main(args, device="cpu") == 0
    mp4s = sorted((tmp_path / "wd").rglob("output.mp4"))
    assert len(mp4s) == 1
    cap = cv2.VideoCapture(str(mp4s[0]))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == N_FRAMES
    for name in ("loss_exposure", "loss_unique_tensor"):
        hist = np.load(mp4s[0].parent / f"{name}.npy")
        assert hist.shape == (2 * 2,) and np.isfinite(hist).all()
        png = mp4s[0].parent / f"{name}.png"
        assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_cli_runs_cached_raft_flows_with_postopt_on_cpu(tmp_path, monkeypatch):
    """ROADMAP C3: the default config's `flow_model: raft` with the flows
    in the cache next to the video (`vid_{future,past}_flow_raft/*.npy`,
    as the JAX package reads them) runs the post-optimization on them; the
    CLI no longer refuses a flow model before it reads the cache. The
    cached flows are the video's own roll (2 px a frame) in both
    directions, as the JAX data layer's convention has them."""
    import yaml

    from tclight_torch.run import main

    monkeypatch.chdir(Path(__file__).resolve().parent.parent)
    monkeypatch.setenv("TCLIGHT_TINY", "1")
    vid_dir = _video(tmp_path)
    for direction, dx in (("future", 2.0), ("past", -2.0)):
        cache = tmp_path / f"vid_{direction}_flow_raft"
        cache.mkdir()
        for i in range(N_FRAMES):
            flow = np.zeros((SIZE, SIZE, 2), np.float32)
            edge = (direction == "future" and i == N_FRAMES - 1) or (direction == "past"
                                                                      and i == 0)
            flow[..., 0] = 0.0 if edge else dx
            np.save(cache / f"{i:05d}.npy", flow)
    args = [a for a in _cli_args(tmp_path, vid_dir) if a != "post_opt.apply_opt=false"]
    args += ["post_opt.epochs_exposure=2", "post_opt.epochs=2", "post_opt.batch_size=4",
             "post_opt.ms_ssim_levels=2"]
    assert main(args, device="cpu") == 0
    out_dir = next((tmp_path / "wd").rglob("output.mp4")).parent
    cfg = yaml.safe_load((out_dir / "config.yaml").read_text())
    assert cfg["data"]["flow_model"] == "raft" and cfg["post_opt"]["apply_opt"]
    for name in ("loss_exposure", "loss_unique_tensor"):
        hist = np.load(out_dir / f"{name}.npy")
        assert hist.shape == (2 * 2,) and np.isfinite(hist).all()
    # the cache was read, not recomputed: no other flow files appeared
    assert sorted(p.name for p in tmp_path.iterdir() if "flow" in p.name) == [
        "vid_future_flow_raft", "vid_past_flow_raft"]


def test_cli_runs_navsim_settings_with_int8_on_cpu(tmp_path, monkeypatch):
    """The CLI on configs/examples/tclight_navsim.yaml (the yt pass at
    alpha_t 0.4, 30 frames), with attn_qk_int8, on the tiny stack at 32x32:
    an mp4 of all 30 frames, and the int8 attention reached (counted)."""
    import cv2

    from tclight_torch.run import main

    calls = _count_int8_calls(monkeypatch)
    monkeypatch.chdir(Path(__file__).resolve().parent.parent)
    monkeypatch.setenv("TCLIGHT_TINY", "1")
    rng = np.random.default_rng(0)
    base = rng.uniform(0.2, 0.8, (SIZE, SIZE, 3)).astype(np.float32)
    save_frames(np.stack([np.roll(base, t, axis=1) for t in range(30)]), tmp_path / "vid")
    args = ["--config", "configs/examples/tclight_navsim.yaml", "-i", str(tmp_path / "vid"),
            "post_opt.apply_opt=false", "generation.attn_qk_int8=true",
            f"generation.n_timesteps={STEPS}", f"data.height={SIZE}", f"data.width={SIZE}",
            f"work_dir={tmp_path / 'wd'}", "generation.save_frame=false"]
    assert main(args, device="cpu") == 0
    mp4s = sorted((tmp_path / "wd").rglob("output.mp4"))
    assert len(mp4s) == 1 and "alpha_t_0.4" in str(mp4s[0])
    cap = cv2.VideoCapture(str(mp4s[0]))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 30
    assert calls


def test_unported_options_raise(tmp_path):
    vid_dir = _video(tmp_path)
    models = build_tiny_iclight(device="cpu")
    for key, value in (("control", "pnp"), ("background_cond", True)):
        cfg = _config(tmp_path, vid_dir)
        cfg["generation"][key] = value
        with pytest.raises(NotImplementedError):
            Generator(models, ConfigDict(cfg), device="cpu")
    # the yt pass and the int8 attention are ported: they no longer refuse;
    # attn_pv_int8 counts only together with attn_qk_int8
    for flags, backend in (({"alpha_t": 0.4}, None), ({"attn_qk_int8": True}, "int8"),
                           ({"attn_qk_int8": True, "attn_pv_int8": True}, "int8pv"),
                           ({"attn_pv_int8": True}, None)):
        cfg = _config(tmp_path, vid_dir)
        cfg["generation"].update(flags)
        gen = Generator(models, ConfigDict(cfg), device="cpu")
        assert gen.attn_backend == gen.models.attn_backend == backend
    # the post-optimization is ported: apply_opt no longer refuses
    cfg = _config(tmp_path, vid_dir)
    cfg["post_opt"]["apply_opt"] = True
    assert Generator(models, ConfigDict(cfg), device="cpu").apply_opt
    # a missing prompt runs on JAX's fallback (test_missing_prompt_...);
    # with an upsampler checkpoint on disk it needs the unported upsampler
    ckpt = tmp_path / "upsampler.ckpt"
    ckpt.write_bytes(b"")
    cfg = _config(tmp_path, vid_dir)
    cfg["generation"].update(prompt={"default": None}, prompt_upsampler_ckpt=str(ckpt))
    gen = Generator(models, ConfigDict(cfg), data_parser=VideoDataParser(cfg["data"]),
                    device="cpu")
    with pytest.raises(NotImplementedError, match="A13"):
        gen(None, str(tmp_path / "out"), list(range(N_FRAMES)))


def test_missing_prompt_takes_the_default(tmp_path):
    """ROADMAP C2: with `prompt: null` and no upsampler checkpoint (the
    default config's), the run takes JAX's fallback prompt: the same
    frames, bit for bit, as that prompt given explicitly, and the saved
    config.yaml records it."""
    import yaml

    from tclight_torch.pipeline.generator import DEFAULT_PROMPT
    from tclight_tpu.pipeline.generator import Generator as JGen

    # JAX's own fallback, called on a config without a checkpoint
    jax_cfg = SimpleNamespace(config={"generation": {"prompt_upsampler_ckpt": None}})
    assert JGen._handle_missing_prompt(jax_cfg, None, None) == DEFAULT_PROMPT
    vid_dir = _video(tmp_path)
    models = build_tiny_iclight(device="cpu")
    outs = []
    for name, prompt in (("none", None), ("explicit", DEFAULT_PROMPT)):
        cfg = _config(tmp_path, vid_dir)
        cfg["generation"].update(prompt={"default": prompt}, prompt_upsampler_ckpt=None)
        gen = Generator(models, ConfigDict(cfg), data_parser=VideoDataParser(cfg["data"]),
                        device="cpu")
        outs.append(gen(None, str(tmp_path / name), list(range(N_FRAMES)))["default"])
        assert gen.prompts["default"] == DEFAULT_PROMPT
        saved = yaml.safe_load(next((tmp_path / name).rglob("config.yaml")).read_text())
        assert saved["generation"]["prompt"] == {"default": DEFAULT_PROMPT}
    np.testing.assert_array_equal(outs[0], outs[1])
