"""Checkpoint loading in the port (ROADMAP A16): its safetensors reader
against the `safetensors` package, its copies of the JAX package's
converters (`tclight_torch/models/convert.py`) against the originals, the
converted UNet, VAE and CLIP text models against the JAX package's (and
CLIP against transformers'), `load_iclight` in `fc` and `fbc` against the
JAX package's on a model_dir written here, the CLI on that model_dir, and
the fbc background latents against the JAX Generator's branch.

No checkpoint file is read from outside the test: every state dict is
built here with diffusers / transformers keys (the UNet's by
tests/test_convert.py's `flax_to_torch_unet`, the VAE's by inverting
`convert_vae`'s path map) and written under tmp_path. The JAX package's
`load_iclight` builds SD1.5 configs; here its configs are the tiny ones
(monkeypatched), so both packages read the same tiny files. f32
throughout; outputs agree within 1e-4 of their largest magnitude (f32
summation order through a few dozen layers), as tests/test_torch_models.py
holds the models."""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file
from test_convert import flax_to_torch_unet

import tclight_tpu.pipeline.iclight as jiclight
from tclight_tpu.models import convert as jconvert
from tclight_tpu.models.clip_text import CLIPTextConfig as JCLIPCfg
from tclight_tpu.models.clip_text import CLIPTextModel as JCLIP
from tclight_tpu.models.unet import UNet2DCondition as JUNet
from tclight_tpu.models.unet import UNetConfig as JUNetCfg
from tclight_tpu.models.vae import AutoencoderKL as JVAE
from tclight_tpu.models.vae import VAEConfig as JVAECfg
from tclight_torch.models import bridge
from tclight_torch.models import convert
from tclight_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from tclight_torch.models.unet import UNet2DCondition, UNetConfig
from tclight_torch.models.vae import AutoencoderKL, VAEConfig
from tclight_torch.pipeline.iclight import DummyTokenizer, load_iclight

torch.set_num_threads(2)

RTOL = 1e-4


def _close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=RTOL,
                               atol=RTOL * float(np.abs(ref).max()))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _jinit(module, *args, seed=0):
    """Random flax params, every leaf moved by noise so that zero biases
    and unit scales carry information too."""
    params = jax.jit(module.init)(jax.random.PRNGKey(seed), *args)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                        .astype(np.float32), params)


# ------------------------------------------------------------ safetensors


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int64])
def test_safetensors_reader_matches_the_safetensors_package(tmp_path, dtype):
    """The port's reader against safetensors.torch.load_file (and
    safetensors.numpy.load_file where numpy has the type): values, shapes
    and types; bf16 comes back as f32 holding the same values. Also a
    scalar, an empty tensor and file metadata."""
    from safetensors.numpy import load_file as load_numpy
    from safetensors.torch import load_file as load_torch

    gen = torch.Generator().manual_seed(0)
    if dtype.is_floating_point:
        make = lambda *s: torch.randn(s, generator=gen).to(dtype)
    else:
        make = lambda *s: torch.randint(-2**40, 2**40, s, generator=gen, dtype=dtype)
    tensors = {"a.weight": make(3, 5, 2), "b": make(7), "scalar": make(), "empty": make(0, 4)}
    path = tmp_path / "t.safetensors"
    save_file(tensors, str(path), metadata={"format": "pt"})
    got = convert.load_torch_state_dict(path)
    ref = load_torch(str(path))
    assert got.keys() == ref.keys() == tensors.keys()
    for k, t in ref.items():
        want = t.float().numpy() if dtype == torch.bfloat16 else t.numpy()
        assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    if dtype != torch.bfloat16:
        for k, a in load_numpy(str(path)).items():
            np.testing.assert_array_equal(got[k], a, err_msg=k)


def test_torch_files_load_as_numpy(tmp_path):
    """`.bin` / `.pt` files through torch.load(weights_only=True), a
    `state_dict` wrapper unwrapped, bf16 as f32."""
    sd = {"w": torch.randn(4, 3), "h": torch.randn(2).bfloat16()}
    torch.save({"state_dict": sd}, tmp_path / "m.bin")
    got = convert.load_torch_state_dict(tmp_path / "m.bin")
    np.testing.assert_array_equal(got["w"], sd["w"].numpy())
    np.testing.assert_array_equal(got["h"], sd["h"].float().numpy())


def test_expand_conv_in_and_merge_offsets_match_jax():
    rng = np.random.default_rng(0)
    sd = {"conv_in.weight": rng.standard_normal((8, 4, 3, 3)).astype(np.float32),
          "other.bias": rng.standard_normal(5).astype(np.float32)}
    offsets = {"conv_in.weight": rng.standard_normal((8, 12, 3, 3)).astype(np.float32),
               "other.bias": rng.standard_normal(5).astype(np.float32),
               "only_in_offsets": rng.standard_normal(2).astype(np.float32)}
    for n in (4, 8, 12):
        got, want = convert.expand_conv_in(sd, n), jconvert.expand_conv_in(sd, n)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    wide = convert.expand_conv_in(sd, 12)
    got, want = convert.merge_offsets(wide, offsets), jconvert.merge_offsets(wide, offsets)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="shape mismatch"):
        convert.merge_offsets(sd, {"conv_in.weight": np.zeros((8, 12, 3, 3), np.float32)})


# ------------------------------------------------------------ the models


def _unet_sd(in_channels=8, seed=0):
    """A tiny UNet's random flax params and the same weights as a diffusers
    UNet2DConditionModel state dict."""
    cfg = JUNetCfg.tiny(in_channels=in_channels)
    params = _jinit(JUNet(cfg), jnp.zeros((1, 16, 16, in_channels)), jnp.asarray(1.0),
                    jnp.zeros((1, 77, cfg.context_dim)), seed=seed)
    return params, flax_to_torch_unet(params, n_levels=len(cfg.block_out_channels))


def test_unet_checkpoint_loads_as_in_jax():
    """A diffusers-key UNet state dict, converted by both packages: the
    same flax tree, and the port's UNet loaded from it gives the JAX UNet's
    output on the same inputs."""
    params, sd = _unet_sd()
    tree = convert.convert_unet(sd, n_levels=2)
    _trees_equal(tree, jconvert.convert_unet(sd, n_levels=2))
    _trees_equal(tree, params)
    model = UNet2DCondition(UNetConfig.tiny(8)).eval()
    model.load_state_dict(bridge.unet_state_dict(tree))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    ref, _ = jax.jit(JUNet(JUNetCfg.tiny(8)).apply)(tree, jnp.asarray(x), jnp.asarray(500.0),
                                                     jnp.asarray(ctx))
    with torch.no_grad():
        out, _ = model(torch.from_numpy(x), 500.0, torch.from_numpy(ctx))
    _close(out.numpy(), ref)


def _unconv(w):
    return np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def flax_to_diffusers_vae(params, n_levels):
    """The inverse of `convert_vae`'s path map: our flax AutoencoderKL
    params -> a diffusers AutoencoderKL state dict."""
    attn = {"to_q": "to_q", "to_k": "to_k", "to_v": "to_v", "to_out_0": "to_out.0",
            "group_norm": "group_norm"}
    sd = {}
    for path, val in _flat(params["params"]).items():
        parts = path.split("/")
        side, name, leaf = parts[0], parts[1], parts[-1]
        inner = parts[2:-1]
        if name in ("quant_conv", "post_quant_conv"):
            prefix = name
        elif name in ("conv_in", "conv_out", "conv_norm_out"):
            prefix = f"{side}.{name}"
        elif m := re.fullmatch(r"down_(\d+)_res_(\d+)", name):
            prefix = f"encoder.down_blocks.{m[1]}.resnets.{m[2]}"
        elif m := re.fullmatch(r"down_(\d+)_ds", name):
            prefix = f"encoder.down_blocks.{m[1]}.downsamplers.0.conv"
        elif m := re.fullmatch(r"up_(\d+)_res_(\d+)", name):
            prefix = f"decoder.up_blocks.{n_levels - 1 - int(m[1])}.resnets.{m[2]}"
        elif m := re.fullmatch(r"up_(\d+)_us", name):
            prefix = f"decoder.up_blocks.{n_levels - 1 - int(m[1])}.upsamplers.0.conv"
        elif m := re.fullmatch(r"mid_res_(\d+)", name):
            prefix = f"{side}.mid_block.resnets.{m[1]}"
        elif name == "mid_attn":
            prefix = f"{side}.mid_block.attentions.0"
            inner = [attn[inner[0]]]
        else:
            raise KeyError(path)
        key = ".".join([prefix] + inner + ["bias" if leaf == "bias" else "weight"])
        if leaf == "kernel":
            val = _unconv(val) if val.ndim == 4 else np.ascontiguousarray(val.T)
        sd[key] = np.asarray(val)
    return sd


def _vae_sd(seed=0):
    params = _jinit(JVAE(JVAECfg.tiny()), jnp.zeros((1, 32, 32, 3)), seed=seed)
    return params, flax_to_diffusers_vae(params, n_levels=2)


def test_vae_checkpoint_loads_as_in_jax():
    """A diffusers-key VAE state dict (convert_vae's path map inverted):
    both packages convert it to the same tree, the tree the weights came
    from, and the port's decode and encode give JAX's."""
    params, sd = _vae_sd()
    assert any(".upsamplers." in k for k in sd) and any(".downsamplers." in k for k in sd)
    tree = convert.convert_vae(sd, n_levels=2)
    _trees_equal(tree, jconvert.convert_vae(sd, n_levels=2))
    _trees_equal(tree, params)
    model = AutoencoderKL(VAEConfig.tiny()).eval()
    model.load_state_dict(bridge.vae_state_dict(tree))
    vae_j = JVAE(JVAECfg.tiny())
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 32, 24, 3)).astype(np.float32)
    mean_j, _ = jax.jit(functools.partial(vae_j.apply, method=vae_j.encode))(
        tree, jnp.asarray(x))
    img_j = jax.jit(functools.partial(vae_j.apply, method=vae_j.decode))(tree, mean_j)
    with torch.no_grad():
        mean_t, _ = model.encode(torch.from_numpy(x))
        img_t = model.decode(torch.from_numpy(np.array(mean_j)))
    _close(mean_t.numpy(), mean_j)
    _close(img_t.numpy(), img_j)


def _hf_clip(seed=0):
    """A random transformers CLIPTextModel of the tiny config's shape."""
    from transformers import CLIPTextConfig as HFConfig
    from transformers import CLIPTextModel as HFModel

    cfg = CLIPTextConfig.tiny()
    torch.manual_seed(seed)
    return HFModel(HFConfig(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                            intermediate_size=cfg.intermediate_size,
                            num_hidden_layers=cfg.num_layers,
                            num_attention_heads=cfg.num_heads,
                            max_position_embeddings=cfg.max_positions,
                            hidden_act="quick_gelu")).eval()


def test_clip_text_checkpoint_matches_transformers():
    """A transformers CLIPTextModel's state dict: both packages convert it
    to the same tree, and the port's CLIP text model gives transformers'
    last hidden state (as tests/test_convert.py holds the JAX model)."""
    hf = _hf_clip()
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    tree = convert.convert_clip_text(sd)
    _trees_equal(tree, jconvert.convert_clip_text(sd))
    model = CLIPTextModel(CLIPTextConfig.tiny()).eval()
    model.load_state_dict(bridge.clip_text_state_dict(tree))
    ids = np.random.default_rng(3).integers(0, 1000, (2, 77))
    with torch.no_grad():
        ref = hf(torch.from_numpy(ids)).last_hidden_state.numpy()
        out = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-4)


# ------------------------------------------------------- load_iclight, CLI


def _save(sd, path):
    save_file({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, str(path))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """An IC-Light model_dir of tiny diffusers / transformers checkpoints:
    a 4-channel base UNet, the VAE, the CLIP text model, and fc and fbc
    offset files (conv_in at 8 and 12 channels, and deltas for some other
    keys), no tokenizer."""
    d = tmp_path_factory.mktemp("iclight")
    _, unet_sd = _unet_sd(in_channels=4, seed=10)
    _save(unet_sd, d / "unet.safetensors")
    _save(_vae_sd(seed=11)[1], d / "vae.safetensors")
    _save({k: v.numpy() for k, v in _hf_clip(seed=12).state_dict().items()},
          d / "text_encoder.safetensors")
    rng = np.random.default_rng(13)
    for mode, cin in (("fc", 8), ("fbc", 12)):
        w = unet_sd["conv_in.weight"]
        offsets = {"conv_in.weight": 0.1 * rng.standard_normal(
            (w.shape[0], cin) + w.shape[2:]).astype(np.float32)}
        for k in ("conv_out.bias", "mid_block.resnets.0.conv1.weight"):
            offsets[k] = 0.1 * rng.standard_normal(unet_sd[k].shape).astype(np.float32)
        _save(offsets, d / f"iclight_sd15_{mode}.safetensors")
    return d


def _jax_load_tiny(model_dir, mode, monkeypatch):
    """The JAX package's load_iclight, with its SD1.5 configs made the tiny
    ones (and its converters told the tiny level counts)."""
    with monkeypatch.context() as m:
        m.setattr(jiclight.UNetConfig, "sd15",
                  staticmethod(lambda in_channels=4, dtype=None: JUNetCfg.tiny(in_channels)))
        m.setattr(jiclight.VAEConfig, "sd15", staticmethod(lambda dtype=None: JVAECfg.tiny()))
        m.setattr(jiclight.CLIPTextConfig, "sd15", staticmethod(lambda: JCLIPCfg.tiny()))
        m.setattr(jiclight, "convert_unet", functools.partial(jconvert.convert_unet, n_levels=2))
        m.setattr(jiclight, "convert_vae", functools.partial(jconvert.convert_vae, n_levels=2))
        return jiclight.load_iclight(model_dir, mode=mode, num_inference_steps=2,
                                     dtype=jnp.float32)


@pytest.mark.parametrize("mode", ["fc", "fbc"])
def test_load_iclight_matches_jax(model_dir, mode, monkeypatch):
    """load_iclight in fc (8 channels) and fbc (12): the offsets merged onto
    the widened conv_in, and the UNet, the VAE decode and the CLIP text
    model giving the JAX package's loaded models' outputs on the same
    inputs; f32 on the CPU, the DummyTokenizer without a tokenizer/."""
    cin = {"fc": 8, "fbc": 12}[mode]
    models = load_iclight(model_dir, mode=mode, num_inference_steps=2, device="cpu")
    jm = _jax_load_tiny(model_dir, mode, monkeypatch)
    assert models.unet.config.in_channels == cin
    assert isinstance(models.tokenizer, DummyTokenizer)
    assert models.tokenizer.vocab_size == jm.tokenizer.vocab_size
    for m in (models.unet, models.vae, models.text_encoder):
        assert {p.dtype for p in m.parameters()} == {torch.float32}
    base = convert.load_torch_state_dict(model_dir / "unet.safetensors")["conv_in.weight"]
    off = convert.load_torch_state_dict(
        model_dir / f"iclight_sd15_{mode}.safetensors")["conv_in.weight"]
    w = models.unet.conv_in.weight.detach().numpy()
    np.testing.assert_allclose(w[:, :4], base + off[:, :4], rtol=1e-6)
    np.testing.assert_allclose(w[:, 4:], off[:, 4:], rtol=1e-6)

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 16, cin)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    ref, _ = jax.jit(jm.unet.apply)(jm.unet_params, jnp.asarray(x), jnp.asarray(300.0),
                                    jnp.asarray(ctx))
    z = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    img_j = jax.jit(functools.partial(jm.vae.apply, method=jm.vae.decode))(
        jm.vae_params, jnp.asarray(z))
    ids = rng.integers(0, 1000, (2, 77))
    txt_j = jax.jit(jm.text_encoder.apply)(jm.text_params, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        out, _ = models.unet(torch.from_numpy(x), 300.0, torch.from_numpy(ctx))
        img_t = models.vae.decode(torch.from_numpy(z))
        txt_t = models.text_encoder(torch.from_numpy(ids))
    _close(out.numpy(), ref)
    _close(img_t.numpy(), img_j)
    _close(txt_t.numpy(), txt_j)


def test_load_iclight_refuses_unknown_modes_and_widths(model_dir, tmp_path):
    with pytest.raises(ValueError, match="mode"):
        load_iclight(model_dir, mode="fg", device="cpu")
    _save({"conv_in.weight": np.zeros((64, 4, 3, 3), np.float32)}, tmp_path / "unet.safetensors")
    with pytest.raises(ValueError, match="first width 64"):
        load_iclight(tmp_path, device="cpu")


def _video(tmp_path, n=6, size=32, name="vid"):
    from tclight_torch.utils.video_io import save_frames

    rng = np.random.default_rng(0)
    base = rng.uniform(0.2, 0.8, (size, size, 3)).astype(np.float32)
    save_frames(np.stack([np.roll(base, 2 * t, axis=1) for t in range(n)]), tmp_path / name)
    return tmp_path / name


def test_cli_runs_from_model_dir_on_cpu(tmp_path, model_dir, monkeypatch):
    """`tclight_torch.run.main` with `model_dir` set: the fc stack from the
    directory's files (tiny, as their widths say) relights the video into
    an mp4 of every frame; with `generation.background_cond`
    it loads the fbc stack, and the Generator then refuses
    background_cond, which is not ported yet (ROADMAP A11)."""
    import cv2

    import tclight_torch.pipeline.iclight as iclight
    from tclight_torch.run import main

    monkeypatch.chdir(Path(__file__).resolve().parent.parent)
    loaded = []
    monkeypatch.setattr(iclight, "load_iclight",
                        lambda *a, **k: loaded.append(k) or load_iclight(*a, **k))
    vid = _video(tmp_path)
    args = ["--config", "configs/tclight_default.yaml", "-i", str(vid), "-p", "warm light",
            "post_opt.apply_opt=false", "generation.n_timesteps=2", "data.height=32",
            "data.width=32", f"work_dir={tmp_path / 'wd'}", "generation.save_frame=false",
            f"model_dir={model_dir}"]
    assert main(args, device="cpu") == 0
    assert loaded[-1]["mode"] == "fc"
    mp4s = sorted((tmp_path / "wd").rglob("output.mp4"))
    assert len(mp4s) == 1
    cap = cv2.VideoCapture(str(mp4s[0]))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 6
    with pytest.raises(NotImplementedError, match="background_cond"):
        main(args + ["generation.background_cond=true"], device="cpu")
    assert loaded[-1]["mode"] == "fbc"


@pytest.mark.parametrize("background", [True, False])
def test_fbc_background_latents_match_jax(tmp_path, background, monkeypatch):
    """On a 12-channel (fbc) tiny stack the concat conditions are the
    frames' latents and then the background's: from
    `background_image_path` (a 2-frame video here, tiled to the 6 frames)
    or zeros without one. The port's `encode_conditions` against what the
    JAX Generator hands its sampler, on the same weights."""
    from tclight_tpu.config import ConfigDict as JConfigDict
    from tclight_tpu.data.dataparsers import VideoDataParser as JParser
    from tclight_tpu.pipeline.generator import Generator as JGenerator
    from tclight_torch.config import ConfigDict
    from tclight_torch.data.dataparsers import VideoDataParser
    from tclight_torch.pipeline.generator import Generator
    from tclight_torch.pipeline.iclight import build_tiny_iclight

    jm = jiclight.build_tiny_iclight(seed=0, num_inference_steps=2, in_channels=12)
    models = build_tiny_iclight(num_inference_steps=2, in_channels=12, device="cpu",
                                state_dicts={
                                    "unet": bridge.unet_state_dict(jm.unet_params),
                                    "vae": bridge.vae_state_dict(jm.vae_params),
                                    "text_encoder": bridge.clip_text_state_dict(jm.text_params)})
    vid = _video(tmp_path)
    rng = np.random.default_rng(5)
    from tclight_torch.utils.video_io import save_frames

    save_frames(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32), tmp_path / "bg")
    gen_cfg = {"n_timesteps": 2, "prompt": {"p": "warm light"}, "save_frame": False}
    if background:
        gen_cfg["background_image_path"] = str(tmp_path / "bg")
    cfg = {"work_dir": str(tmp_path / "wd"), "seed": 7, "post_opt": {"apply_opt": False},
           "data": {"scene_type": "video", "rgb_path": str(vid), "height": 32, "width": 32},
           "generation": gen_cfg}

    class Handed(Exception):
        pass

    def record(*args, **kwargs):
        handed.append(np.asarray(args[3]))
        raise Handed

    handed = []
    jcfg = JConfigDict(cfg)
    jgen = JGenerator(jm, jcfg, data_parser=JParser(jcfg.data))
    monkeypatch.setattr(jgen, "ddim_sample", record)
    with pytest.raises(Handed):
        jgen(None, str(tmp_path / "out_j"), list(range(6)))
    tcfg = ConfigDict(cfg)
    parser = VideoDataParser(tcfg.data)
    gen = Generator(models, tcfg, data_parser=parser, device="cpu")
    conds = gen.encode_conditions(parser.load_video(frame_ids=list(range(6)))).numpy()
    assert conds.shape == handed[0].shape == (6, 16, 16, 8)
    if background:
        assert np.abs(conds[..., 4:]).max() > 0
        np.testing.assert_array_equal(conds[0, ..., 4:], conds[2, ..., 4:])  # tiled
    else:
        assert (conds[..., 4:] == 0).all()
    _close(conds, handed[0])
