"""The port's annotators (models/dpt.py, hed.py, lineart.py, openpose.py)
and the ControlNet types they serve, against the JAX package's, on the
same weights (reference checkpoints written from random port weights and
read by both packages' converters) and inputs, on the CPU in f32.

- DPT tiny and tiny-hybrid at 64 and 96 px (the position-embedding
  resize): depth within 1e-4 (measured ~8e-6 of depths up to ~4);
  `prepare_depth_maps` within 1e-4.
- HED edges within 1e-5 (sigmoids of the same f32 logit maps), and equal
  after the safe step.
- The lineart U-Net at two sizes within 1e-5, `lineart_anime_map` within
  1e-5.
- The OpenPose body net's maps within 1e-5 (and the upsampled maps of
  `body_maps` within 1e-4); the peak / PAF / subset assembly equal to
  JAX's on test_openpose.py's two-person fields, and the drawing equal.
- Each `*_model_fn` from a checkpoint written under tmp_path against
  JAX's `model_fn` of the same file.
- A ControlNet run through `python -m tclight_torch.run` for each
  model-backed type (tiny SD stack, annotators at their published widths
  on 32 x 32 frames), its control images equal to JAX's within the
  tolerances above; softedge's frames against JAX's Generator within 1e-3.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclight_torch.data import controlnet_utils
from tclight_torch.models import bridge, controlnet, dpt, hed, lineart, openpose
from tclight_torch.models.convert import load_torch_state_dict
from tclight_torch.pipeline.iclight import build_tiny_sd, init_like_flax, write_model_dir
from tclight_tpu.data import controlnet_utils as jctrl
from tclight_tpu.models import dpt as jdpt
from tclight_tpu.models import hed as jhed
from tclight_tpu.models import lineart as jlineart
from tclight_tpu.models import openpose as jopenpose
from test_torch_editing import _cli_args, _frames, _perturbed, _video

torch.set_num_threads(2)

DEPTH_TOL = 1e-4
MAP_TOL = 1e-5


def _normal_(module: torch.nn.Module, std: float, seed: int) -> torch.nn.Module:
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.normal_(0.0, std, generator=gen)
    return module.eval().requires_grad_(False)


@pytest.mark.parametrize("name", ["tiny", "tiny_hybrid"])
def test_dpt_matches_jax(name):
    """A reference checkpoint of random weights through both converters:
    the port's tree and state dict round trip, and depth at 64 px (the
    config's) and 96 px (resized position embeddings) against JAX's."""
    cfg, jcfg = getattr(dpt.DPTConfig, name)(), getattr(jdpt.DPTConfig, name)()
    model = dpt.random_dpt(cfg, seed=1, device="cpu")
    sd = {k: v.numpy() for k, v in dpt.reference_state_dict(model).items()}
    assert dpt.dpt_config_for_state_dict(sd) == cfg
    params = jdpt.convert_dpt(sd, jcfg)
    loaded = dpt.DPTForDepthEstimation(cfg)
    loaded.load_state_dict(bridge.dpt_state_dict(dpt.convert_dpt(sd, cfg), cfg))
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    rng = np.random.default_rng(2)
    for size in (64, 96):
        x = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
        with torch.no_grad():
            out = model(torch.from_numpy(x)).numpy()
        ref = np.asarray(jdpt.DPTForDepthEstimation(jcfg).apply(params, jnp.asarray(x)))
        assert out.shape == ref.shape == (2, size, size)
        assert np.ptp(ref) > 0.1  # the maps vary
        np.testing.assert_allclose(out, ref, atol=DEPTH_TOL, rtol=0)


def test_prepare_depth_maps_matches_jax():
    cfg, jcfg = dpt.DPTConfig.tiny_hybrid(), jdpt.DPTConfig.tiny_hybrid()
    model = dpt.random_dpt(cfg, seed=3, device="cpu")
    sd = {k: v.numpy() for k, v in dpt.reference_state_dict(model).items()}
    frames = np.random.default_rng(4).uniform(size=(3, 40, 56, 3)).astype(np.float32)
    out = dpt.prepare_depth_maps(model, frames, (5, 7), input_size=64)
    ref = np.asarray(jdpt.prepare_depth_maps(jdpt.DPTForDepthEstimation(jcfg),
                                             jdpt.convert_dpt(sd, jcfg), frames, (5, 7),
                                             input_size=64))
    assert out.shape == ref.shape == (3, 5, 7, 1) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=DEPTH_TOL, rtol=0)
    np.testing.assert_allclose(out.max(axis=(1, 2, 3)), 1.0, atol=1e-6)
    np.testing.assert_allclose(out.min(axis=(1, 2, 3)), -1.0, atol=1e-6)


def _hed(width_mult=0.125, seed=5):
    """Random HED weights at flax's scales (N(0, 1 / fan_in)), so its logits
    stay in the sigmoid's slope, and a mid-grey `norm`."""
    model = hed.ControlNetHED(width_mult)
    init_like_flax(model, torch.Generator().manual_seed(seed))
    model.eval().requires_grad_(False)
    with torch.no_grad():
        model.norm.copy_(torch.tensor([120.0, 110.0, 100.0]).reshape(1, 1, 1, 3))
    return model


def test_hed_edges_match_jax():
    model = _hed()
    sd = {k: v.numpy() for k, v in hed.reference_state_dict(model).items()}
    assert sd["norm"].shape == (1, 3, 1, 1)
    params = jhed.convert_hed(sd)
    frames = np.random.default_rng(6).uniform(size=(3, 40, 56, 3)).astype(np.float32)
    for safe in (False, True):
        out = hed.hed_edges(model, frames, batch=2, safe=safe)
        ref = jhed.hed_edges(jhed.ControlNetHED(width_mult=0.125), params, frames, batch=2,
                             safe=safe)
        assert out.shape == (3, 40, 56)
        if safe:
            np.testing.assert_array_equal(out, ref)
        else:
            np.testing.assert_allclose(out, ref, atol=MAP_TOL, rtol=0)
            assert np.ptp(out) > 0.05


@pytest.mark.parametrize("ngf,num_downs,size", [(8, 8, 256), (8, 6, 64)])
def test_lineart_matches_jax(ngf, num_downs, size):
    model = _normal_(lineart.LineartAnimeUNet(ngf, num_downs), 0.08, 7)
    sd = {k: v.numpy() for k, v in lineart.reference_state_dict(model).items()}
    params = jlineart.convert_lineart_anime(sd, num_downs)
    x = np.random.default_rng(8).normal(size=(2, size, size, 3)).astype(np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    ref = np.asarray(jlineart.LineartAnimeUNet(ngf=ngf, num_downs=num_downs).apply(
        params, jnp.asarray(x)))
    np.testing.assert_allclose(out, ref, atol=MAP_TOL, rtol=0)
    frames = np.random.default_rng(9).uniform(size=(2, 40, 56, 3)).astype(np.float32)
    m = lineart.lineart_anime_map(model, frames)
    jm = jlineart.lineart_anime_map(jlineart.LineartAnimeUNet(ngf=ngf, num_downs=num_downs),
                                    params, frames)
    assert m.shape == (2, 40, 56)
    np.testing.assert_allclose(m, jm, atol=MAP_TOL, rtol=0)


def test_openpose_maps_and_assembly_match_jax():
    """The body net (width 1/8) and its upsampled maps; then the peak, PAF
    and subset stages on test_openpose.py's synthetic two-person fields,
    and the drawing."""
    import cv2

    from test_openpose import _synthetic_pose_fields

    model = _normal_(openpose.BodyPoseNet(0.125), 0.05, 10)
    sd = {k: v.numpy() for k, v in openpose.reference_state_dict(model).items()}
    assert {k.split(".")[0] for k in sd} == {"model0", "model1_1", "model1_2"} | {
        f"model{n}_{b}" for n in range(2, 7) for b in (1, 2)}
    params = jopenpose.convert_bodypose(sd)
    jnet = jopenpose.BodyPoseNet(width_mult=0.125)
    x = (np.random.default_rng(11).normal(size=(1, 64, 48, 3)) * 0.5).astype(np.float32)
    with torch.no_grad():
        paf, heat = model(torch.from_numpy(x))
    jpaf, jheat = jnet.apply(params, jnp.asarray(x))
    assert paf.shape == (1, 8, 6, 38) and heat.shape == (1, 8, 6, 19)
    np.testing.assert_allclose(paf.numpy(), np.asarray(jpaf), atol=MAP_TOL, rtol=0)
    np.testing.assert_allclose(heat.numpy(), np.asarray(jheat), atol=MAP_TOL, rtol=0)
    # estimate_body's maps, as JAX computes them before its peaks
    img = np.random.default_rng(12).uniform(size=(48, 64, 3)).astype(np.float32)
    heatmap, pafmap = openpose.body_maps(model, img)
    scaled = cv2.resize(img, (0, 0), fx=0.5 * 368 / 48, fy=0.5 * 368 / 48,
                        interpolation=cv2.INTER_CUBIC)
    padded, (ph, pw) = jopenpose._pad_to_stride(scaled, 8, 128 / 255.0)
    jp, jh = jnet.apply(params, jnp.asarray(padded[None] * 255.0 / 256.0 - 0.5))

    def up(m):
        m = cv2.resize(np.asarray(m[0], np.float32), (0, 0), fx=8, fy=8,
                       interpolation=cv2.INTER_CUBIC)
        return cv2.resize(m[: padded.shape[0] - ph, : padded.shape[1] - pw], (64, 48),
                          interpolation=cv2.INTER_CUBIC)

    np.testing.assert_allclose(heatmap, up(jh), atol=DEPTH_TOL, rtol=0)
    np.testing.assert_allclose(pafmap, up(jp), atol=DEPTH_TOL, rtol=0)
    # the post-processing on known geometry
    h, w = 120, 160
    people = [{0: (40, 20), 1: (40, 40), 2: (28, 42), 3: (22, 66), 5: (52, 42), 6: (58, 66)},
              {0: (110, 24), 1: (110, 44), 2: (98, 46), 3: (92, 70), 5: (122, 46),
               6: (128, 70)}]
    heat_f, paf_f = _synthetic_pose_fields(h, w, people)
    peaks = openpose._find_peaks(heat_f, 0.1)
    assert peaks == jopenpose._find_peaks(heat_f, 0.1)
    conn, special = openpose._connect_limbs(paf_f, peaks, h, 0.05)
    jconn, jspecial = jopenpose._connect_limbs(paf_f, peaks, h, 0.05)
    assert special == jspecial
    for a, b in zip(conn, jconn):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    cand, subset = openpose._assemble_subsets(peaks, conn, special)
    jcand, jsubset = jopenpose._assemble_subsets(peaks, jconn, jspecial)
    np.testing.assert_array_equal(cand, jcand)
    np.testing.assert_array_equal(subset, jsubset)
    assert len(subset) == 2
    np.testing.assert_array_equal(openpose.draw_bodypose(h, w, cand, subset),
                                  jopenpose.draw_bodypose(h, w, jcand, jsubset))
    assert openpose.COLORS == jopenpose.COLORS and openpose.LIMB_SEQ == jopenpose.LIMB_SEQ


def _annotator_ckpts(root: Path) -> dict[str, Path]:
    """Reference checkpoints of random annotators at the widths the
    Generator builds (HED and the body net full width, the lineart U-Net
    ngf 64 with 8 downs), and a tiny-hybrid DPT."""
    root.mkdir(parents=True, exist_ok=True)
    nets = {"softedge": (_hed(1.0, 13), hed.reference_state_dict, "hed.pth"),
            "lineart": (_normal_(lineart.LineartAnimeUNet(), 0.03, 14),
                        lineart.reference_state_dict, "netG.pth"),
            "openpose": (_normal_(openpose.BodyPoseNet(), 0.02, 15),
                         openpose.reference_state_dict, "body_pose_model.pth"),
            "depth": (dpt.random_dpt(dpt.DPTConfig.tiny_hybrid(), 16, "cpu"),
                      dpt.reference_state_dict, "dpt.pth")}
    out = {}
    for kind, (net, export, name) in nets.items():
        torch.save(export(net), root / name)
        out[kind] = root / name
    out["lineart_anime"] = out["lineart"]
    return out


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return _annotator_ckpts(tmp_path_factory.mktemp("annotators"))


def test_model_fns_match_jax(ckpts):
    frames = np.random.default_rng(17).uniform(0.1, 0.9, (2, 32, 40, 3)).astype(np.float32)
    pairs = {"softedge": (hed.softedge_model_fn(ckpts["softedge"], device="cpu"),
                          jhed.softedge_model_fn(ckpts["softedge"]), MAP_TOL),
             "lineart": (lineart.lineart_model_fn(ckpts["lineart"], device="cpu"),
                         jlineart.lineart_model_fn(ckpts["lineart"]), MAP_TOL),
             "openpose": (openpose.openpose_model_fn(ckpts["openpose"], device="cpu"),
                          jopenpose.openpose_model_fn(ckpts["openpose"]), 0.0)}
    for kind, (fn, jfn, tol) in pairs.items():
        out = controlnet_utils.control_preprocess(frames, kind, model_fn=fn)
        ref = jctrl.control_preprocess(frames, kind, model_fn=jfn)
        assert out.shape == frames.shape and out.dtype == np.float32, kind
        np.testing.assert_allclose(out, ref, atol=tol, rtol=0, err_msg=kind)
        with pytest.raises(NotImplementedError, match="needs a local model"):
            controlnet_utils.control_preprocess(frames, kind)


def _controlnet_model_dir(root: Path, control: str) -> Path:
    models = build_tiny_sd(seed=1, device="cpu")
    models.controlnet = _perturbed(controlnet.ControlNetModel(models.unet.config), 8)
    write_model_dir(models, root, control=control)
    return root


def _jax_control_images(kind: str, ckpts, frames: np.ndarray) -> np.ndarray:
    """JAX's control images of a model-backed type on the annotator of
    `ckpts` (depth through JAX's DPT at the tiny config), resized to 8x
    the tiny stack's latent size as its Generator does."""
    import cv2

    if kind == "depth":
        sd = load_torch_state_dict(ckpts["depth"])
        jcfg = jdpt.DPTConfig.tiny_hybrid()
        n, h, w, _ = frames.shape
        d = np.asarray(jdpt.prepare_depth_maps(jdpt.DPTForDepthEstimation(jcfg),
                                               jdpt.convert_dpt(sd, jcfg), frames,
                                               (h // 2, w // 2)))
        d = np.stack([cv2.resize(f, (w, h)) for f in d])[..., None]
        ctrl = np.repeat((d + 1.0) / 2.0, 3, axis=-1).astype(np.float32)
    else:
        fn = {"softedge": jhed.softedge_model_fn, "openpose": jopenpose.openpose_model_fn,
              "lineart": jlineart.lineart_model_fn,
              "lineart_anime": jlineart.lineart_model_fn}[kind](ckpts[kind])
        ctrl = jctrl.control_preprocess(frames, kind, model_fn=fn)
    return np.stack([cv2.resize(f, (frames.shape[2] * 4, frames.shape[1] * 4)) for f in ctrl])


@pytest.mark.parametrize("kind", sorted(controlnet_utils.MODEL_BACKED))
def test_cli_runs_model_backed_controlnet_on_cpu(tmp_path, monkeypatch, kind, ckpts):
    """`python -m tclight_torch.run` with each model-backed ControlNet type
    on the tiny SD stack (a model_dir with its ControlNet), the annotator
    from `generation.annotator_ckpt` (depth: the tiny DPT of
    `generation.depth_ckpt`): the inversion, then generation, an mp4 of
    every frame, and control images equal to JAX's."""
    from tclight_torch.pipeline import generator as gen_mod
    from tclight_torch.run import main

    monkeypatch.chdir(Path(__file__).resolve().parent.parent)
    vid = _video(tmp_path / "vid")
    model_dir = _controlnet_model_dir(tmp_path / "model", kind)
    args = _cli_args(tmp_path, vid) + [f"generation.control={kind}",
                                       f"model_dir={model_dir}"]
    args.append(f"generation.depth_ckpt={ckpts['depth']}" if kind == "depth"
                else f"generation.annotator_ckpt={ckpts[kind]}")
    seen = {}
    control_images = gen_mod.Generator.control_images

    def spy(self, frames):
        seen["frames"], seen["ctrl"] = frames, control_images(self, frames)
        return seen["ctrl"]

    monkeypatch.setattr(gen_mod.Generator, "control_images", spy)
    assert main(args, device="cpu") == 0
    mp4s = sorted((tmp_path / "wd").rglob("output.mp4"))
    assert len(mp4s) == 1 and _frames(mp4s[0]) == 4
    ref = _jax_control_images(kind, ckpts, seen["frames"])
    assert seen["ctrl"].shape == ref.shape == (4, 128, 128, 3)
    tol = {"depth": DEPTH_TOL, "openpose": 0.0}.get(kind, MAP_TOL)
    np.testing.assert_allclose(seen["ctrl"].numpy(), ref, atol=tol, rtol=0)


def test_softedge_generation_matches_jax(tmp_path, ckpts):
    """The softedge ControlNet (HED of `annotator_ckpt`) on the tiny SD
    stack from one inversion cache: the port's frames against JAX's
    Generator's within 1e-3, as test_torch_editing_e2e.py holds canny."""
    from test_torch_editing_e2e import (FRAME_IDS, JConfigDict, JGenerator, JParser, _close,
                                        _config, _jax_models, _run)

    from tclight_torch.config import ConfigDict
    from tclight_torch.data.dataparsers import VideoDataParser
    from tclight_torch.pipeline import invert
    from tclight_torch.pipeline.generator import Generator

    vid = _video(tmp_path / "vid")
    models = build_tiny_sd(seed=0, num_inference_steps=2, device="cpu")
    models.controlnet = _perturbed(controlnet.ControlNetModel(models.unet.config), 9)
    cfg = _config(tmp_path, vid, "softedge", control_scale=0.7,
                  annotator_ckpt=str(ckpts["softedge"]))
    cache = tmp_path / "cache"
    invert.Inverter(models, ConfigDict(cfg), data_parser=VideoDataParser(cfg["data"]),
                    device="cpu")(cache, FRAME_IDS)
    gen_j, out_j = _run(JGenerator, _jax_models(models), JConfigDict, cfg, JParser, cache,
                        tmp_path / "j")
    gen_t, out_t = _run(Generator, models, ConfigDict, cfg, VideoDataParser, cache,
                        tmp_path / "t", device="cpu")
    np.testing.assert_allclose(gen_t._control_images.numpy(), np.asarray(gen_j._control_images),
                               atol=MAP_TOL, rtol=0)
    _close(out_t, out_j, 1e-3)
