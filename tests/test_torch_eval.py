"""The port's evaluation (eval/metrics.py, eval/loaders.py, evaluate.py,
models/clip_vision.py, models/vgg_lpips.py) against the JAX package's, on
the CPU in f32, on the same weights and inputs:

- every metric of eval/metrics.py: the host metrics (SSIMs, PSNR, the CLIP
  scores) to 1e-9; warp_error_ssim, whose masks and warp run in torch,
  to 1e-6 (a warped value can round to another uint8 level only at a tie);
- the CLIP vision tower (tiny) from a transformers
  CLIPVisionModelWithProjection through `convert_clip_vision`: within 3e-5
  of transformers and of JAX; the text embedding of `make_clip_embed_fn`
  (pooled at the first EOS, projected) within 1e-5 of JAX's;
- VGG16 features, LPIPS and the perceptual loss with JAX's weights carried
  across: within 1e-5 relative;
- the loaders' errors, and root evaluate.py against
  `tclight_torch.evaluate.main(..., device="cpu")` on one run directory:
  with Farneback flows, and with tiny RAFT, CLIP and full-size random VGG16
  / lpips checkpoints written here (JAX's loaders build the published
  configs, so its RAFTConfig and CLIPVisionConfig presets are the tiny ones
  here, monkeypatched). Every result.txt row agrees to its printed digits.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tclight_torch.eval import loaders, metrics
from tclight_torch.models import bridge, clip_vision, raft, vgg_lpips
from tclight_tpu.eval import loaders as jloaders
from tclight_tpu.eval import metrics as jmetrics
from tclight_tpu.models import clip_vision as jclip_vision
from tclight_tpu.models import raft as jraft
from tclight_tpu.models import vgg_lpips as jvgg

torch.set_num_threads(2)


def _video(n=4, h=32, w=48, seed=0, shift=2):
    import cv2

    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.uniform(0.1, 0.9, (h, w, 3)).astype(np.float32), (0, 0), 1.5)
    return np.stack([np.roll(base, shift * t, axis=1) for t in range(n)]).astype(np.float32)


def test_host_metrics_match_jax(rng):
    a = rng.uniform(size=(3, 24, 24, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    u8 = lambda x: np.uint8(x * 255)
    assert metrics.ssim_uniform(u8(a[0]), u8(b[0])) == pytest.approx(
        jmetrics.ssim_uniform(u8(a[0]), u8(b[0])), abs=1e-12)
    assert metrics.ssim_gaussian(a, b) == pytest.approx(jmetrics.ssim_gaussian(a, b), abs=1e-12)
    assert metrics.psnr(a, b) == pytest.approx(jmetrics.psnr(a, b), abs=1e-9)
    embs = rng.standard_normal((5, 16)).astype(np.float32)
    temb = rng.standard_normal(16).astype(np.float32)
    for name, args in (("clip_frame_score", (embs,)), ("clip_text_score", (embs, temb)),
                       ("pick_score", (embs, temb))):
        assert getattr(metrics, name)(*args) == pytest.approx(
            getattr(jmetrics, name)(*args), abs=1e-9)


def test_warp_error_ssim_matches_jax():
    from tclight_tpu.data.flow_backends import compute_flow_pairs

    source = _video(4, 32, 48, seed=1)
    edited = np.clip(source * 0.8 + 0.1, 0, 1)
    fwd = compute_flow_pairs(source, "future")[:-1]
    bwd = compute_flow_pairs(source, "past")[1:]
    ours = metrics.warp_error_ssim(edited, source, flow_fwd=fwd, flow_bwd=bwd, device="cpu")
    ref = jmetrics.warp_error_ssim(edited, source, flow_fwd=fwd, flow_bwd=bwd)
    assert 0.0 < ours <= 1.0 and ours == pytest.approx(ref, abs=1e-6)
    # flows from a flow function: a constant 2 px roll
    roll = lambda a, b: np.stack([np.full(a.shape[:2], 2.0 if a is not b else 0.0),
                                  np.zeros(a.shape[:2])], -1).astype(np.float32)
    assert metrics.warp_error_ssim(edited, source, flow_fn=roll, device="cpu") == pytest.approx(
        jmetrics.warp_error_ssim(edited, source, flow_fn=roll), abs=1e-6)


def _hf_clip_vision(seed=0):
    from transformers import CLIPVisionConfig as HFCfg
    from transformers import CLIPVisionModelWithProjection as HFModel

    torch.manual_seed(seed)
    return HFModel(HFCfg(image_size=32, patch_size=16, hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=64, projection_dim=16,
                         hidden_act="quick_gelu")).eval()


def test_clip_vision_matches_transformers_and_jax(rng):
    hf = _hf_clip_vision()
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    tree = clip_vision.convert_clip_vision(sd)
    ref_tree = jclip_vision.convert_clip_vision(sd)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(ref_tree)
    model = clip_vision.CLIPVisionModel(clip_vision.CLIPVisionConfig.tiny())
    model.load_state_dict(bridge.clip_vision_state_dict(tree))
    imgs = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        ours = model(torch.from_numpy(imgs)).numpy()
        hf_out = hf(torch.from_numpy(np.moveaxis(
            (imgs - clip_vision.CLIP_MEAN) / clip_vision.CLIP_STD, -1, 1).copy())).image_embeds
    jmodel = jclip_vision.CLIPVisionModel(jclip_vision.CLIPVisionConfig.tiny())
    np.testing.assert_allclose(ours, hf_out.numpy(), atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(ours, np.asarray(jmodel.apply(ref_tree, jnp.asarray(imgs))),
                               atol=3e-5, rtol=1e-4)
    for preset in ("vit_b32", "vit_h14", "tiny"):
        ours_cfg = getattr(clip_vision.CLIPVisionConfig, preset)()
        ref_cfg = getattr(jclip_vision.CLIPVisionConfig, preset)()
        assert all(getattr(ours_cfg, f) == getattr(ref_cfg, f)
                   for f in ours_cfg.__dataclass_fields__)


class _Tokenizer:
    """Enough of a CLIP tokenizer for the embed function: word ids below
    the vocabulary's last two, which are BOS and EOS."""

    bos_token_id, eos_token_id = 998, 999

    def __call__(self, text, truncation=True, max_length=77, add_special_tokens=False):
        ids = [sum(map(ord, w)) % 990 for w in text.split()]
        return {"input_ids": ids[:max_length]}


def test_clip_embed_fn_text_embedding_matches_jax(rng):
    from tclight_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from tclight_tpu.models.clip_text import CLIPTextConfig as JTextCfg
    from tclight_tpu.models.clip_text import CLIPTextModel as JText

    for preset in ("vit_b32", "vit_h14"):
        ours_cfg, ref_cfg = getattr(CLIPTextConfig, preset)(), getattr(JTextCfg, preset)()
        assert all(getattr(ours_cfg, f) == getattr(ref_cfg, f)
                   for f in ("hidden_size", "num_layers", "num_heads", "intermediate_size",
                             "vocab_size", "max_positions"))
    ids = jnp.zeros((1, 77), jnp.int32)
    tparams = jax.jit(JText(JTextCfg.tiny()).init)(jax.random.PRNGKey(1), ids)
    text = CLIPTextModel(CLIPTextConfig.tiny())
    text.load_state_dict(bridge.clip_text_state_dict(tparams))
    vparams = jax.jit(jclip_vision.CLIPVisionModel(jclip_vision.CLIPVisionConfig.tiny()).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)))
    vision = clip_vision.CLIPVisionModel(clip_vision.CLIPVisionConfig.tiny())
    vision.load_state_dict(bridge.clip_vision_state_dict(vparams))
    proj = rng.standard_normal((32, 16)).astype(np.float32)
    frames = _video(3, 40, 56, seed=2)
    ours = clip_vision.make_clip_embed_fn(vision.eval(), text.eval(), proj, _Tokenizer(), 32)
    ref = jclip_vision.make_clip_embed_fn(
        jclip_vision.CLIPVisionModel(jclip_vision.CLIPVisionConfig.tiny()), vparams,
        JText(JTextCfg.tiny()), tparams, proj, _Tokenizer(), image_size=32)
    for prompt in ("a warm light", " ".join(["word"] * 75)):  # the second fills all 77
        (embs, temb), (rembs, rtemb) = ours(frames, prompt), ref(frames, prompt)
        np.testing.assert_allclose(embs, np.asarray(rembs), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(temb, np.asarray(rtemb), atol=1e-5, rtol=1e-5)
    assert ours(frames, "")[1] is None


@pytest.fixture(scope="module")
def vgg_params():
    return jax.jit(jvgg.VGG16Features().init)(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 32, 32, 3), jnp.float32))


def test_lpips_and_perceptual_loss_match_jax(vgg_params):
    vgg = vgg_lpips.VGG16Features()
    vgg.load_state_dict(bridge.vgg16_state_dict(vgg_params))
    a, b = _video(3, 32, 48, seed=3), _video(3, 32, 48, seed=4)
    with torch.no_grad():
        feats = vgg(torch.from_numpy(a))
    ref_feats = jvgg.VGG16Features().apply(vgg_params, jnp.asarray(a))
    assert [tuple(f.shape) for f in feats] == [(3, 64, 32, 48), (3, 128, 16, 24),
                                               (3, 256, 8, 12), (3, 512, 4, 6), (3, 512, 2, 3)]
    for f, r in zip(feats, ref_feats):
        r = np.moveaxis(np.asarray(r), -1, 1)
        np.testing.assert_allclose(f.numpy(), r, rtol=1e-5, atol=1e-5 * np.abs(r).max())
    rng = np.random.default_rng(5)
    lin = vgg_lpips.load_lpips_lin_weights({
        f"lin{i}.model.1.weight": rng.uniform(-0.2, 1.0, (1, c, 1, 1)).astype(np.float32)
        for i, c in enumerate((64, 128, 256, 512, 512))})
    assert all((w >= 0).all() for w in lin)
    ours = vgg_lpips.LPIPS(vgg, lin)(a, b)
    np.testing.assert_allclose(ours, jvgg.LPIPS(vgg_params, lin)(jnp.asarray(a), jnp.asarray(b)),
                               rtol=1e-5)
    assert ours.shape == (3,) and np.abs(vgg_lpips.LPIPS(vgg, lin)(a, a)).max() < 1e-6
    assert metrics.frame_lpips(a, b, vgg_lpips.LPIPS(vgg, lin)) == pytest.approx(
        jmetrics.frame_lpips(a, b, jvgg.LPIPS(vgg_params, lin)), rel=1e-5)
    with torch.no_grad():
        loss = float(vgg_lpips.VGGPerceptualLoss(vgg)(a, b))
    assert loss == pytest.approx(float(jvgg.VGGPerceptualLoss(vgg_params)(
        jnp.asarray(a), jnp.asarray(b))), rel=1e-5)


def test_loader_errors(tmp_path):
    assert loaders.load_flow_backend("farneback", None) == ("farneback", None)
    with pytest.raises(FileNotFoundError):
        loaders.load_flow_backend("raft", tmp_path / "missing.pth")
    with pytest.raises(FileNotFoundError):
        loaders.load_flow_backend("memflow", None)
    with pytest.raises(ValueError):
        loaders.load_flow_backend("bogus", None)
    with pytest.raises(FileNotFoundError, match="vision"):
        loaders.load_clip_embed(tmp_path, device="cpu")
    with pytest.raises(FileNotFoundError, match="lpips_vgg"):
        loaders.load_lpips(tmp_path, device="cpu")


def test_clip_loader_takes_a_text_checkpoint_with_its_projection(tmp_path):
    """A CLIPTextModelWithProjection state dict holds `text_projection.weight`,
    which the text converter does not map: JAX's loader raises on it, the
    port's takes the projection out first (without a tokenizer the text
    metrics are then off, in both)."""
    from transformers import CLIPTextConfig as HFTextCfg
    from transformers import CLIPTextModelWithProjection as HFText

    torch.save(_hf_clip_vision().state_dict(), tmp_path / "vision.pth")
    torch.manual_seed(1)
    hf = HFText(HFTextCfg(vocab_size=1000, hidden_size=32, num_hidden_layers=2,
                          num_attention_heads=2, intermediate_size=64, projection_dim=16,
                          max_position_embeddings=77, hidden_act="quick_gelu"))
    torch.save(hf.state_dict(), tmp_path / "text.pth")
    embed = loaders.load_clip_embed(tmp_path, device="cpu")
    embs, temb = embed(_video(2, 40, 40), "a prompt")
    assert embs.shape == (2, 16) and temb is None
    with pytest.raises(KeyError, match="text_projection"):
        jloaders.load_clip_embed(tmp_path)


def _rows(path: Path) -> dict:
    lines = path.read_text().splitlines()
    return dict(line.split(": ", 1) for line in lines[1:])


def _run_dir(tmp_path) -> Path:
    from tclight_torch.utils.video_io import save_video

    run_dir = tmp_path / "out" / "run"
    run_dir.mkdir(parents=True)
    source = _video(4, 32, 48, seed=6)
    save_video(np.clip(source * 0.9 + 0.05, 0, 1), run_dir / "output.mp4", fps=8)
    save_video(source, run_dir / "output_gt.mp4", fps=8)
    (run_dir / "config.yaml").write_text(yaml.safe_dump({
        "generation": {"prompt": {"x": "a warm prompt"}}, "sec_per_frame": 0.5,
        "max_memory_allocated": 1234.5, "total_time": 2.0}))
    return run_dir


def _ckpts(tmp_path) -> list[str]:
    """Tiny RAFT and CLIP checkpoints and a full-size random VGG16 with lpips
    heads, in the reference layouts."""
    torch.manual_seed(0)
    torch.save({f"module.{k}": v for k, v in
                raft.reference_state_dict(raft.RAFT(raft.RAFTConfig.tiny())).items()},
               tmp_path / "raft-things.pth")
    for name in ("clip", "pick"):
        (tmp_path / name).mkdir()
        torch.save(_hf_clip_vision(seed=len(name)).state_dict(), tmp_path / name / "vision.pth")
    lp = tmp_path / "lpips"
    lp.mkdir()
    torch.manual_seed(2)
    vgg, idx, cin = {}, 0, 3
    for item in vgg_lpips._VGG16_PLAN:
        if item == "M":
            idx += 1
            continue
        conv = torch.nn.Conv2d(cin, item, 3, padding=1)
        vgg[f"features.{idx}.weight"], vgg[f"features.{idx}.bias"] = conv.weight, conv.bias
        idx, cin = idx + 2, item
    torch.save({k: v.detach() for k, v in vgg.items()}, lp / "vgg16.pth")
    torch.save({f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1) - 0.2
                for i, c in enumerate((64, 128, 256, 512, 512))}, lp / "lpips_vgg.pth")
    return ["--flow_model", "raft", "--flow_ckpt", str(tmp_path / "raft-things.pth"),
            "--clip_ckpt", str(tmp_path / "clip"), "--pick_ckpt", str(tmp_path / "pick"),
            "--lpips_ckpt", str(lp), "--eval_cost"]


@pytest.mark.parametrize("with_ckpts", [False, True])
def test_evaluate_cli_matches_jax(tmp_path, monkeypatch, eval_cli, with_ckpts):
    from tclight_torch import evaluate

    run_dir = _run_dir(tmp_path)
    args = ["--output_dir", str(tmp_path / "out")]
    if with_ckpts:
        args += _ckpts(tmp_path)
        monkeypatch.setattr(jraft.RAFTFlowModel.__init__, "__defaults__",
                            (jraft.RAFTConfig.tiny(),))
        for preset in ("vit_b32", "vit_h14"):
            monkeypatch.setattr(jclip_vision.CLIPVisionConfig, preset,
                                staticmethod(jclip_vision.CLIPVisionConfig.tiny))
    else:
        args += ["--flow_model", "farneback"]
    assert eval_cli.main(args) == 0
    ref = _rows(run_dir / "result.txt")
    (run_dir / "result.txt").unlink()
    timings = {}
    assert evaluate.main(args, device="cpu", timings=timings) == 0
    ours = _rows(run_dir / "result.txt")
    assert ours == ref
    expected = {"warp-error-ssim", "psnr", "ssim", "zz_flow_backend"}
    if with_ckpts:
        expected |= {"clip-frame", "frame-lpips", "z_fps", "z_max_memory_allocated(M)",
                     "z_resolution", "z_total_frames", "z_total_time(s)"}
        assert ours["zz_flow_backend"] == "raft" and "zz_skipped_metrics" not in ours
        assert all(np.isfinite(float(v)) for k, v in ours.items() if not k.startswith("zz"))
        assert {"models", "flows", "warp-error", "clip", "frame-lpips"} <= timings.keys()
    else:
        assert ours["zz_skipped_metrics"] == "clip,pick-score,frame-lpips"
    assert expected <= ours.keys()
