"""The port's guardrail models (tclight_torch/cosmos/aegis.py with
aegis_data.py and models/convert_ar.py's Llama converters,
models/siglip.py, models/retinaface.py) and the checkpoint-backed
checkers of cosmos/guardrails.py, against the JAX package on the CPU in
f32, on the same checkpoints (state dicts in the published layouts,
written here from seeds: no weights are downloaded).

Tolerances:
- `from_hf_llama`, `merge_lora` (LoRA and rsLoRA), `expand_vocab`: equal;
- Aegis end to end on a tiny HF-layout Llama and a LoRA adapter on disk:
  the same tokens and the same decision;
- SigLIP and the safety head: 1e-5 of max |reference|;
- RetinaFace: boxes within 1e-4 px, the same NMS keeps;
- the checkers: with a checkpoint the loaded model runs (the same result
  as JAX's checker), without one they pass through, and none raises
  NotImplementedError.
"""

import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclight_torch.cosmos import aegis as taegis
from tclight_torch.cosmos import guardrails as tguard
from tclight_torch.models import convert_ar as tconv
from tclight_torch.models import retinaface as trf
from tclight_torch.models import siglip as tsig
from tclight_torch.models.convert import write_safetensors
from tclight_tpu.cosmos import aegis as jaegis
from tclight_tpu.cosmos import guardrails as jguard
from tclight_tpu.models import convert_ar as jconv
from tclight_tpu.models import retinaface as jrf
from tclight_tpu.models import siglip as jsig

torch.set_num_threads(2)


def _close(got, ref, rel=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# ---------------------------------------------------------------- Llama converters

LLAMA = dict(vocab=96, dim=32, layers=2, heads=4, kv_heads=2, ffn=48)


def _hf_llama(seed: int, c=LLAMA) -> dict:
    """A HF LlamaForCausalLM-layout state dict drawn from seed."""
    rng = np.random.default_rng(seed)
    hd = c["dim"] // c["heads"]

    def w(*shape):
        return (rng.standard_normal(shape) * 0.3).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(c["vocab"], c["dim"]),
          "model.norm.weight": 1 + 0.1 * w(c["dim"]), "lm_head.weight": w(c["vocab"], c["dim"])}
    for i in range(c["layers"]):
        p = f"model.layers.{i}."
        sd |= {p + "self_attn.q_proj.weight": w(c["heads"] * hd, c["dim"]),
               p + "self_attn.k_proj.weight": w(c["kv_heads"] * hd, c["dim"]),
               p + "self_attn.v_proj.weight": w(c["kv_heads"] * hd, c["dim"]),
               p + "self_attn.o_proj.weight": w(c["dim"], c["heads"] * hd),
               p + "mlp.gate_proj.weight": w(c["ffn"], c["dim"]),
               p + "mlp.up_proj.weight": w(c["ffn"], c["dim"]),
               p + "mlp.down_proj.weight": w(c["dim"], c["ffn"]),
               p + "input_layernorm.weight": 1 + 0.1 * w(c["dim"]),
               p + "post_attention_layernorm.weight": 1 + 0.1 * w(c["dim"])}
    return sd


def _adapter(seed: int, c=LLAMA, r: int = 2) -> dict:
    """A PEFT LoRA adapter on every layer's q and v projections."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(c["layers"]):
        kv = c["kv_heads"] * c["dim"] // c["heads"]
        for proj, n_out in (("q_proj", c["dim"]), ("v_proj", kv)):
            pre = f"base_model.model.model.layers.{i}.self_attn.{proj}"
            out[f"{pre}.lora_A.weight"] = (rng.standard_normal((r, c["dim"])) * 0.2
                                           ).astype(np.float32)
            out[f"{pre}.lora_B.weight"] = (rng.standard_normal((n_out, r)) * 0.2
                                           ).astype(np.float32)
    return out


@pytest.mark.parametrize("rslora", [False, True])
def test_llama_converters_match_jax(rslora):
    base, adapter = _hf_llama(0), _adapter(1)
    merged, jmerged = (tconv.merge_lora(base, adapter, 8.0, 2, use_rslora=rslora),
                       jconv.merge_lora(base, adapter, 8.0, 2, use_rslora=rslora))
    assert set(merged) == set(jmerged)
    for k in merged:
        np.testing.assert_array_equal(_np(merged[k]), jmerged[k], err_msg=k)
    assert not np.array_equal(_np(merged["model.layers.0.self_attn.q_proj.weight"]),
                              base["model.layers.0.self_attn.q_proj.weight"])
    # bf16 base tensors (a published file's dtype) merge in f32
    bf = {k: torch.from_numpy(v).bfloat16() for k, v in base.items()}
    assert tconv.merge_lora(bf, adapter, 8.0, 2)["model.layers.1.self_attn.v_proj.weight"
                                                  ].dtype == np.float32
    with pytest.raises(KeyError):
        tconv.merge_lora({}, adapter, 8.0, 2)
    flat = tconv.from_hf_llama(merged, LLAMA["heads"], LLAMA["kv_heads"])
    jflat = jconv.from_hf_llama(jmerged, LLAMA["heads"], LLAMA["kv_heads"])
    assert set(flat) == set(jflat)
    for k in flat:
        np.testing.assert_array_equal(_np(flat[k]), jflat[k], err_msg=k)
    sd = tconv.convert_ar_llm(flat, LLAMA["layers"])
    jp = jconv.convert_ar_llm(jflat, LLAMA["layers"])
    grown = tconv.expand_vocab(sd, 120, seed=3)
    jgrown = jconv.expand_vocab(jp, 120, seed=3)
    np.testing.assert_array_equal(_np(grown["tok_embeddings.weight"]),
                                  jgrown["tok_embeddings"]["embedding"])
    np.testing.assert_array_equal(_np(grown["output.weight"]), jgrown["output"]["kernel"].T)
    emb_only = tconv.expand_vocab(sd, 120, expand_output_layer=False)
    assert emb_only["tok_embeddings.weight"].shape == (120, 32)
    assert emb_only["output.weight"].shape == (96, 32)


# ---------------------------------------------------------------- Aegis


class _WordTokenizer:
    """A stand-in for the checkpoint's tokenizer (its vocabulary is data,
    not logic): a word's crc32 as its id; decode writes "unsafe" for odd
    ids, so the decision follows the tokens."""

    eos_token_id = 2

    def __init__(self, vocab: int):
        self.vocab = vocab

    def __call__(self, text, add_special_tokens=False):
        return {"input_ids": [3 + zlib.crc32(w.encode()) % (self.vocab - 3)
                              for w in text.split()]}

    def decode(self, ids, skip_special_tokens=True):
        return "\n".join(["unsafe" if ids and ids[0] % 2 else "safe", "O3"]) + " " + " ".join(
            "tok" for _ in ids)


def _aegis_dir(tmp_path):
    d = tmp_path / "aegis"
    d.mkdir()
    write_safetensors({k: torch.from_numpy(v) for k, v in _hf_llama(4).items()},
                      d / "model.safetensors")
    (d / "lora").mkdir()
    write_safetensors({k: torch.from_numpy(v) for k, v in _adapter(5).items()},
                      d / "lora" / "adapter_model.safetensors")
    (d / "lora" / "adapter_config.json").write_text(json.dumps({"lora_alpha": 8.0, "r": 2}))
    c = LLAMA
    (d / "config.json").write_text(json.dumps({
        "vocab_size": c["vocab"], "hidden_size": c["dim"], "num_hidden_layers": c["layers"],
        "num_attention_heads": c["heads"], "num_key_value_heads": c["kv_heads"],
        "intermediate_size": c["ffn"], "rms_norm_eps": 1e-5, "rope_theta": 10000.0}))
    return d


def test_aegis_prompt_and_parse_match_jax():
    assert taegis.UNSAFE_CATEGORIES == jaegis.UNSAFE_CATEGORIES
    for p in ("a cat in the sun", "", "line one\nline two"):
        assert taegis.moderation_prompt(p) == jaegis.moderation_prompt(p)
    for out in ("unsafe\nO1", "unsafe\nO10", "unsafe\nO12", "unsafe\nO1,O3", "unsafe", "safe\nx",
                "unsafe\nO13"):
        assert taegis.parse_block_message(out) == jaegis.parse_block_message(out)


def test_aegis_llamaguard_matches_jax(tmp_path):
    """A tiny HF-layout Llama and a LoRA adapter on disk, both packages'
    loaders: the same greedy tokens and the same decision."""
    d = _aegis_dir(tmp_path)
    tok = _WordTokenizer(LLAMA["vocab"])
    guard = taegis.AegisLlamaGuard(d, max_new_tokens=12, tokenizer=tok, device="cpu")
    jguard_ = jaegis.AegisLlamaGuard(d, max_new_tokens=12, tokenizer=tok)
    assert guard.cfg.max_seq_len == 4096 and guard.cfg.dtype == torch.float32
    ids = np.asarray([tok(taegis.moderation_prompt("a cat in the sun"))["input_ids"]])
    out = guard.generator.generate(prompt_tokens=ids, max_gen_len=12, temperature=0.0,
                                   stop_tokens=(2,))
    jout = jguard_.generator.generate(prompt_tokens=ids.astype(np.int32), max_gen_len=12,
                                      temperature=0.0, stop_tokens=(2,))
    np.testing.assert_array_equal(out, jout)
    for prompt in ("a cat in the sun", "a robot stacks blocks"):
        assert guard.moderate(prompt) == jguard_.moderate(prompt)
        assert guard.is_safe(prompt) == jguard_.is_safe(prompt)


# ---------------------------------------------------------------- SigLIP


def _hf_siglip_tiny():
    from transformers import SiglipVisionConfig as HFCfg
    from transformers import SiglipVisionModel

    torch.manual_seed(0)
    model = SiglipVisionModel(HFCfg(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                    num_attention_heads=2, image_size=28, patch_size=14))
    with torch.no_grad():  # the probe and the positions drawn, not zero
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return model.eval()


def _safety_head_sd(dim: int, seed: int = 1) -> dict:
    """The Cosmos `safety_filter.pt` layout with non-trivial BN statistics."""
    torch.manual_seed(seed)
    net = torch.nn.Sequential(
        torch.nn.Linear(dim, 512), torch.nn.BatchNorm1d(512), torch.nn.ReLU(),
        torch.nn.Linear(512, 256), torch.nn.BatchNorm1d(256), torch.nn.ReLU(),
        torch.nn.Linear(256, 7))
    net.train()
    with torch.no_grad():
        for _ in range(3):
            net(torch.randn(16, dim) * 2 + 0.5)
    return {f"network.layers.{k}": v for k, v in net.state_dict().items()}


def test_siglip_and_head_match_jax():
    hf = _hf_siglip_tiny()
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    imgs = np.random.default_rng(2).uniform(-1, 1, (2, 28, 28, 3)).astype(np.float32)
    ref = np.asarray(jsig.SiglipVisionTower(jsig.SiglipVisionConfig.tiny()).apply(
        jsig.convert_siglip_vision(sd), jnp.asarray(imgs)))
    tower = tsig.SiglipVisionTower(tsig.SiglipVisionConfig.tiny())
    tower.load_state_dict(tsig.convert_siglip_vision(sd))
    with torch.inference_mode():
        out = tower(torch.from_numpy(imgs))
        hf_out = hf(torch.from_numpy(imgs).permute(0, 3, 1, 2)).pooler_output
    _close(out, ref)
    _close(out, hf_out.numpy(), 1e-4)
    head_sd = _safety_head_sd(32)
    jhead = jsig.convert_safety_classifier({k: v.numpy() for k, v in head_sd.items()})
    feats = np.random.default_rng(3).standard_normal((5, 32)).astype(np.float32)
    jlogits = np.asarray(jsig.SafetyClassifier(input_size=32).apply(jhead, jnp.asarray(feats)))
    head = tsig.SafetyClassifier(input_size=32)
    head.load_state_dict(tsig.convert_safety_classifier(head_sd))
    with torch.inference_mode():
        _close(head(torch.from_numpy(feats)), jlogits)
    frames = np.random.default_rng(4).uniform(0, 1, (3, 20, 30, 3)).astype(np.float32)
    np.testing.assert_array_equal(tsig.preprocess_siglip(frames, 28),
                                  jsig.preprocess_siglip(frames, 28))


# ---------------------------------------------------------------- RetinaFace


def test_retinaface_matches_jax():
    """The tiny topology on a published-layout state dict (BN folded by
    both converters): outputs within 1e-5, decoded boxes within 1e-4 px, the
    same boxes kept at a threshold that keeps some."""
    cfg, jcfg = trf.RetinaFaceConfig.tiny(), jrf.RetinaFaceConfig.tiny()
    sd = trf.random_reference_state_dict(cfg, seed=0)
    npsd = {k: v.numpy() for k, v in sd.items()}
    model = trf.RetinaFace(cfg)
    model.load_state_dict(trf.convert_retinaface(sd, cfg))
    x = np.random.default_rng(5).uniform(-100, 100, (2, 72, 88, 3)).astype(np.float32)
    jout = jrf.RetinaFace(jcfg).apply(jrf.convert_retinaface(npsd, jcfg), jnp.asarray(x))
    with torch.inference_mode():
        out = model(torch.from_numpy(x))
    for a, b in zip(out, jout):
        _close(a, np.asarray(b))
    priors = trf.prior_boxes(cfg, 72, 88)
    np.testing.assert_array_equal(priors, jrf.prior_boxes(jcfg, 72, 88))
    scale = np.array([88, 72, 88, 72], np.float32)
    boxes = trf.decode_boxes(out[0].numpy(), priors) * scale
    jboxes = jrf.decode_boxes(np.asarray(jout[0]), priors) * scale
    np.testing.assert_allclose(boxes, jboxes, rtol=0, atol=1e-4)
    scores, jscores = out[1].numpy()[..., 1], np.asarray(jout[1])[..., 1]
    thr = float(np.quantile(jscores[0], 0.9))
    kept = trf.filter_detected_boxes(boxes[0], scores[0], thr, top_k=200)
    jkept = jrf.filter_detected_boxes(jboxes[0], jscores[0], thr, top_k=200)
    assert 1 < len(kept) == len(jkept)
    np.testing.assert_allclose(kept, jkept, rtol=0, atol=1e-4)
    dets = np.hstack([jboxes[0], jscores[0][:, None]]).astype(np.float32)[:300]
    assert trf.nms(dets, 0.4) == jrf.nms(dets, 0.4)
    img = np.random.default_rng(6).uniform(size=(20, 23, 3)).astype(np.float32)
    np.testing.assert_array_equal(trf.pixelate_face(img), jrf.pixelate_face(img))


# ---------------------------------------------------------------- the checkers


def test_checkers_pass_through_without_checkpoints(tmp_path):
    frames = np.random.default_rng(7).uniform(size=(4, 16, 16, 3)).astype(np.float32)
    missing = tmp_path / "absent"
    for checker in (tguard.AegisChecker(missing, device="cpu"),
                    tguard.VideoContentSafetyChecker(missing, device="cpu"),
                    tguard.AegisChecker(None), tguard.VideoContentSafetyChecker(None)):
        res = checker(frames if isinstance(checker, tguard.VideoContentSafetyChecker) else "x")
        assert res.is_safe and "pass-through" in res.message
    runner = tguard.presets_video(missing, missing, device="cpu")
    assert runner.is_safe(frames).is_safe
    np.testing.assert_array_equal(runner.postprocess(frames), frames)
    assert tguard.presets_text(device="cpu").is_safe("a calm lake").is_safe
    # an injected predict wins, with or without a checkpoint
    flagged = tguard.VideoContentSafetyChecker(
        tmp_path, predict=lambda f: tguard.SafetyResult(False, "Violence"))
    assert not flagged(frames).is_safe
    blur = tguard.FaceBlurFilter(tmp_path, predict=lambda f: f * 0)
    assert (blur.process(frames) == 0).all()
    # an existing directory without the model's files also passes through
    assert tguard.VideoContentSafetyChecker(tmp_path, device="cpu")(frames).is_safe
    np.testing.assert_array_equal(tguard.FaceBlurFilter(tmp_path, device="cpu").process(frames),
                                  frames)


def test_aegis_checker_runs_the_loaded_model(tmp_path, monkeypatch):
    import transformers

    d = _aegis_dir(tmp_path)
    tok = _WordTokenizer(LLAMA["vocab"])
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        staticmethod(lambda path: tok))
    checker, jchecker = tguard.AegisChecker(d, device="cpu"), jguard.AegisChecker(d)
    for prompt in ("a cat in the sun", "a robot stacks blocks", "x y z"):
        res, jres = checker(prompt), jchecker(prompt)
        assert (res.is_safe, res.message) == (jres.is_safe, jres.message)
    assert isinstance(checker._model, taegis.AegisLlamaGuard)
    runner = tguard.presets_text(aegis_ckpt=d, device="cpu")
    assert runner.is_safe("graphic gore").message == "blocked word: gore"


def test_video_safety_checker_runs_the_loaded_model(tmp_path, monkeypatch):
    """siglip_vision.safetensors and safety_filter.pt of the tiny widths
    (both packages' so400m() monkeypatched to the tiny config): the same
    verdict as JAX's checker, frames sampled at 2 fps."""
    from tclight_torch.models.convert import write_safetensors as write

    hf = _hf_siglip_tiny()
    write({k: v.contiguous() for k, v in hf.state_dict().items()},
          tmp_path / "siglip_vision.safetensors")
    head_sd = _safety_head_sd(32, seed=2)
    # the "Safe" logit lowered, so that some frames are flagged
    head_sd["network.layers.6.bias"][0] -= 2.0
    torch.save(head_sd, tmp_path / "safety_filter.pt")
    monkeypatch.setattr(tsig.SiglipVisionConfig, "so400m",
                        staticmethod(tsig.SiglipVisionConfig.tiny))
    monkeypatch.setattr(jsig.SiglipVisionConfig, "so400m",
                        staticmethod(jsig.SiglipVisionConfig.tiny))
    rng = np.random.default_rng(8)
    checker = tguard.VideoContentSafetyChecker(tmp_path, device="cpu")
    jchecker = jguard.VideoContentSafetyChecker(tmp_path)
    verdicts = set()
    for _ in range(4):
        frames = rng.uniform(size=(30, 40, 40, 3)).astype(np.float32)
        res, jres = checker(frames), jchecker(frames)
        assert (res.is_safe, res.message) == (jres.is_safe, jres.message)
        verdicts.add(res.is_safe)
    assert checker._image_size == 28 and False in verdicts


def test_face_blur_filter_runs_the_loaded_model(tmp_path):
    """A RetinaFace-R50 `Resnet50_Final.pth` from a seed (the class bias
    raised so that faces are found at 0.7): the same blurred frames as
    JAX's filter."""
    sd = trf.random_reference_state_dict(trf.RetinaFaceConfig.re50(), seed=3)
    for i in range(3):
        sd[f"ClassHead.{i}.conv1x1.bias"][1::2] += 3.0
    torch.save({f"module.{k}": v for k, v in sd.items()}, tmp_path / "Resnet50_Final.pth")
    frames = np.random.default_rng(9).uniform(size=(2, 64, 80, 3)).astype(np.float32)
    blur, jblur = tguard.FaceBlurFilter(tmp_path, device="cpu"), jguard.FaceBlurFilter(tmp_path)
    out, jout = blur.process(frames), jblur.process(frames)
    boxes = blur._detector.detect(frames)
    assert sum(len(b) for b in boxes) > 0 and not np.array_equal(out, frames)
    for b, jb in zip(boxes, jblur._detector.detect(frames)):
        np.testing.assert_allclose(b, jb, rtol=0, atol=1e-4)
    np.testing.assert_allclose(out, jout, rtol=0, atol=1e-5)


# ---------------------------------------------------------------- the bridges


@pytest.mark.parametrize("name", ["siglip", "head", "retinaface"])
def test_bridges_map_jax_trees(name):
    """JAX's own init of each model, through the port's bridge: the same
    outputs (1e-5)."""
    from tclight_torch.models import bridge

    rng = np.random.default_rng(10)
    if name == "siglip":
        jm, m = jsig.SiglipVisionTower(jsig.SiglipVisionConfig.tiny()), tsig.SiglipVisionTower(
            tsig.SiglipVisionConfig.tiny())
        x, fn = rng.uniform(-1, 1, (2, 28, 28, 3)).astype(np.float32), bridge.siglip_state_dict
    elif name == "head":
        jm, m = jsig.SafetyClassifier(input_size=32), tsig.SafetyClassifier(input_size=32)
        x, fn = rng.standard_normal((3, 32)).astype(np.float32), \
            bridge.safety_classifier_state_dict
    else:
        jm, m = jrf.RetinaFace(jrf.RetinaFaceConfig.tiny()), trf.RetinaFace(
            trf.RetinaFaceConfig.tiny())
        x, fn = rng.uniform(-1, 1, (1, 40, 48, 3)).astype(np.float32), bridge.retinaface_state_dict
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
        np.float32), params)  # the zero-initialised probe, positions and biases drawn
    m.load_state_dict(fn(params))
    ref = jm.apply(params, jnp.asarray(x))
    with torch.inference_mode():
        out = m(torch.from_numpy(x))
    for a, b in zip(out if isinstance(out, tuple) else (out,), ref if isinstance(ref, tuple)
                    else (ref,)):
        _close(a, np.asarray(b))
