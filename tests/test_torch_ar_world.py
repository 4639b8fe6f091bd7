"""The port's AR world stack (tclight_torch/cosmos/fsq.py, the discrete half
of dv_tokenizer.py, models/ar_configs.py, `ARVideo2WorldPipeline`,
models/t5_encoder.py with cosmos/t5.py, the diffusion decoder and its
converter, config_lazy.py) against the JAX package on the CPU in f32, on
the same weights (JAX's trees through the port's bridges, or the port's
Cosmos-layout state dicts through JAX's converters) and the same inputs
and draws (JAX's Gumbel noise, normals and uniforms injected).

Tolerances, as each test states them:
- quantizer codes and indices: exactly equal, on inputs drawn at least
  0.05 from a rounding tie;
- tokenizer encode: indices and codes equal wherever the pre-round value is
  more than 1e-3 from a rounding boundary; encode / decode values and the
  Haar round trips within 1e-5 of max |reference|; the chunked wrapper
  equals its chunks' own calls (1e-5);
- the AR pipeline: the same tokens with JAX's draws, the video within 1e-5;
- T5 (relu and gated) and the decoder DiT: 1e-5 of max |reference|;
- split_with_overlap / linear_blend_video_list: exactly equal;
- diffusion_decoder_process_tokens over two overlapping chunks: the
  latents and the blended video within 1e-4 of max |reference|.
"""

import dataclasses
import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclight_torch import config as tconfig
from tclight_torch import config_lazy as tlazy
from tclight_torch.cosmos import convert_dit as tcdit
from tclight_torch.cosmos import convert_dv as tcdv
from tclight_torch.cosmos import diffusion_decoder as tdd
from tclight_torch.cosmos import dv_tokenizer as tdv
from tclight_torch.cosmos import fsq as tfsq
from tclight_torch.cosmos import pipelines as tpipe
from tclight_torch.cosmos import t5 as tt5
from tclight_torch.cosmos.dit import DiTConfig as TDiTConfig
from tclight_torch.cosmos.dit import init_dit_
from tclight_torch.models import ar_configs as tarc
from tclight_torch.models import ar_transformer as tar
from tclight_torch.models import bridge
from tclight_torch.models import t5_encoder as tt5e
from tclight_torch.models.convert import write_safetensors
from tclight_tpu import config as jconfig
from tclight_tpu import config_lazy as jlazy
from tclight_tpu.cosmos import diffusion_decoder as jdd
from tclight_tpu.cosmos import dv_tokenizer as jdv
from tclight_tpu.cosmos import fsq as jfsq
from tclight_tpu.cosmos import pipelines as jpipe
from tclight_tpu.cosmos.convert_dit import convert_diffusion_decoder_dit as jconvert_dd
from tclight_tpu.cosmos.convert_dv import convert_dv_tokenizer as jconvert_dv
from tclight_tpu.cosmos.dit import DiTConfig as JDiTConfig
from tclight_tpu.models import ar_configs as jarc
from tclight_tpu.models import ar_transformer as jar
from tclight_tpu.models import t5_encoder as jt5e

torch.set_num_threads(2)


def _close(got, ref, rel=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


def _away_from_ties(levels, half, offset, shift, shape, seed):
    """z whose bounded values zb = tanh(z + shift) * half - offset sit
    0.05-0.45 from an integer, so rounding never meets a tie."""
    rng = np.random.default_rng(seed)
    lv = np.asarray(levels)
    lo, hi = np.ceil(-half - offset + 0.5), np.floor(half - offset - 0.5)
    digit = rng.integers(lo, hi + 1, size=shape + (len(lv),))
    frac = rng.uniform(0.05, 0.45, size=digit.shape) * rng.choice([-1, 1], size=digit.shape)
    zb = digit + frac
    return (np.arctanh((zb + offset) / half) - shift).astype(np.float32)


# ---------------------------------------------------------------- quantizers


def test_fsq_quantizer_matches_jax():
    for levels in ((8, 8, 8, 5, 5, 5), (5, 5, 5)):
        jq, q = jfsq.FSQuantizer(levels), tfsq.FSQuantizer(levels)
        lv = np.asarray(levels, np.float64)
        half, offset = (lv - 1) / 2, np.where(lv % 2 == 0, 0.5, 0.0)
        z = _away_from_ties(levels, half, offset, np.tan(offset / half), (3, 7), 0)
        jcodes = np.asarray(jq.quantize(jnp.asarray(z)))
        codes = q.quantize(torch.from_numpy(z)).numpy()
        np.testing.assert_array_equal(codes, jcodes)
        jidx = np.asarray(jq.codes_to_indices(jnp.asarray(jcodes)))
        idx = q.codes_to_indices(torch.from_numpy(codes)).numpy()
        np.testing.assert_array_equal(idx, jidx)
        assert len(np.unique(idx)) > 10 and q.codebook_size == jq.codebook_size
        np.testing.assert_array_equal(q.indices_to_codes(torch.from_numpy(idx)).numpy(),
                                      np.asarray(jq.indices_to_codes(jnp.asarray(jidx))))
        np.testing.assert_array_equal(q.indices_to_codes(torch.from_numpy(idx)).numpy(), codes)


def test_dv_quantizer_matches_jax():
    levels = (8, 8, 8, 5, 5, 5)
    jq, q = jdv.FSQuantizer(levels), tdv.FSQuantizer(levels)
    lv = np.asarray(levels, np.float64)
    half = (lv - 1) * 1.001 / 2
    offset = np.where(lv % 2 == 0, 0.5, 0.0)
    z = _away_from_ties(levels, half, offset, np.arctanh(offset / half), (2, 3, 5), 1)
    jidx, jcodes, jloss = (np.asarray(a) for a in jq(jnp.asarray(z)))
    idx, codes, loss = q(torch.from_numpy(z))
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    assert idx.dtype == torch.int32 and loss.shape == jloss.shape == (2, 1, 1, 1)
    np.testing.assert_array_equal(q.indices_to_codes(idx).numpy(),
                                  np.asarray(jq.indices_to_codes(jnp.asarray(jidx))))
    # the bound itself differs by tanh's last bit
    _close(q.bound(torch.from_numpy(z)), np.asarray(jq.bound(jnp.asarray(z))))


@pytest.mark.parametrize("levels", [1, 2])
def test_fsq_haar_matches_jax_and_round_trips(levels):
    x = np.random.default_rng(2).standard_normal((2, 8, 8, 12, 3)).astype(np.float32)
    ref = np.asarray(jfsq.haar_patch_3d(jnp.asarray(x), levels))
    got = tfsq.haar_patch_3d(torch.from_numpy(x), levels)
    _close(got, ref)
    _close(tfsq.haar_unpatch_3d(got, levels), np.asarray(jfsq.haar_unpatch_3d(jnp.asarray(ref),
                                                                              levels)))
    _close(tfsq.haar_unpatch_3d(got, levels), x)


def test_reflect_tail_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 5, 3, 7)).astype(np.float32)
    for axis in (1, 3):
        np.testing.assert_array_equal(tdv._reflect_tail(torch.from_numpy(x), axis).numpy(),
                                      np.asarray(jdv._reflect_tail(jnp.asarray(x), axis)))


# ---------------------------------------------------------------- tokenizers


@pytest.fixture(scope="module")
def fsq_pair():
    """JAX's tiny FSQ tokenizer (its own init) and the port's on the same
    weights."""
    cfg = jfsq.TokenizerConfig.tiny()
    jmod = jfsq.CausalDiscreteVideoTokenizer(cfg)
    params = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8, 3)))
    mod = tfsq.CausalDiscreteVideoTokenizer(tfsq.TokenizerConfig.tiny())
    mod.load_state_dict(tfsq.from_flax(jax.tree.map(np.asarray, params)))
    return mod.eval().requires_grad_(False), jmod, params


def _tie_free(zb: np.ndarray, tol: float = 1e-3) -> np.ndarray:
    """Positions (all channels of a latent) whose bounded values are more
    than tol from a rounding boundary."""
    return (np.abs(np.abs(zb - np.floor(zb)) - 0.5) > tol).all(-1)


def test_fsq_tokenizer_matches_jax(fsq_pair):
    mod, jmod, params = fsq_pair
    video = np.random.default_rng(4).uniform(0, 1, (2, 4, 16, 16, 3)).astype(np.float32)
    jidx, jq = (np.array(a) for a in jmod.apply(params, jnp.asarray(video),
                                                   method=jfsq.CausalDiscreteVideoTokenizer.encode))
    with torch.inference_mode():
        idx, q = mod.encode(torch.from_numpy(video))
        x = tfsq.haar_patch_3d(torch.from_numpy(video), 1).movedim(-1, 1)
        h = mod.enc_blocks_0(mod.enc_in(x))
        zb = mod.quantizer.bound(mod.enc_out(h.movedim(1, -1))).numpy()
    keep = _tie_free(zb)
    assert keep.mean() > 0.9
    np.testing.assert_array_equal(idx.numpy()[keep], jidx[keep])
    np.testing.assert_array_equal(q.numpy()[keep], jq[keep])
    jrec = np.asarray(jmod.apply(params, jnp.asarray(jidx),
                                 method=jfsq.CausalDiscreteVideoTokenizer.decode_indices))
    with torch.inference_mode():
        _close(mod.decode_indices(torch.from_numpy(jidx.copy())), jrec)
    assert jrec.shape == video.shape


@pytest.fixture(scope="module")
def dv_pair():
    """The port's tiny DV tokenizer with drawn weights, biases and norms,
    and JAX's on its Cosmos-layout state dict."""
    module = tdv.CausalDiscreteVideoTokenizer(tdv.DVTokenizerConfig.tiny())
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.05, generator=gen)
            elif p.dim() == 1:
                p.normal_(1.0, 0.1, generator=gen)
            else:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
    module.eval().requires_grad_(False)
    jmodule = jdv.CausalDiscreteVideoTokenizer(jdv.DVTokenizerConfig.tiny())
    return module, jmodule, jconvert_dv(tcdv.reference_state_dict(module))


def test_dv_tokenizer_matches_jax(dv_pair):
    """Encode 9 frames at 32 x 32 (3 latent frames of 4 x 4), decode JAX's
    indices and JAX's codes."""
    module, jmodule, params = dv_pair
    video = np.random.default_rng(5).uniform(-1, 1, (1, 9, 32, 32, 3)).astype(np.float32)
    jidx, jq, _ = (np.array(a) for a in jmodule.apply(
        params, jnp.asarray(video), method=jdv.CausalDiscreteVideoTokenizer.encode))
    with torch.inference_mode():
        idx, q, loss = module.encode(torch.from_numpy(video))
        h = module.quant_conv(module.encoder(torch.from_numpy(video)))
        zb = module.quantizer.bound(h.permute(0, 2, 3, 4, 1)).numpy()
    assert jidx.shape == (1, 3, 4, 4) and jq.shape == (1, 3, 4, 4, 6)
    keep = _tie_free(zb)
    assert keep.mean() > 0.9
    np.testing.assert_array_equal(idx.numpy()[keep], jidx[keep])
    np.testing.assert_array_equal(q.numpy()[keep], jq[keep])
    jrec = np.asarray(jmodule.apply(params, jnp.asarray(jidx),
                                    method=jdv.CausalDiscreteVideoTokenizer.decode_indices))
    with torch.inference_mode():
        _close(module.decode_indices(torch.from_numpy(jidx)), jrec)
        _close(module.decode(torch.from_numpy(jq)), jrec)
        rec, idx2, _ = module(torch.from_numpy(video))
    assert rec.shape == video.shape and torch.equal(idx2, idx)


def test_dv_chunked_wrapper(dv_pair):
    """Two 9-frame chunks in batches of one: each chunk as the module's
    own encode / decode, and JAX's wrapper's indices."""
    module, jmodule, params = dv_pair
    video = torch.from_numpy(np.random.default_rng(6).uniform(
        -1, 1, (1, 18, 32, 32, 3)).astype(np.float32))
    tok = tdv.DiscreteVideoFSQTokenizer(module, pixel_chunk_duration=9,
                                        compression_ratio=(4, 8, 8), max_enc_batch_size=1,
                                        max_dec_batch_size=1)
    q, idx = tok.encode(video)
    assert q.shape == (1, 6, 4, 4, 6) and idx.shape == (1, 6, 4, 4)
    with torch.inference_mode():
        for c in range(2):
            ci, cq, _ = module.encode(video[:, 9 * c: 9 * c + 9])
            _close(q[:, 3 * c: 3 * c + 3], cq.numpy())
            np.testing.assert_array_equal(idx[:, 3 * c: 3 * c + 3].numpy(), ci.numpy())
        rec = tok.decode(idx)
        _close(rec[:, 9:], module.decode_indices(idx[:, 3:]).numpy())
    assert rec.shape == video.shape
    jtok = jdv.DiscreteVideoFSQTokenizer(jmodule, params, pixel_chunk_duration=9,
                                         compression_ratio=(4, 8, 8), max_enc_batch_size=1)
    jqq, jidx = jtok.encode(jnp.asarray(video.numpy()))
    assert (np.asarray(jidx) == idx.numpy()).mean() > 0.9
    _close(rec, np.asarray(jtok.decode(jnp.asarray(idx.numpy()))))


# ---------------------------------------------------------------- AR configs


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"}


def test_ar_config_factories_match_jax():
    assert tarc._ARCHS == jarc._ARCHS
    pairs = [(tarc.create_text_model_config(), jarc.create_text_model_config()),
             (tarc.create_text_model_config("llama3", "8b", 2048, norm_eps=1e-6),
              jarc.create_text_model_config("llama3", "8b", 2048, norm_eps=1e-6)),
             (tarc.create_vision_language_model_config(),
              jarc.create_vision_language_model_config())]
    pairs += [(tarc.create_video2world_model_config(s), jarc.create_video2world_model_config(s))
              for s in ("4b", "5b", "12b", "13b")]
    for t, j in pairs:
        assert _fields(t) == _fields(j)
        assert t.dtype == torch.float32 and j.dtype == jnp.float32
    v2w = tarc.create_video2world_model_config("5b")
    assert (v2w.dim, v2w.n_layers, v2w.vocab_size, v2w.max_seq_len) == (3072, 16, 64064, 12864)
    assert v2w.cross_attn_layers == (0, 4, 8, 12) and v2w.cross_dim == 1024
    with pytest.raises(KeyError):
        tarc.create_text_model_config("nope", "1b")


def test_discrete_multimodal_tokenizer_matches_jax(fsq_pair):
    mod, jmod, params = fsq_pair
    video = np.random.default_rng(7).uniform(0, 1, (1, 4, 8, 8, 3)).astype(np.float32)
    tok = tarc.DiscreteMultimodalTokenizer(mod, text_vocab_size=1000)
    jtok = jarc.DiscreteMultimodalTokenizer(jmod, params, text_vocab_size=1000)
    ids, jids = tok.tokenize_video(video), jtok.tokenize_video(video)
    np.testing.assert_array_equal(ids, jids)
    assert ids[0, 0] == 64000 + 1000 and ids[0, -1] == 64001 + 1000 and ids.dtype == np.int64
    _close(tok.detokenize_video(ids, (2, 4, 4)), jtok.detokenize_video(jids, (2, 4, 4)))


class _StubHFTokenizer:
    """What the wrappers call of a HF tokenizer, for a checkpoint-free test."""

    bos_token_id = 1

    def __call__(self, text, add_special_tokens=False):
        return {"input_ids": [3 + zlib.crc32(w.encode()) % 500 for w in text.split()]}

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)

    def apply_chat_template(self, dialog, add_generation_prompt=True, return_tensors="np"):
        return np.asarray([[len(d["content"]) for d in dialog] + [int(add_generation_prompt)]])


def test_text_tokenizer_wrappers_match_jax(monkeypatch, tmp_path):
    import transformers

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        staticmethod(lambda path: _StubHFTokenizer()))
    dialog = [{"role": "user", "content": "a robot arm"}]
    for t, j in ((tarc.TextTokenizer(tmp_path), jarc.TextTokenizer(tmp_path)),
                 (tarc.ImageTextTokenizer(tmp_path, max_image_size=64),
                  jarc.ImageTextTokenizer(tmp_path, max_image_size=64))):
        assert t.encode("stack the blocks") == j.encode("stack the blocks")
        assert t.decode([5, 6]) == j.decode([5, 6])
        np.testing.assert_array_equal(t.apply_chat_template(dialog), j.apply_chat_template(dialog))
    img = np.random.default_rng(16).uniform(0, 1, (100, 150, 3)).astype(np.float32)
    (ids, im), (jids, jim) = (t.encode_dialog_with_image("describe it", img),
                              j.encode_dialog_with_image("describe it", img))
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(im, jim)
    assert im.shape == (1, 32, 64, 3) and ids.shape[1] == 1 + 8 + 2


# ---------------------------------------------------------------- the AR pipeline


def _jax_gumbel_draws(seed: int, steps: int, shape) -> list[np.ndarray]:
    """JAX's ARGenerator's per-step Gumbel noise at PRNGKey(seed)."""
    key, sub = jax.random.split(jax.random.PRNGKey(seed))
    keys = [sub] + list(jax.random.split(key, steps - 1))
    return [np.array(jax.random.gumbel(k, shape, jnp.float32)) for k in keys]


def test_ar_video2world_pipeline_matches_jax(fsq_pair):
    """The tiny FSQ tokenizer and a tiny AR (vocab 200 > 125 codes): 16
    tokens generated after 32 context tokens (one latent frame more), the
    same tokens with JAX's draws, the video within 1e-5."""
    mod, jmod, params = fsq_pair
    video = np.random.default_rng(0).uniform(size=(1, 4, 8, 8, 3)).astype(np.float32)
    acfg = jar.ARConfig.tiny(vocab_size=200)
    jmodel = jar.Transformer(acfg)
    aparams = jmodel.init(jax.random.PRNGKey(1), tokens=jnp.zeros((1, 8), jnp.int32))
    jpipeline = jpipe.ARVideo2WorldPipeline(generator=jar.ARGenerator(jmodel, aparams, acfg),
                                            video_tokenizer=jmod, tokenizer_params=params,
                                            max_gen_tokens=16)
    model = tar.Transformer(tar.ARConfig.tiny(vocab_size=200))
    model.load_state_dict(bridge.flax_to_state_dict(jax.tree.map(np.asarray, aparams)))
    pipeline = tpipe.ARVideo2WorldPipeline(generator=tar.ARGenerator(model.eval()),
                                           video_tokenizer=mod, max_gen_tokens=16)
    jout = jpipeline(video, seed=3)
    draws = [torch.from_numpy(g) for g in _jax_gumbel_draws(3, 16, (1, 200))]
    out = pipeline(video, seed=3, gumbel=draws)
    assert out.shape == jout.shape == (1, 6, 8, 8, 3)
    jidx = np.asarray(jmod.apply(params, jnp.asarray(video),
                                 method=jfsq.CausalDiscreteVideoTokenizer.encode)[0])
    np.testing.assert_array_equal(pipeline.tokens[:, :2], jidx)
    _close(out, jout)
    assert set(pipeline.stage_times) >= {"encode", "generate", "decode", "prefill_s"}
    # the guardrail gate, and a decoder hook applied to the pixels
    from tclight_torch.cosmos.guardrails import presets_text

    pipeline.text_guardrail = presets_text(device="cpu")
    assert pipeline(video, prompt="graphic gore footage") is None
    pipeline.diffusion_decoder = lambda v: v * 0 + 0.5
    assert np.all(pipeline(video, prompt="a calm lake", gumbel=draws) == 0.5)


# ---------------------------------------------------------------- T5


def _t5_hf_state_dict(cfg, seed: int) -> dict:
    """A HF T5EncoderModel-layout state dict of `cfg`'s widths, drawn from
    seed."""
    rng = np.random.default_rng(seed)
    inner = cfg.n_heads * cfg.d_kv

    def w(*shape, scale=None):
        return (rng.standard_normal(shape) * (scale or shape[-1] ** -0.5)).astype(np.float32)

    sd = {"shared.weight": w(cfg.vocab_size, cfg.d_model, scale=1.0),
          "encoder.final_layer_norm.weight": 1 + 0.1 * w(cfg.d_model, scale=1.0)}
    for i in range(cfg.n_layers):
        r = f"encoder.block.{i}.layer."
        for n in ("q", "k", "v"):
            sd[f"{r}0.SelfAttention.{n}.weight"] = w(inner, cfg.d_model)
        sd[f"{r}0.SelfAttention.o.weight"] = w(cfg.d_model, inner)
        if i == 0:
            sd[f"{r}0.SelfAttention.relative_attention_bias.weight"] = w(
                cfg.rel_buckets, cfg.n_heads, scale=1.0)
        sd[f"{r}0.layer_norm.weight"] = 1 + 0.1 * w(cfg.d_model, scale=1.0)
        for n in (("wi_0", "wi_1") if cfg.gated_ff else ("wi",)):
            sd[f"{r}1.DenseReluDense.{n}.weight"] = w(cfg.d_ff, cfg.d_model)
        sd[f"{r}1.DenseReluDense.wo.weight"] = w(cfg.d_model, cfg.d_ff)
        sd[f"{r}1.layer_norm.weight"] = 1 + 0.1 * w(cfg.d_model, scale=1.0)
    return sd


@pytest.mark.parametrize("gated", [False, True])
def test_t5_encoder_matches_jax(gated):
    """40 tokens (relative distances past the exact buckets), the last 7 of
    the second row padded."""
    jcfg = dataclasses.replace(jt5e.T5Config.tiny(), gated_ff=gated)
    cfg = dataclasses.replace(tt5e.T5Config.tiny(), gated_ff=gated)
    sd = _t5_hf_state_dict(cfg, 8 + gated)
    rng = np.random.default_rng(9)
    ids = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    mask = np.ones((2, 40), np.int32)
    mask[1, 33:] = 0
    ref = np.asarray(jt5e.T5Encoder(jcfg).apply({"params": jt5e.convert_t5_encoder(sd, jcfg)},
                                                jnp.asarray(ids), jnp.asarray(mask)))
    model = tt5e.T5Encoder(cfg)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in
                           tt5e.convert_t5_encoder(sd, cfg).items()})
    with torch.inference_mode():
        out = model(torch.from_numpy(ids), torch.from_numpy(mask))
    _close(out, ref)
    assert (out[1, 33:] == 0).all()
    rel = np.arange(40)[None, :] - np.arange(40)[:, None]
    np.testing.assert_array_equal(
        tt5e.relative_position_bucket(torch.from_numpy(rel), 32, 128).numpy(),
        np.asarray(jt5e._rel_bucket(jnp.asarray(rel), 32, 128)))


class _IdTokenizer:
    """A stand-in tokenizer: a word's crc32 as its id, padded with 0."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def __call__(self, prompts, padding, truncation, max_length, return_tensors):
        ids = np.zeros((len(prompts), max_length), np.int64)
        mask = np.zeros_like(ids)
        for i, p in enumerate(prompts):
            words = [1 + zlib.crc32(w.encode()) % (self.vocab - 1) for w in p.split()]
            ids[i, :len(words)], mask[i, :len(words)] = words[:max_length], 1
        return {"input_ids": ids, "attention_mask": mask}


def test_t5_text_encoder_reads_a_checkpoint_dir(tmp_path):
    """The port's safetensors and config.json in a directory: the features
    equal T5Encoder's on the same ids, padded positions zero."""
    cfg = tt5e.T5Config.tiny()
    sd = _t5_hf_state_dict(cfg, 10)
    write_safetensors({k: torch.from_numpy(v) for k, v in sd.items()},
                      tmp_path / "model.safetensors")
    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": cfg.vocab_size, "d_model": cfg.d_model, "d_kv": cfg.d_kv,
        "d_ff": cfg.d_ff, "num_layers": cfg.n_layers, "num_heads": cfg.n_heads,
        "feed_forward_proj": "relu"}))
    enc = tt5.T5TextEncoder(tmp_path, max_length=16, tokenizer=_IdTokenizer(cfg.vocab_size),
                            device="cpu")
    assert enc.cfg == cfg
    emb, mask = enc.encode_prompts(["a robot arm", "stacks wooden blocks on a table"])
    assert emb.shape == (2, 16, cfg.d_model) and mask.sum(1).tolist() == [3, 6]
    ids = _IdTokenizer(cfg.vocab_size)(["a robot arm"], None, None, 16, None)
    ref = np.asarray(jt5e.T5Encoder(jt5e.T5Config.tiny()).apply(
        {"params": jt5e.convert_t5_encoder(sd, jt5e.T5Config.tiny())},
        jnp.asarray(ids["input_ids"], jnp.int32), jnp.asarray(ids["attention_mask"], jnp.int32)))
    _close(emb[:1], ref)
    assert (emb[0, 3:] == 0).all()


# ---------------------------------------------------------------- the diffusion decoder


def _dd_pair(seed=0, condition_on_sigma=False, **overrides):
    """The port's decoder DiT with drawn weights (gates and the token table
    non-zero), and JAX's on its reference-layout state dict."""
    base = dict(in_channels=4, out_channels=4, context_dim=32, **overrides)
    net = tdd.DiffusionDecoderGeneralDIT(TDiTConfig.tiny(**base), token_vocab=64, token_dim=8,
                                         condition_on_sigma=condition_on_sigma)
    gen = torch.Generator().manual_seed(seed)
    init_dit_(net, gen)
    with torch.no_grad():
        net.token_embedder.weight.normal_(0.0, 1.0, generator=gen)
    net.eval().requires_grad_(False)
    jnet = jdd.DiffusionDecoderGeneralDIT(dataclasses.replace(JDiTConfig.tiny(), **base),
                                          token_vocab=64, token_dim=8,
                                          condition_on_sigma=condition_on_sigma)
    return net, jnet, jconvert_dd(tcdit.reference_state_dict(net))


@pytest.mark.parametrize("sigma", [False, True])
def test_decoder_dit_matches_jax(sigma):
    """4 x 24 x 24 latents (576 tokens: the flash path, K1's plain version
    here) conditioned on a 4 x 6 x 6 token grid."""
    net, jnet, params = _dd_pair(condition_on_sigma=sigma, max_img_h=32, max_img_w=32)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 4, 24, 24, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 6, 32)).astype(np.float32)
    toks = rng.integers(0, 64, (1, 4, 6, 6)).astype(np.int32)
    t, s = np.array([0.3], np.float32), np.array([-1.2], np.float32)
    ref = np.asarray(jnet.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                                latent_condition=jnp.asarray(toks),
                                latent_condition_sigma=jnp.asarray(s)))
    with torch.inference_mode():
        out = net(*(torch.from_numpy(a) for a in (x, t, ctx)),
                  latent_condition=torch.from_numpy(toks),
                  latent_condition_sigma=torch.from_numpy(s))
        other = net(*(torch.from_numpy(a) for a in (x, t, ctx)),
                    latent_condition=torch.from_numpy((toks + 1) % 64),
                    latent_condition_sigma=torch.from_numpy(s))
    _close(out, ref)
    assert (out - other).abs().max() > 1e-3  # the tokens move it
    sd = tcdit.reference_state_dict(net)
    assert "token_embedder.weight" in sd
    assert set(tcdit.convert_diffusion_decoder_dit(sd, net)) == set(net.state_dict())


def test_split_and_blend_match_jax():
    v = np.random.default_rng(12).standard_normal((1, 2, 11, 3, 4)).astype(np.float32)
    for n, overlap in ((5, 2), (4, 1), (11, 3)):
        chunks, jchunks = (tdd.split_with_overlap(v, n, overlap),
                           jdd.split_with_overlap(v, n, overlap))
        assert len(chunks) == len(jchunks)
        for a, b in zip(chunks, jchunks):
            np.testing.assert_array_equal(a, b)
        if len(chunks) > 1:
            np.testing.assert_array_equal(tdd.linear_blend_video_list(chunks, overlap),
                                          jdd.linear_blend_video_list(jchunks, overlap))
    assert tdd.DiffusionDecoderSamplingConfig() == tdd.DiffusionDecoderSamplingConfig(
        **dataclasses.asdict(jdd.DiffusionDecoderSamplingConfig()))


def _decode_fn(latents):
    """Latents (B, T, H, W, C) -> pixels (B, 3, 1 + 8 (T - 1), 8H, 8W): the
    first 3 channels' tanh, each later latent frame 8 times."""
    z = np.tanh(np.asarray(latents)[..., :3]).transpose(0, 4, 1, 2, 3)
    z = np.concatenate([z[:, :, :1], np.repeat(z[:, :, 1:], 8, axis=2)], axis=2)
    return np.repeat(np.repeat(z, 8, axis=3), 8, axis=4)


def _jax_dd_draws(seed: int, shape):
    """JAX's LatentDiffusionDecoder draws at PRNGKey(seed): the noise from
    the first split key, the condition's uniform from the second's first."""
    noise_key, cond_key = jax.random.split(jax.random.PRNGKey(seed))
    sig_key, _ = jax.random.split(cond_key)
    return (np.array(jax.random.normal(noise_key, shape)),
            np.array(jax.random.uniform(sig_key, shape[:1])))


def test_diffusion_decoder_process_tokens_matches_jax():
    """A 5-frame token stream (4 x 4 tokens) in two overlapping chunks of 3
    latent frames (overlap 1), 8 x 8 x 4 latents, 4 RES 2ab steps, a T5
    context; JAX's draws injected."""
    dec = tdd.build_tiny_decoder(seed=1, latent_channels=4, context_dim=32, token_vocab=64)
    jnet = jdd.DiffusionDecoderGeneralDIT(
        dataclasses.replace(JDiTConfig.tiny(), in_channels=4, out_channels=4, context_dim=32),
        token_vocab=64, token_dim=8)
    jdec = jdd.LatentDiffusionDecoder(jnet, jconvert_dd(tcdit.reference_state_dict(dec.network)),
                                      n_steps=4)
    dec.draws = _jax_dd_draws
    rng = np.random.default_rng(13)
    tokens = rng.integers(0, 64, (5, 4, 4)).astype(np.int32)
    ctx = rng.standard_normal((6, 32)).astype(np.float32)
    cfg = tdd.DiffusionDecoderSamplingConfig(dd_train_num_video_frames=17, overlap=1,
                                             continuous_tokenizer_channel=4)
    jcfg = jdd.DiffusionDecoderSamplingConfig(dd_train_num_video_frames=17, overlap=1,
                                              continuous_tokenizer_channel=4)
    # one chunk's latents
    lat = dec(torch.from_numpy(tokens[None, :3]), torch.from_numpy(ctx[None]), (3, 8, 8, 4),
              seed=4)
    jlat = np.asarray(jdec(jnp.asarray(tokens[None, :3]), jnp.asarray(ctx[None]), (3, 8, 8, 4),
                           seed=4))
    _close(lat, jlat, 1e-4)
    out = tdd.diffusion_decoder_process_tokens(dec, [tokens], _decode_fn, 64, 64, cfg,
                                               t5_emb_batch=[ctx], context_dim=32, seed=2)
    jout = jdd.diffusion_decoder_process_tokens(jdec, [tokens], _decode_fn, 64, 64, jcfg,
                                                t5_emb_batch=[ctx], context_dim=32, seed=2)
    assert len(out) == 1 and out[0].shape == jout[0].shape == (3, 26, 64, 64)
    _close(out[0], jout[0], 1e-4)
    assert 0.0 <= out[0].min() and out[0].max() <= 1.0


# ---------------------------------------------------------------- the lazy config


def test_lazy_config_roundtrip_matches_jax():
    spec = tlazy.L(dict)(a=1, b=tlazy.L(list)(), c={"d": tlazy.L("builtins.tuple")()})
    jspec = jlazy.L(dict)(a=1, b=jlazy.L(list)(), c={"d": jlazy.L("builtins.tuple")()})
    assert spec == jspec and spec["_target_"] == "builtins.dict"
    # a ConfigDict keeps sequences as lists, in both packages
    assert tlazy.instantiate(spec) == jlazy.instantiate(jspec) == {"a": 1, "b": [], "c": {"d": []}}
    assert tlazy.locate("tclight_torch.cosmos.dit.DiTConfig") is TDiTConfig
    assert tlazy.locate("tclight_torch.cosmos.dit.DiTConfig.tiny") is TDiTConfig.tiny
    with pytest.raises(ImportError):
        tlazy.locate("tclight_torch.nope.Nothing")
    assert isinstance(tlazy.instantiate({"x": [tlazy.L(dict)(y=2)]}), tconfig.ConfigDict)


def test_lazy_override_and_freeze_match_jax():
    for cd, lazy in ((tconfig.ConfigDict, tlazy), (jconfig.ConfigDict, jlazy)):
        cfg = cd({"model": {"dim": 64}, "lr": 0.1})
        lazy.override(cfg, "model.dim=128", "lr=0.2", "model.name=tiny", "model.on=true")
        assert cfg.model.dim == 128 and cfg.lr == 0.2
        assert cfg.model.name == "tiny" and cfg.model.on is True
        with pytest.raises(KeyError):
            lazy.override(cfg, "nope.deep.path=1")
        with pytest.raises(ValueError):
            lazy.override(cfg, "lr")
        lazy.freeze(cfg)
        with pytest.raises(TypeError):
            cfg["lr"] = 0.5
        with pytest.raises(TypeError):
            cfg.model["dim"] = 1
        lazy.unfreeze(cfg)
        cfg["lr"] = 0.5
        cfg.model["dim"] = 1
        assert cfg.lr == 0.5 and cfg.model.dim == 1 and type(cfg.model) is cd


# ---------------------------------------------------------------- the reference's limits (C12)


def test_ar_pipeline_needs_a_two_value_tokenizer(dv_pair):
    """Both packages' pipelines unpack (indices, codes) from `encode`; the
    DV tokenizer's encode gives three values, so it is refused as it is and
    runs through a two-value adapter."""
    module, jmodule, params = dv_pair
    video = np.random.default_rng(14).uniform(-1, 1, (1, 9, 32, 32, 3)).astype(np.float32)
    acfg = jar.ARConfig.tiny(vocab_size=64064)
    jmodel = jar.Transformer(acfg)
    aparams = jmodel.init(jax.random.PRNGKey(2), tokens=jnp.zeros((1, 8), jnp.int32))
    jpipeline = jpipe.ARVideo2WorldPipeline(jar.ARGenerator(jmodel, aparams, acfg), jmodule,
                                            params, max_gen_tokens=16)
    with pytest.raises(ValueError, match="unpack"):
        jpipeline(video)
    model = tar.Transformer(tar.ARConfig.tiny(vocab_size=64064))
    model.load_state_dict(bridge.flax_to_state_dict(jax.tree.map(np.asarray, aparams)))
    pipeline = tpipe.ARVideo2WorldPipeline(tar.ARGenerator(model.eval()), module,
                                           max_gen_tokens=16)
    with pytest.raises(ValueError, match="unpack"):
        pipeline(video)

    class TwoValues(torch.nn.Module):
        def __init__(self, dv):
            super().__init__()
            self.dv = dv

        def encode(self, v):
            return self.dv.encode(v)[:2]

        def decode_indices(self, idx):
            return self.dv.decode_indices(idx)

    pipeline.video_tokenizer = TwoValues(module)
    out = pipeline(video, seed=1)
    assert out.shape == (1, 13, 32, 32, 3) and pipeline.tokens.shape == (1, 4, 4, 4)


def test_video2world_config_has_no_cross_attention():
    """`cross_attn_layers` / `cross_dim` name T5 cross-attention that no
    module builds: JAX's parameter tree (and the port's state dict) is the
    same with or without them."""
    cfg = jar.ARConfig.tiny()
    hooked = dataclasses.replace(cfg, cross_attn_layers=(0,), cross_dim=32)
    trees = [jax.tree.map(np.shape, jar.Transformer(c).init(
        jax.random.PRNGKey(0), tokens=jnp.zeros((1, 4), jnp.int32))) for c in (cfg, hooked)]
    assert trees[0] == trees[1]
    tcfg = tar.ARConfig.tiny()
    keys = [set(tar.Transformer(c).state_dict()) for c in
            (tcfg, dataclasses.replace(tcfg, cross_attn_layers=(0,), cross_dim=32))]
    assert keys[0] == keys[1]


def test_decoder_window_needs_five_latent_frames():
    """An 8-frame window reflect-pads by at most T - 1 frames: a 3-frame
    token grid gives a 5-frame chunk in both packages (too short for the
    window), a 5-frame grid an 8-frame one."""
    for t, n in ((3, 5), (5, 8)):
        v = np.arange(t, dtype=np.int32).reshape(1, 1, t, 1, 1)
        (chunk,), (jchunk,) = tdd.split_with_overlap(v, 8, 2), jdd.split_with_overlap(v, 8, 2)
        np.testing.assert_array_equal(chunk, jchunk)
        assert chunk.shape[2] == n



# ---------------------------------------------------------------- the bridges


def test_t5_and_decoder_bridges_map_jax_trees():
    """JAX's own init of T5 and of the decoder DiT (its gates and token
    table drawn), through the port's bridges: the same outputs (1e-5)."""
    rng = np.random.default_rng(15)
    ids = jnp.asarray(rng.integers(0, 128, (1, 12)), jnp.int32)
    jm = jt5e.T5Encoder(jt5e.T5Config.tiny())
    params = jm.init(jax.random.PRNGKey(0), ids)
    m = tt5e.T5Encoder(tt5e.T5Config.tiny())
    m.load_state_dict(bridge.t5_encoder_state_dict(jax.tree.map(np.asarray, params)))
    with torch.inference_mode():
        _close(m(torch.from_numpy(np.array(ids))), np.asarray(jm.apply(params, ids)))
    cfg = dict(in_channels=4, out_channels=4, context_dim=32)
    jnet = jdd.DiffusionDecoderGeneralDIT(dataclasses.replace(JDiTConfig.tiny(), **cfg),
                                          token_vocab=64, token_dim=8)
    x = rng.standard_normal((1, 2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 5, 32)).astype(np.float32)
    toks = rng.integers(0, 64, (1, 2, 4, 4)).astype(np.int32)
    params = jnet.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray([0.2]),
                       jnp.asarray(ctx), latent_condition=jnp.asarray(toks))
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(
        np.float32), params)
    net = tdd.DiffusionDecoderGeneralDIT(TDiTConfig.tiny(**cfg), token_vocab=64, token_dim=8)
    net.load_state_dict(bridge.diffusion_decoder_state_dict(params))
    ref = jnet.apply(params, jnp.asarray(x), jnp.asarray([0.2]), jnp.asarray(ctx),
                     latent_condition=jnp.asarray(toks))
    with torch.inference_mode():
        out = net(torch.from_numpy(x), torch.tensor([0.2]), torch.from_numpy(ctx),
                  latent_condition=torch.from_numpy(toks))
    _close(out, np.asarray(ref))
