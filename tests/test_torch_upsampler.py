"""The port's prompt upsampler (models/rope.py, ar_transformer.py,
convert_ar.py, pixtral.py and the Generator's hook) against the JAX
package's, on the same weights (JAX's trees through
`bridge.vlm_state_dicts`) and inputs, on the CPU in f32.

- Every RoPE table (v1 / v2, 1D / 2D / 3D, YaRN, a begin-of-video token,
  padding) equal to JAX's, and their application within 1e-6 (f32
  products of the same tables).
- The tiny decoder's logits, a full forward and a prefill + decode
  against the static cache, within 1e-4 (f32 sums in another order:
  measured ~3e-6); greedy tokens equal.
- Nucleus sampling: the kept set equal, and the tokens equal when the port
  is handed JAX's Gumbel draw (`jax.random.categorical` is argmax(logits
  + gumbel)).
- The tiny VLM: ViT features, projector and `embed_vision_language`
  within 1e-4; `chat_completion`'s tokens equal (greedy, and at
  temperature 0.5 with JAX's draws).
- `load_vlm` on a cosmos-native `model.pt` and on HF-keyed safetensors
  written under tmp_path: the port's converters give the state dicts of
  JAX's converters, and both packages' loaded VLMs agree within 1e-4; a
  bf16 checkpoint loads into a bf16 decoder unchanged.
- Both packages' `Generator._handle_missing_prompt` on the same tiny VLM
  (`load_vlm` monkeypatched in each) and an offline HF tokenizer give the
  same prompt string; `python -m tclight_torch.run` without a prompt runs
  on the upsampled one and saves it in config.yaml.
"""

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclight_torch.models import ar_transformer as ar
from tclight_torch.models import bridge, convert_ar, pixtral, rope
from tclight_torch.models.convert import write_safetensors
from tclight_tpu.models import ar_transformer as jar
from tclight_tpu.models import pixtral as jpx
from tclight_tpu.models import rope as jrope
from tclight_tpu.pipeline.iclight import DummyTokenizer as JDummyTokenizer

torch.set_num_threads(2)

ROPE_TOL = 1e-6
TOL = 1e-4

ROPE_SPECS = {
    "v1_1d": (dict(variant="v1", rope_dim="1D", theta=10000.0, max_position_embeddings=64), 32),
    "v2_1d": (dict(variant="v2", rope_dim="1D", theta=500000.0, max_position_embeddings=64), 32),
    "v1_1d_yarn": (dict(variant="v1", rope_dim="1D", theta=10000.0, max_position_embeddings=64,
                        original_max_position_embeddings=16, apply_yarn=True, scale=4.0,
                        attn_factor=1, beta_fast=32, beta_slow=1), 32),
    "v1_2d": (dict(variant="v1", rope_dim="2D", latent_shape=(4, 6)), 32),
    "v2_2d_yarn": (dict(variant="v2", rope_dim="2D", latent_shape=(4, 6), apply_yarn=True,
                        scale=2.0, original_latent_shape=(2, 3)), 32),
    "v1_3d_bov_pad": (dict(variant="v1", rope_dim="3D", latent_shape=(2, 3, 4),
                           prepend_bov=True, pad_to_multiple_of=8), 36),
    "v2_3d_yarn": (dict(variant="v2", rope_dim="3D", latent_shape=(2, 3, 4), apply_yarn=True,
                        scale=2.0, original_latent_shape=(1, 2, 2)), 48),
}


@pytest.mark.parametrize("name", sorted(ROPE_SPECS))
def test_rope_tables_and_application_match_jax(name):
    kw, head_dim = ROPE_SPECS[name]
    table = rope.build_rope_tables(rope.RopeSpec(**kw), head_dim)
    jtable = jrope.build_rope_tables(jrope.RopeSpec(**kw), head_dim)
    np.testing.assert_array_equal(table, jtable)
    rng = np.random.default_rng(1)
    # wider than the table for one case: the extra dims pass through
    d = head_dim + (4 if name == "v1_2d" else 0)
    x = rng.standard_normal((2, 5, 3, d)).astype(np.float32)
    pos = rng.integers(0, table.shape[0], (5,))
    for positions in (pos, np.stack([pos, pos[::-1]])):
        out = rope.apply_rope_tables(torch.from_numpy(x), torch.from_numpy(table),
                                     torch.from_numpy(positions), kw["variant"])
        ref = jrope.apply_rope_tables(jnp.asarray(x), jnp.asarray(jtable),
                                      jnp.asarray(positions), kw["variant"])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ROPE_TOL, rtol=0)
    assert rope.yarn_mscale(4.0, 2) == jrope.yarn_mscale(4.0, 2)


def _jax_text(cfg=None, seed=0):
    cfg = cfg or jar.ARConfig.tiny()
    model = jar.Transformer(cfg)
    params = model.init(jax.random.PRNGKey(seed), tokens=jnp.zeros((1, 8), jnp.int32))
    return model, params, cfg


def _port_text(params, cfg=None):
    with torch.device("cpu"):
        model = ar.Transformer(cfg or ar.ARConfig.tiny())
    model.load_state_dict(bridge.flax_to_state_dict(params))
    return model.eval().requires_grad_(False)


def test_transformer_forward_and_cache_decode_match_jax():
    jmodel, jparams, jcfg = _jax_text()
    model = _port_text(jparams)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12))
    logits, caches = model(tokens=torch.from_numpy(toks))
    jlogits, _ = jmodel.apply(jparams, tokens=jnp.asarray(toks))
    assert caches == [None, None]
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL, rtol=0)
    # prefill into the static cache, then three single-token steps
    jcaches = jar.init_cache(jcfg, 2)
    caches = ar.init_cache(model.cfg, 2)
    jl, jcaches = jmodel.apply(jparams, tokens=jnp.asarray(toks), caches=jcaches, cur_len=0)
    pl, caches = model(tokens=torch.from_numpy(toks), caches=caches, cur_len=0)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    for pos in range(12, 15):
        nt = rng.integers(0, jcfg.vocab_size, (2, 1))
        jl, jcaches = jmodel.apply(jparams, tokens=jnp.asarray(nt), caches=jcaches,
                                   cur_len=pos, positions=jnp.asarray([pos]))
        pl, caches = model(tokens=torch.from_numpy(nt), caches=caches, cur_len=pos,
                           positions=torch.tensor([pos]))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    np.testing.assert_allclose(caches[1].k.numpy(), np.asarray(jcaches[1].k), atol=TOL, rtol=0)


def test_greedy_generation_matches_jax_and_a_cacheless_recompute():
    """Greedy tokens equal JAX's, and equal those of recomputing the whole
    sequence without the cache at every step."""
    jmodel, jparams, jcfg = _jax_text()
    model = _port_text(jparams)
    prompt = np.random.default_rng(3).integers(0, jcfg.vocab_size, (1, 9))
    jout = jar.ARGenerator(jmodel, jparams, jcfg).generate(
        prompt_tokens=prompt, max_gen_len=12, temperature=0.0)
    out = ar.ARGenerator(model).generate(prompt_tokens=prompt, max_gen_len=12, temperature=0.0)
    np.testing.assert_array_equal(out, jout)
    seq = torch.from_numpy(prompt)
    for _ in range(12):
        logits, _ = model(tokens=seq)
        seq = torch.cat([seq, logits[:, -1].argmax(-1, keepdim=True)], dim=1)
    np.testing.assert_array_equal(out, seq[:, 9:].numpy())
    # a stop token trims after its first occurrence (batch 1)
    stop = int(out[0, 4])
    first = int(np.nonzero(out[0] == stop)[0][0])
    trimmed = ar.ARGenerator(model).generate(prompt_tokens=prompt, max_gen_len=12,
                                             temperature=0.0, stop_tokens=(stop,))
    jtrimmed = jar.ARGenerator(jmodel, jparams, jcfg).generate(
        prompt_tokens=prompt, max_gen_len=12, temperature=0.0, stop_tokens=(stop,))
    np.testing.assert_array_equal(trimmed, jtrimmed)
    assert trimmed.shape == (1, first + 1)


def _jax_gumbel_draws(seed: int, steps: int, shape) -> list[np.ndarray]:
    """The Gumbel noise JAX's `ARGenerator.generate` draws at each step
    with key PRNGKey(seed): the first from the split's second key, the
    rest from `split(key, steps - 1)`."""
    key, sub = jax.random.split(jax.random.PRNGKey(seed))
    keys = [sub] + list(jax.random.split(key, steps - 1))
    return [np.array(jax.random.gumbel(k, shape, jnp.float32)) for k in keys]


def test_top_p_kept_set_and_gumbel_tokens_match_jax():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 64)) * 3).astype(np.float32)
    for top_p in (0.5, 0.9):
        kept = ar.top_p_filter(torch.from_numpy(logits) / 0.7, top_p).isfinite().numpy()
        # JAX's filter, as sample_top_p builds it before the draw
        lg = jnp.asarray(logits) / 0.7
        sl = jnp.sort(lg, axis=-1)[..., ::-1]
        sp = jax.nn.softmax(sl, axis=-1)
        cut = (jnp.cumsum(sp, axis=-1) - sp) > top_p
        kmin = jnp.min(jnp.where(cut, jnp.inf, sl), axis=-1, keepdims=True)
        np.testing.assert_array_equal(kept, np.asarray(lg >= kmin))
        assert 1 <= kept.sum(-1).min() and kept.sum(-1).max() < 64
        for seed in range(5):
            key = jax.random.PRNGKey(seed)
            jtok = jar.sample_top_p(jnp.asarray(logits), key, 0.7, top_p)
            g = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
            tok = ar.sample_top_p(torch.from_numpy(logits), None, 0.7, top_p,
                                  gumbel=torch.from_numpy(g))
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    # top-k at the same draw, and greedy below temperature 1e-5
    key = jax.random.PRNGKey(9)
    g = torch.from_numpy(np.array(jax.random.gumbel(key, logits.shape, jnp.float32)))
    np.testing.assert_array_equal(
        ar.sample_top_k(torch.from_numpy(logits), None, 0.8, 5, gumbel=g).numpy(),
        np.asarray(jar.sample_top_k(jnp.asarray(logits), key, 0.8, 5)))
    np.testing.assert_array_equal(ar.sample_top_p(torch.from_numpy(logits), None, 0.0).numpy(),
                                  logits.argmax(-1))


def _tiny_vlms(seed=0, cfg=None):
    """JAX's tiny VLM (optionally with another decoder config of the same
    widths) and the port's on its weights."""
    jv = jpx.build_tiny_vlm(seed)
    if cfg is not None:
        jv = dataclasses.replace(jv, text=jar.Transformer(cfg), cfg=cfg)
    sds = bridge.vlm_state_dicts(jv.text_params, jv.vit_params, jv.proj_params)
    pcfg = None if cfg is None else ar.ARConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(ar.ARConfig)
        if f.name not in ("dtype", "rope_spec")})
    if pcfg is None:
        return jv, pixtral.build_tiny_vlm(state_dicts=sds, device="cpu")
    return jv, pixtral.build_vlm(pcfg, pixtral.ViTConfig.tiny(), state_dicts=sds, device="cpu")


def test_vlm_features_embedding_and_chat_match_jax():
    jv, pv = _tiny_vlms()
    rng = np.random.default_rng(5)
    img = rng.uniform(size=(1, 64, 48, 3)).astype(np.float32)
    feats = pv.vit(torch.from_numpy(img))
    jfeats = jv.vit.apply(jv.vit_params, jnp.asarray(img))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=TOL, rtol=0)
    proj = pv.projector(feats)
    jproj = jv.projector.apply(jv.proj_params, jfeats)
    np.testing.assert_allclose(proj.numpy(), np.asarray(jproj), atol=TOL, rtol=0)
    ids = jpx.prepare_dialog_tokens(JDummyTokenizer(vocab_size=200), 12)
    np.testing.assert_array_equal(
        pixtral.prepare_dialog_tokens(JDummyTokenizer(vocab_size=200), 12), ids)
    emb = pv.embed_vision_language(ids, torch.from_numpy(img))
    jemb = jv.embed_vision_language(ids, jnp.asarray(img))
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="IMG"):
        pv.embed_vision_language(ids[:, :-8], torch.from_numpy(img[:, :32]))
    # greedy, then temperature 0.5 with JAX's draws
    out = pv.chat_completion(ids, torch.from_numpy(img), max_gen_len=8, temperature=0.0)
    jout = jv.chat_completion(ids, jnp.asarray(img), max_gen_len=8, temperature=0.0)
    np.testing.assert_array_equal(out, jout)
    draws = _jax_gumbel_draws(3, 8, (1, jv.cfg.vocab_size))
    out = pv.chat_completion(ids, torch.from_numpy(img), max_gen_len=8, temperature=0.5,
                             gumbel=[torch.from_numpy(g) for g in draws])
    jout = jv.chat_completion(ids, jnp.asarray(img), max_gen_len=8, temperature=0.5, seed=3)
    np.testing.assert_array_equal(out, jout)


def _write_both_layouts(pv, root: Path, dtype=torch.float32) -> dict[str, Path]:
    dirs = {"cosmos": root / "cosmos", "hf": root / "hf"}
    for d in dirs.values():
        d.mkdir(parents=True)
    def export(layout):
        return {k: v.to(dtype) for k, v in convert_ar.reference_state_dict(pv, layout).items()}

    torch.save(export("cosmos"), dirs["cosmos"] / "model.pt")
    write_safetensors(export("hf"), dirs["hf"] / "model.safetensors")
    return dirs


def test_load_vlm_reads_both_layouts_as_jax_does(tmp_path):
    jv, pv = _tiny_vlms(seed=1)
    dirs = _write_both_layouts(pv, tmp_path)
    rng = np.random.default_rng(6)
    img = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    ids = jpx.prepare_dialog_tokens(JDummyTokenizer(vocab_size=200), 16)
    ref = pv.embed_vision_language(ids, torch.from_numpy(img))
    ref_logits, _ = pv.text(embeddings=ref)
    from tclight_torch.models.convert import read_safetensors

    for layout, d in dirs.items():
        loaded = pixtral.load_vlm(d, ar.ARConfig.tiny(), pixtral.ViTConfig.tiny(), device="cpu")
        jloaded = jpx.load_vlm(d, jar.ARConfig.tiny(), jpx.ViTConfig.tiny())
        # the port's converters give JAX's trees, bridged
        raw = (torch.load(d / "model.pt") if layout == "cosmos"
               else {k: torch.from_numpy(v) for k, v in read_safetensors(
                   d / "model.safetensors").items()})
        if layout == "hf":
            raw = convert_ar.from_hf_pixtral(raw, 4, 2, 4)
        parts = convert_ar.convert_vlm_checkpoint(raw, 2, 2)
        jparts = bridge.vlm_state_dicts(jloaded.text_params, jloaded.vit_params,
                                        jloaded.proj_params)
        for part, jpart in zip(parts, jparts.values()):
            assert set(part) == set(jpart)
            for k in part:
                np.testing.assert_array_equal(torch.as_tensor(part[k]).numpy(),
                                              jpart[k].numpy(), err_msg=f"{layout} {k}")
        # the loaded VLM is the written one, and agrees with JAX's
        for name in ("text", "vit", "projector"):
            own, back = getattr(pv, name).state_dict(), getattr(loaded, name).state_dict()
            for k in own:
                np.testing.assert_array_equal(back[k].numpy(), own[k].numpy(), err_msg=k)
        emb = loaded.embed_vision_language(ids, torch.from_numpy(img))
        jemb = jloaded.embed_vision_language(ids, jnp.asarray(img))
        np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=TOL, rtol=0)
        logits, _ = loaded.text(embeddings=emb)
        jlogits, _ = jloaded.text.apply(jloaded.text_params, embeddings=jemb)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL, rtol=0)
        np.testing.assert_array_equal(logits.numpy(), ref_logits.numpy())
    with pytest.raises(FileNotFoundError, match="model.pt"):
        pixtral.load_vlm(tmp_path, device="cpu")


def test_load_vlm_keeps_a_bf16_checkpoint_in_bf16(tmp_path):
    """A bf16 checkpoint (the published one's dtype) loads into a bf16
    decoder with the file's values, read tensor by tensor through the
    memory-mapped safetensors reader; the ViT and projector take f32."""
    cfg = dataclasses.replace(ar.ARConfig.tiny(), dtype=torch.bfloat16)
    pv = pixtral.build_vlm(cfg, pixtral.ViTConfig.tiny(), seed=2, device="cpu")
    dirs = _write_both_layouts(pv, tmp_path, torch.bfloat16)
    for d in dirs.values():
        loaded = pixtral.load_vlm(d, cfg, pixtral.ViTConfig.tiny(), device="cpu")
        for k, v in pv.text.state_dict().items():
            back = loaded.text.state_dict()[k]
            assert back.dtype == torch.bfloat16
            assert torch.equal(back, v), k
        for k, v in pv.vit.state_dict().items():
            back = loaded.vit.state_dict()[k]
            assert back.dtype == torch.float32
            assert torch.equal(back, v.bfloat16().float()), k


def _offline_tokenizer(root: Path, instruction: str, vocab_size: int) -> Path:
    """A WordLevel HF fast tokenizer saved in `root`: ids 0-2 [UNK], <s>,
    </s>, id 10 [IMG] (Pixtral's image token), the instruction's words,
    fillers up to vocab_size."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = ["[UNK]", "<s>", "</s>"] + [f"f{i}" for i in range(3, 10)] + ["[IMG]"]
    for w in instruction.split():
        if w not in words:
            words.append(w)
    words += [f"w{i}" for i in range(vocab_size - len(words))]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
                            unk_token="[UNK]").save_pretrained(str(root))
    return root


class _RowDecoding:
    """JAX's hook calls `decode` on the (1, T) output as a nested list,
    which a fast tokenizer refuses (TypeError; ROADMAP C8); this wrapper
    decodes the row, its EOS tokens left out as the hook's filter means
    to. Everything else is the wrapped tokenizer's."""

    def __init__(self, tok):
        self._tok = tok

    def __getattr__(self, name):
        return getattr(self._tok, name)

    def __call__(self, *a, **k):
        return self._tok(*a, **k)

    def decode(self, ids):
        rows = ids[0] if ids and isinstance(ids[0], list) else ids
        return self._tok.decode([t for t in rows if t != self._tok.eos_token_id])


def test_handle_missing_prompt_matches_jax(tmp_path, monkeypatch):
    """Both packages' hook on the same tiny VLM (a decoder of 512 cache
    slots, so the 400 tokens fit), the same 720 x 960 video's last frame
    scaled to 48 x 64 (the tiny ViT's grid), an offline HF tokenizer and
    the port handed JAX's Gumbel draws: the same prompt string."""
    import transformers

    from tclight_torch.pipeline.generator import Generator
    from tclight_tpu.pipeline.generator import Generator as JGenerator

    cfg = dataclasses.replace(jar.ARConfig.tiny(), max_seq_len=512)
    jv, pv = _tiny_vlms(seed=4, cfg=cfg)
    ckpt = _offline_tokenizer(tmp_path / "upsampler", pixtral.UPSAMPLER_INSTRUCTION,
                              cfg.vocab_size)
    monkeypatch.setattr(jpx, "load_vlm", lambda ckpt_dir, *a, **k: jv)
    monkeypatch.setattr(pixtral, "load_vlm", lambda ckpt_dir, *a, **k: pv)
    rng = np.random.default_rng(7)
    frames = rng.uniform(size=(2, 48, 64, 3)).astype(np.float32)
    conf = {"generation": {"prompt_upsampler_ckpt": str(ckpt)}}
    draws = iter(_jax_gumbel_draws(0, 400, (1, cfg.vocab_size)))
    monkeypatch.setattr(ar, "gumbel_noise", lambda shape, gen, device: torch.from_numpy(
        next(draws)))
    prompt = Generator._handle_missing_prompt(
        SimpleNamespace(config=conf, device=torch.device("cpu")), frames, None)
    assert next(draws, None) is None  # every step drew once
    load = transformers.AutoTokenizer.from_pretrained
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda *a, **k: _RowDecoding(load(*a, **k)))
    jprompt = JGenerator._handle_missing_prompt(SimpleNamespace(config=conf), frames, None)
    assert prompt == jprompt
    assert len(prompt.split()) > 3


def test_cli_upsamples_a_missing_prompt_on_cpu(tmp_path, monkeypatch):
    """`python -m tclight_torch.run` without a prompt and with
    `generation.prompt_upsampler_ckpt` naming a directory (its tokenizer
    saved there, `load_vlm` handing back a tiny VLM of 512 cache slots):
    the tiny IC-Light stack runs on the upsampled prompt, and the saved
    config.yaml records it."""
    import yaml

    from tclight_torch.run import main
    from test_torch_editing import _video

    cfg = dataclasses.replace(ar.ARConfig.tiny(), max_seq_len=512)
    vlm = pixtral.build_vlm(cfg, pixtral.ViTConfig.tiny(), seed=5, device="cpu")
    ckpt = _offline_tokenizer(tmp_path / "upsampler", pixtral.UPSAMPLER_INSTRUCTION,
                              cfg.vocab_size)
    monkeypatch.setattr(pixtral, "load_vlm", lambda ckpt_dir, *a, **k: vlm)
    calls = []
    upsample = pixtral.upsample_prompt_from_frames

    def spy(ckpt_dir, frames, *a, **k):
        calls.append((frames, upsample(ckpt_dir, frames, *a, **k)))
        return calls[-1][1]

    monkeypatch.setattr(pixtral, "upsample_prompt_from_frames", spy)
    monkeypatch.chdir(Path(__file__).resolve().parent.parent)
    monkeypatch.setenv("TCLIGHT_TINY", "1")
    vid = _video(tmp_path / "vid")
    assert main(["--config", "configs/tclight_default.yaml", "-i", str(vid),
                 "post_opt.apply_opt=false", "generation.n_timesteps=2", "data.height=32",
                 "data.width=32", f"work_dir={tmp_path / 'wd'}", "generation.save_frame=false",
                 "generation.frame_range=[0,4,1]",
                 f"generation.prompt_upsampler_ckpt={ckpt}"], device="cpu") == 0
    (frames, prompt), = calls
    assert frames.shape == (4, 32, 32, 3) and len(prompt.split()) > 3
    saved = yaml.safe_load(next((tmp_path / "wd").rglob("config.yaml")).read_text())
    assert saved["generation"]["prompt"] == {"default": prompt}
    assert upsample(ckpt, frames, device="cpu") == prompt
