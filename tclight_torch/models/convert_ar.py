"""Checkpoint converters of the Pixtral prompt upsampler (the upsampler's
part of tclight_tpu/models/convert_ar.py), and their inverses.

Two layouts are read:

1. cosmos-native: one flat dict with ``model.*`` (the Mistral-style
   decoder: ``layers.{i}.attention.wq.weight`` ...), ``vision_encoder.*``
   (the Pixtral ViT: ``transformer.layers.{i}...``, ``patch_conv.weight``,
   ``ln_pre.weight``) and ``mm_projector.*`` (``projector.0`` / ``.2``);
   the decoder's keys may also sit under a "model" entry, or the ViT's and
   the projector's under ``model.`` (a fine-tuned checkpoint);
2. the HF hub layout (LlavaForConditionalGeneration:
   ``language_model.model.layers.{i}.self_attn.q_proj`` ...,
   ``vision_tower...``, ``multi_modal_projector.linear_1`` / ``_2``), whose
   q / k rows HF permuted for its half-split RoPE: `from_hf_pixtral`
   restores the interleaved order and the cosmos-native keys.

The JAX converters build flax trees (kernels transposed); the port's
modules keep the reference's (out, in) layout, so here a converter only
renames: ``convert_ar_llm`` maps the decoder's keys onto `Transformer`'s
state dict, ``convert_pixtral_vit`` the ViT's onto `PixtralViT`'s,
``convert_mm_projector`` the projector's onto `MultimodalProjector`'s. The
values pass through as they are (numpy arrays or torch tensors, any
dtype), so a 12B checkpoint is never copied whole: `pixtral.load_vlm`
casts and moves them one by one. `reference_state_dict` writes a VLM back
in either layout.

For the Aegis guardrail (LlamaGuard-7B and its LoRA adapter):
`from_hf_llama` maps a HF LlamaForCausalLM state dict onto the
cosmos-native keys (q / k rows un-permuted), `merge_lora` folds a PEFT
adapter into the base weights in f32 numpy (as JAX does it, so the
merged values are JAX's), and `expand_vocab` widens the embedding (and
the output layer) with Gaussian rows drawn from numpy's generator in
JAX's order.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["convert_ar_llm", "convert_pixtral_vit", "convert_mm_projector",
           "convert_vlm_checkpoint", "from_hf_pixtral", "from_hf_llama", "merge_lora",
           "expand_vocab", "reference_state_dict"]

_LLM_LEAVES = ("attention.wq", "attention.wk", "attention.wv", "attention.wo",
               "feed_forward.w1", "feed_forward.w2", "feed_forward.w3",
               "attention_norm", "ffn_norm")


def convert_ar_llm(sd: Mapping, n_layers: int) -> dict:
    """Mistral / cosmos-native decoder keys -> `Transformer`'s state dict."""
    out = {"tok_embeddings.weight": sd["tok_embeddings.weight"],
           "norm.weight": sd["norm.weight"], "output.weight": sd["output.weight"]}
    # an optional QK normalization (``attention.q_norm`` / ``k_norm``) is
    # left out: neither package's decoder applies it
    for i in range(n_layers):
        for leaf in _LLM_LEAVES:
            out[f"layers_{i}.{leaf}.weight"] = sd[f"layers.{i}.{leaf}.weight"]
    return out


def convert_pixtral_vit(sd: Mapping, n_layers: int) -> dict:
    """Pixtral ViT native keys -> `PixtralViT`'s state dict."""
    out = {"patch_conv.weight": sd["patch_conv.weight"], "ln_pre.weight": sd["ln_pre.weight"]}
    for i in range(n_layers):
        r = f"transformer.layers.{i}."
        for w in ("wq", "wk", "wv", "wo"):
            out[f"layers_{i}_attention.{w}.weight"] = sd[f"{r}attention.{w}.weight"]
        for w in ("w1", "w2", "w3"):
            out[f"layers_{i}_feed_forward.{w}.weight"] = sd[f"{r}feed_forward.{w}.weight"]
        out[f"layers_{i}_attention_norm.weight"] = sd[f"{r}attention_norm.weight"]
        out[f"layers_{i}_ffn_norm.weight"] = sd[f"{r}ffn_norm.weight"]
    return out


def convert_mm_projector(sd: Mapping) -> dict:
    """``projector.0`` / ``.2`` (a Sequential's Linear, GELU, Linear) ->
    `MultimodalProjector`'s w_in / w_out."""
    return {f"{name}.{leaf}": sd[f"projector.{idx}.{leaf}"]
            for name, idx in (("w_in", 0), ("w_out", 2)) for leaf in ("weight", "bias")}


def _split_prefix(ckpt: Mapping, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in ckpt.items() if k.startswith(prefix)}


def convert_vlm_checkpoint(ckpt: Mapping, llm_layers: int, vit_layers: int
                           ) -> tuple[dict, dict, dict]:
    """Split a combined cosmos-native VLM checkpoint and convert its parts:
    -> (decoder, ViT, projector) state dicts."""
    if "model" in ckpt and isinstance(ckpt["model"], Mapping):
        flat = dict(ckpt["model"])
        vit_sd = dict(ckpt.get("vision_encoder", {}))
        proj_sd = dict(ckpt.get("mm_projector", {}))
    else:
        flat = _split_prefix(ckpt, "model.")
        vit_sd = _split_prefix(ckpt, "vision_encoder.")
        proj_sd = _split_prefix(ckpt, "mm_projector.")
    if not vit_sd:  # fine-tuned layout: everything under model.*
        vit_sd = _split_prefix(flat, "vision_encoder.")
        proj_sd = _split_prefix(flat, "mm_projector.")
        flat = {k: v for k, v in flat.items()
                if not k.startswith(("vision_encoder.", "mm_projector."))}
    return (convert_ar_llm(flat, llm_layers), convert_pixtral_vit(vit_sd, vit_layers),
            convert_mm_projector(proj_sd))


def _unpermute_rotary(w, n_heads: int) -> torch.Tensor:
    """HF's q / k rows -> the interleaved order: native[2i] = hf[i],
    native[2i + 1] = hf[i + hd / 2] within each head's rows."""
    w = torch.as_tensor(w)
    out_dim, in_dim = w.shape
    hd = out_dim // n_heads
    return w.reshape(n_heads, 2, hd // 2, in_dim).transpose(1, 2).reshape(out_dim, in_dim)


def _permute_rotary(w: torch.Tensor, n_heads: int) -> torch.Tensor:
    """The inverse of `_unpermute_rotary` (HF's row order)."""
    out_dim, in_dim = w.shape
    hd = out_dim // n_heads
    return w.reshape(n_heads, hd // 2, 2, in_dim).transpose(1, 2).reshape(out_dim, in_dim)


_HF_LLM = (("embed_tokens", "tok_embeddings"), ("self_attn.q_proj", "attention.wq"),
           ("self_attn.k_proj", "attention.wk"), ("self_attn.v_proj", "attention.wv"),
           ("self_attn.o_proj", "attention.wo"), ("mlp.gate_proj", "feed_forward.w1"),
           ("mlp.down_proj", "feed_forward.w2"), ("mlp.up_proj", "feed_forward.w3"),
           ("input_layernorm", "attention_norm"), ("post_attention_layernorm", "ffn_norm"),
           ("lm_head", "output"))
_HF_VIT = (("attention.q_proj", "attention.wq"), ("attention.k_proj", "attention.wk"),
           ("attention.v_proj", "attention.wv"), ("attention.o_proj", "attention.wo"),
           ("feed_forward.gate_proj", "feed_forward.w1"),
           ("feed_forward.down_proj", "feed_forward.w2"),
           ("feed_forward.up_proj", "feed_forward.w3"))


def _rename(key: str, table, inverse: bool = False) -> str:
    for a, b in table:
        key = key.replace(b, a) if inverse else key.replace(a, b)
    return key


def from_hf_pixtral(sd: Mapping, llm_heads: int, llm_kv_heads: int, vit_heads: int) -> dict:
    """The HF pixtral-12b layout -> the cosmos-native flat layout (then
    `convert_vlm_checkpoint`); q / k rows un-permuted."""
    out: dict = {}
    for k, v in sd.items():
        if k.startswith("language_model."):
            k2 = _rename(k.split("language_model.", 1)[1].removeprefix("model."), _HF_LLM)
            if ".wq." in k2:
                v = _unpermute_rotary(v, llm_heads)
            elif ".wk." in k2:
                v = _unpermute_rotary(v, llm_kv_heads)
            out["model." + k2] = v
        elif k == "lm_head.weight":
            out["model.output.weight"] = v
        elif k.startswith("vision_tower."):
            k2 = _rename(k.split("vision_tower.", 1)[1], _HF_VIT)
            if ".wq." in k2 or ".wk." in k2:
                v = _unpermute_rotary(v, vit_heads)
            out["vision_encoder." + k2] = v
        elif k.startswith("multi_modal_projector."):
            k2 = k.split("multi_modal_projector.", 1)[1]
            out["mm_projector." + k2.replace("linear_1", "projector.0")
                .replace("linear_2", "projector.2")] = v
    return out


def from_hf_llama(sd: Mapping, n_heads: int, n_kv_heads: int) -> dict:
    """A HF LlamaForCausalLM state dict (LlamaGuard-7b's layout:
    ``model.layers.{i}.self_attn.q_proj.weight`` ...) -> the cosmos-native
    flat layout that `convert_ar_llm` reads, q / k rows un-permuted."""
    out: dict = {}
    for k, v in sd.items():
        k2 = _rename(k.removeprefix("model."), _HF_LLM)
        if ".wq." in k2:
            v = _unpermute_rotary(v, n_heads)
        elif ".wk." in k2:
            v = _unpermute_rotary(v, n_kv_heads)
        out[k2] = v
    return out


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def merge_lora(base_sd: Mapping, adapter_sd: Mapping, lora_alpha: float, r: int,
               use_rslora: bool = False) -> dict:
    """Merge a PEFT LoRA adapter into a base HF state dict: W' = W + scale
    * B @ A, scale = lora_alpha / r (rsLoRA: lora_alpha / sqrt(r)), in f32
    numpy. Adapter keys are ``base_model.model.<module>.lora_A.weight`` /
    ``.lora_B.weight``, the target ``<module>.weight``; other base keys
    pass through as they are."""
    scale = lora_alpha / (np.sqrt(r) if use_rslora else r)
    merged = dict(base_sd)
    for k, a in adapter_sd.items():
        if ".lora_A." not in k:
            continue
        module = k.split(".lora_A.")[0].removeprefix("base_model.model.")
        target = module + ".weight"
        if target not in merged:
            raise KeyError(f"LoRA adapter targets missing base key {target}")
        a_w = _np(a).astype(np.float32)                                       # (r, in)
        b_w = _np(adapter_sd[k.replace(".lora_A.", ".lora_B.")]).astype(np.float32)  # (out, r)
        merged[target] = _np(merged[target]).astype(np.float32) + scale * (b_w @ a_w)
    return merged


def expand_vocab(llm_sd: Mapping, new_vocab: int, expand_output_layer: bool = True,
                 seed: int = 0, std: float = 0.02) -> dict:
    """Widen `Transformer`'s state dict to `new_vocab` tokens: Gaussian rows
    (numpy's generator from `seed`; the embedding's draw first, then the
    output layer's, as JAX draws its (dim, vocab) kernel) appended to the
    embedding and, with `expand_output_layer`, to the output layer."""
    rng = np.random.default_rng(seed)
    emb = _np(llm_sd["tok_embeddings.weight"])
    v0, d = emb.shape
    if new_vocab <= v0:
        return dict(llm_sd)
    out = dict(llm_sd)
    extra = rng.normal(0.0, std, (new_vocab - v0, d)).astype(emb.dtype)
    out["tok_embeddings.weight"] = torch.from_numpy(np.concatenate([emb, extra], axis=0))
    if expand_output_layer:
        w = _np(llm_sd["output.weight"])                                       # (vocab, dim)
        extra_o = rng.normal(0.0, std, (d, new_vocab - v0)).astype(w.dtype)
        out["output.weight"] = torch.from_numpy(np.concatenate([w, extra_o.T], axis=0))
    return out


def reference_state_dict(vlm, layout: str = "cosmos") -> dict[str, torch.Tensor]:
    """A `PixtralVLM`'s weights as a checkpoint (the converters' inverse),
    each tensor in its parameter's dtype on the CPU: ``cosmos`` gives the
    flat cosmos-native dict (``model.`` / ``vision_encoder.`` /
    ``mm_projector.`` keys), ``hf`` the HF hub's keys with HF's q / k row
    order."""
    if layout not in ("cosmos", "hf"):
        raise ValueError(f"layout must be 'cosmos' or 'hf', got {layout!r}")
    cfg, vcfg = vlm.cfg, vlm.vit.cfg
    llm = {"tok_embeddings.weight": "tok_embeddings.weight", "norm.weight": "norm.weight",
           "output.weight": "output.weight"}
    llm |= {f"layers_{i}.{leaf}.weight": f"layers.{i}.{leaf}.weight"
            for i in range(cfg.n_layers) for leaf in _LLM_LEAVES}
    vit = {"patch_conv.weight": "patch_conv.weight", "ln_pre.weight": "ln_pre.weight"}
    for i in range(vcfg.n_layers):
        r = f"transformer.layers.{i}."
        vit |= {f"layers_{i}_attention.{w}.weight": f"{r}attention.{w}.weight"
                for w in ("wq", "wk", "wv", "wo")}
        vit |= {f"layers_{i}_feed_forward.{w}.weight": f"{r}feed_forward.{w}.weight"
                for w in ("w1", "w2", "w3")}
        vit[f"layers_{i}_attention_norm.weight"] = f"{r}attention_norm.weight"
        vit[f"layers_{i}_ffn_norm.weight"] = f"{r}ffn_norm.weight"
    out = {}
    for prefix, module, names in (("model.", vlm.text, llm), ("vision_encoder.", vlm.vit, vit)):
        for key, val in module.state_dict().items():
            out[prefix + names[key]] = val.detach().cpu()
    for key, val in vlm.projector.state_dict().items():
        name, leaf = key.split(".")
        out[f"mm_projector.projector.{0 if name == 'w_in' else 2}.{leaf}"] = val.detach().cpu()
    if layout == "cosmos":
        return out
    hf = {}
    for k, v in out.items():
        if k.startswith("model."):
            k2 = k[len("model."):]
            if ".wq." in k2:
                v = _permute_rotary(v, cfg.n_heads)
            elif ".wk." in k2:
                v = _permute_rotary(v, cfg.n_kv_heads)
            k2 = _rename(k2, _HF_LLM, inverse=True)
            hf["language_model." + ("" if k2 == "lm_head.weight" else "model.") + k2] = v
        elif k.startswith("vision_encoder."):
            k2 = k[len("vision_encoder."):]
            if ".wq." in k2 or ".wk." in k2:
                v = _permute_rotary(v, vcfg.n_heads)
            hf["vision_tower." + _rename(k2, _HF_VIT, inverse=True)] = v
        else:
            k2 = k[len("mm_projector."):]
            hf["multi_modal_projector." + k2.replace("projector.0", "linear_1")
               .replace("projector.2", "linear_2")] = v
    return {k: v.contiguous() for k, v in hf.items()}
