"""The Aegis text guardrail: LlamaGuard-7B with the Aegis-Defensive LoRA
adapter (counterpart of tclight_tpu/cosmos/aegis.py).

- `moderation_prompt`: the reference's [INST] template, byte for byte.
- `parse_block_message`: the unsafe-category parse, its index arithmetic
  included.
- `AegisLlamaGuard`: the HF LlamaGuard-7b weights and the PEFT adapter are
  merged on the host (`models.convert_ar.merge_lora`, f32 numpy), mapped
  onto the port's `Transformer` (`from_hf_llama`, `convert_ar_llm`; a
  Llama-2-7B in f32, as JAX builds it: ~27 GB on the card) and decoded
  greedily for up to 100 tokens, stopping at the tokenizer's eos.

A checkpoint directory holds the base model's `*.safetensors` (read with
the port's own reader; bf16 files are widened per tensor) or
`pytorch_model*.bin` with a `config.json`, tokenizer files for
transformers' AutoTokenizer (unless a tokenizer is passed in), and
optionally `adapter_model.safetensors` (with `adapter_config.json`)
anywhere under it.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from tclight_torch.cosmos.aegis_data import UNSAFE_CATEGORIES
from tclight_torch.models.ar_transformer import ARConfig, ARGenerator, Transformer
from tclight_torch.models.convert import mmap_safetensors
from tclight_torch.models.convert_ar import convert_ar_llm, from_hf_llama, merge_lora
from tclight_torch.utils.device import resolve_device

__all__ = ["UNSAFE_CATEGORIES", "moderation_prompt", "parse_block_message", "AegisLlamaGuard"]


def moderation_prompt(user_prompt: str) -> str:
    """The Aegis moderation prompt, byte for byte the reference's (its
    8-space indentation included: the adapter was trained on it)."""
    full_prompt = f"""[INST] Task: Check if there is unsafe content in 'User' messages in conversations according our safety policy with the below categories.

        <BEGIN UNSAFE CONTENT CATEGORIES>
        {"".join([f"{category['instruction']}" for category in UNSAFE_CATEGORIES])}
        <END UNSAFE CONTENT CATEGORIES>

        <BEGIN CONVERSATION>

        """
    full_prompt += f"User: {user_prompt}\n\n"
    full_prompt += """<END CONVERSATION>

        Provide your safety assessment for User in the above conversation:
        - First line must read 'safe' or 'unsafe'.
        - If unsafe, a second line must include a comma-separated list of violated categories. [/INST]"""
    return full_prompt


def parse_block_message(moderation_output: str) -> str:
    """The blocked category and reason from the model's output. The O-code
    maps to int(code) - 1 in the 11-entry list though O9 is absent, so
    O10-O12 resolve one entry early; a multi-category line raises inside
    and gives the generic message (both as in the reference)."""
    block_msg = "Prompt blocked by Aegis."
    try:
        lines = moderation_output.split("\n")
        if len(lines) >= 2:
            blocked_category = int(lines[1].lstrip("O")) - 1
            if 0 <= blocked_category < len(UNSAFE_CATEGORIES):
                cat = UNSAFE_CATEGORIES[blocked_category]
                block_msg = f"{cat['category']}: {cat['blocked_reason']}"
    except Exception:
        pass
    return block_msg


def _load_weights_dir(d: Path) -> dict:
    """Every non-adapter `*.safetensors` tensor under d (in its file's
    dtype, memory-mapped), else every `pytorch_model*.bin` tensor."""
    sd: dict = {}
    files = sorted(p for p in d.glob("*.safetensors") if not p.name.startswith("adapter"))
    if files:
        for f in files:
            sd.update(mmap_safetensors(f))
        return sd
    for f in sorted(d.glob("pytorch_model*.bin")):
        sd.update(torch.load(f, map_location="cpu", weights_only=True))
    return sd


def _load_adapter(d: Path):
    """(adapter state dict, lora_alpha, r, use_rslora), or None."""
    cand = list(d.glob("adapter_model.safetensors")) + list(d.glob("**/adapter_model.safetensors"))
    if not cand:
        return None
    sd = mmap_safetensors(cand[0])
    cfg_path = cand[0].parent / "adapter_config.json"
    cfg = json.loads(cfg_path.read_text()) if cfg_path.exists() else {}
    return (sd, float(cfg.get("lora_alpha", 16)), int(cfg.get("r", 16)),
            bool(cfg.get("use_rslora", False)))


class AegisLlamaGuard:
    """The checkpoint-backed Aegis safety model on the port's AR decoder,
    built on `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, ckpt_dir: str | Path, max_new_tokens: int = 100, tokenizer=None,
                 device="cuda", dtype: torch.dtype = torch.float32):
        d = Path(str(ckpt_dir))
        self.device = resolve_device(device)
        cfg_file = d / "config.json"
        hf_cfg = json.loads(cfg_file.read_text()) if cfg_file.exists() else {}
        # LlamaGuard-7b's values where config.json lacks a key; 4,096 slots
        cfg = ARConfig(
            vocab_size=hf_cfg.get("vocab_size", 32000), dim=hf_cfg.get("hidden_size", 4096),
            n_layers=hf_cfg.get("num_hidden_layers", 32),
            n_heads=hf_cfg.get("num_attention_heads", 32),
            n_kv_heads=hf_cfg.get("num_key_value_heads", hf_cfg.get("num_attention_heads", 32)),
            ffn_hidden=hf_cfg.get("intermediate_size", 11008), max_seq_len=4096,
            rope_theta=hf_cfg.get("rope_theta", 10000.0),
            norm_eps=hf_cfg.get("rms_norm_eps", 1e-5), dtype=dtype)
        sd = _load_weights_dir(d)
        if not sd:
            raise FileNotFoundError(f"no model weights under {d}")
        adapter = _load_adapter(d)
        if adapter is not None:
            a_sd, alpha, r, rs = adapter
            sd = merge_lora(sd, a_sd, alpha, r, use_rslora=rs)
        sd = convert_ar_llm(from_hf_llama(sd, cfg.n_heads, cfg.n_kv_heads), cfg.n_layers)
        with torch.device("meta"):
            model = Transformer(cfg)
        model = model.to_empty(device=self.device)
        with torch.no_grad():
            for name, p in model.state_dict().items():
                p.copy_(torch.as_tensor(sd.pop(name)))
        self.cfg = cfg
        self.model = model.eval().requires_grad_(False)
        self.generator = ARGenerator(self.model)
        self.max_new_tokens = max_new_tokens
        if tokenizer is None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(str(d))
        self.tokenizer = tokenizer
        self.eos_id = int(self.tokenizer.eos_token_id)

    def moderate(self, prompt: str) -> str:
        """The raw moderation output for a user prompt."""
        ids = self.tokenizer(moderation_prompt(prompt), add_special_tokens=False)["input_ids"]
        out = self.generator.generate(prompt_tokens=np.asarray([ids], dtype=np.int64),
                                      max_gen_len=self.max_new_tokens, temperature=0.0,
                                      stop_tokens=(self.eos_id,))
        gen = [int(t) for t in out[0]]
        if self.eos_id in gen:
            gen = gen[: gen.index(self.eos_id)]
        return self.tokenizer.decode(gen, skip_special_tokens=True)

    def is_safe(self, prompt: str) -> tuple[bool, str]:
        """(safe, the block message)."""
        out = self.moderate(prompt)
        if "unsafe" in out.lower():
            return False, parse_block_message(out)
        return True, ""
