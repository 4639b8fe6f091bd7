"""The T5 text encoder of the Cosmos DiT (counterpart of
tclight_tpu/cosmos/t5.py): a local HF T5 checkpoint directory (nothing
downloads) read with the port's own safetensors reader (or torch's for
`pytorch_model*.bin`), converted once (`models.t5_encoder.
convert_t5_encoder`) into a `T5Encoder` on the device. The features
(context_dim 1024 for t5-11b) feed the DiT's cross-attention; padded
positions are zeroed.

The tokenizer is transformers' `T5TokenizerFast` from the directory,
imported only when none is passed in.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from tclight_torch.models.convert import mmap_safetensors
from tclight_torch.models.t5_encoder import T5Config, T5Encoder, convert_t5_encoder
from tclight_torch.utils.device import resolve_device

__all__ = ["T5TextEncoder"]


class T5TextEncoder:
    def __init__(self, ckpt_dir: str | Path, max_length: int = 512, cfg: T5Config | None = None,
                 tokenizer=None, device="cuda"):
        ckpt_dir = Path(ckpt_dir)
        self.device = resolve_device(device)
        if tokenizer is None:
            from transformers import T5TokenizerFast

            tokenizer = T5TokenizerFast.from_pretrained(str(ckpt_dir))
        self.tokenizer = tokenizer
        self.max_length = max_length
        if cfg is None:
            hf = json.loads((ckpt_dir / "config.json").read_text())
            cfg = T5Config(vocab_size=hf["vocab_size"], d_model=hf["d_model"], d_kv=hf["d_kv"],
                           d_ff=hf["d_ff"], n_layers=hf["num_layers"], n_heads=hf["num_heads"],
                           rel_buckets=hf.get("relative_attention_num_buckets", 32),
                           rel_max_distance=hf.get("relative_attention_max_distance", 128),
                           gated_ff="gated" in hf.get("feed_forward_proj", "relu"))
        self.cfg = cfg
        sd = convert_t5_encoder(self._load_state_dict(ckpt_dir), cfg)
        with torch.device(self.device):
            self.model = T5Encoder(cfg)
        self.model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
        self.model.eval().requires_grad_(False)

    @staticmethod
    def _load_state_dict(ckpt_dir: Path) -> dict:
        files = sorted(ckpt_dir.glob("*.safetensors"))
        sd: dict = {}
        if files:
            for f in files:
                sd.update(mmap_safetensors(f))
            return sd
        bins = sorted(ckpt_dir.glob("pytorch_model*.bin"))
        if not bins:
            raise FileNotFoundError(f"no T5 weights in {ckpt_dir}")
        for f in bins:
            sd.update(torch.load(f, map_location="cpu", weights_only=True))
        return sd

    @torch.inference_mode()
    def encode_prompts(self, prompts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """-> (embeddings (B, L, D) f32, attention mask (B, L)); padded
        positions' embeddings are zero."""
        batch = self.tokenizer(prompts, padding="max_length", truncation=True,
                               max_length=self.max_length, return_tensors="np")
        ids = torch.as_tensor(np.asarray(batch["input_ids"]), device=self.device)
        mask = torch.as_tensor(np.asarray(batch["attention_mask"]), device=self.device)
        out = self.model(ids, mask)
        return out.float().cpu().numpy(), np.asarray(batch["attention_mask"])
