"""AR model-config factories and tokenizer wrappers (counterpart of
tclight_tpu/models/ar_configs.py).

`_ARCHS` holds the Cosmos AR world models' and the text models' widths;
`create_text_model_config`, `create_vision_language_model_config` and
`create_video2world_model_config` build `ARConfig`s from it. The text
tokenizers wrap a local transformers checkpoint (nothing downloads;
`transformers` is imported only when one is built).
`DiscreteMultimodalTokenizer` flattens a video tokenizer's latent-grid
indices into the AR vocabulary with an offset and begin / end-of-video
tokens.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

import numpy as np
import torch

from tclight_torch.models.ar_transformer import ARConfig

__all__ = ["create_text_model_config", "create_vision_language_model_config",
           "create_video2world_model_config", "TextTokenizer", "ImageTextTokenizer",
           "DiscreteMultimodalTokenizer"]

_ARCHS: dict[str, dict] = {
    # Cosmos AR world models
    "cosmos-4b": dict(dim=3072, n_layers=16, n_heads=32, n_kv_heads=8, ffn_hidden=8192,
                      vocab_size=64064),
    "cosmos-12b": dict(dim=5120, n_layers=40, n_heads=32, n_kv_heads=8, ffn_hidden=14336,
                       vocab_size=64064),
    # text models
    "llama3-8b": dict(dim=4096, n_layers=32, n_heads=32, n_kv_heads=8, ffn_hidden=14336,
                      vocab_size=128256, rope_theta=500000.0),
    "mistral-12b": dict(dim=5120, n_layers=40, n_heads=32, n_kv_heads=8, head_dim=128,
                        ffn_hidden=14336, vocab_size=131072, rope_theta=1e9),
    "pixtral-12b": dict(dim=5120, n_layers=40, n_heads=32, n_kv_heads=8, head_dim=128,
                        ffn_hidden=14336, vocab_size=131072, rope_theta=1e9),
}


def create_text_model_config(model_family: str = "mistral", model_size: str = "12b",
                             max_seq_len: int = 4096, **overrides: Any) -> ARConfig:
    """A text-only AR config."""
    key = f"{model_family}-{model_size}"
    if key not in _ARCHS:
        raise KeyError(f"unknown arch {key}; known: {sorted(_ARCHS)}")
    kw = dict(_ARCHS[key])
    kw.update(overrides)
    return ARConfig(max_seq_len=max_seq_len, **kw)


def create_vision_language_model_config(model_family: str = "pixtral", model_size: str = "12b",
                                        max_seq_len: int = 4300, **overrides: Any) -> ARConfig:
    """The VLM's text-decoder config (the vision tower is
    `models.pixtral.ViTConfig`)."""
    return create_text_model_config(model_family, model_size, max_seq_len, **overrides)


def create_video2world_model_config(model_size: str = "5b", max_seq_len: int = 12864,
                                    cross_dim: int = 1024, **overrides: Any) -> ARConfig:
    """The video2world AR config: 4B / 5B take the cosmos-4b widths, others
    cosmos-12b's; T5 cross-attention named on every 4th layer (a hook
    nothing reads, as in JAX)."""
    base = "cosmos-4b" if model_size in ("4b", "5b") else "cosmos-12b"
    kw = dict(_ARCHS[base])
    kw.update(overrides)
    cfg = ARConfig(max_seq_len=max_seq_len, cross_dim=cross_dim, **kw)
    return dataclasses.replace(cfg, cross_attn_layers=tuple(range(0, cfg.n_layers, 4)))


class TextTokenizer:
    """A chat-template text tokenizer from a local HF checkpoint."""

    def __init__(self, ckpt_dir: str | Path):
        from transformers import AutoTokenizer

        self.tokenizer = AutoTokenizer.from_pretrained(str(ckpt_dir))

    def apply_chat_template(self, dialog: list[dict], add_generation_prompt=True):
        return self.tokenizer.apply_chat_template(
            dialog, add_generation_prompt=add_generation_prompt, return_tensors="np")

    def encode(self, text: str) -> list[int]:
        return self.tokenizer(text, add_special_tokens=False)["input_ids"]

    def decode(self, ids) -> str:
        return self.tokenizer.decode(ids, skip_special_tokens=True)


class ImageTextTokenizer(TextTokenizer):
    """The Pixtral processor: [IMG] tokens before the text, the image
    resized to at most `max_image_size` with patch-aligned sides."""

    image_token_id = 10

    def __init__(self, ckpt_dir: str | Path, patch_size: int = 16, max_image_size: int = 1024):
        super().__init__(ckpt_dir)
        self.patch_size = patch_size
        self.max_image_size = max_image_size

    def prepare_image(self, image: np.ndarray) -> tuple[np.ndarray, int]:
        """-> (the resized image, its number of image tokens)."""
        import cv2

        h, w = image.shape[:2]
        scale = min(1.0, self.max_image_size / max(h, w))
        nh = max(self.patch_size, int(h * scale) // self.patch_size * self.patch_size)
        nw = max(self.patch_size, int(w * scale) // self.patch_size * self.patch_size)
        img = cv2.resize(image, (nw, nh))
        return img, (nh // self.patch_size) * (nw // self.patch_size)

    def encode_dialog_with_image(self, instruction: str, image: np.ndarray):
        img, n_tokens = self.prepare_image(image)
        bos = self.tokenizer.bos_token_id or 1
        ids = [bos] + [self.image_token_id] * n_tokens + self.encode(instruction)
        return np.asarray([ids], np.int32), img[None]


@dataclasses.dataclass
class DiscreteMultimodalTokenizer:
    """Video tokens in the AR vocabulary: the video tokenizer's indices
    (its `encode` returns (indices, codes)) offset by the text vocabulary,
    between a begin- and an end-of-video token."""

    video_tokenizer: Any      # cosmos.fsq.CausalDiscreteVideoTokenizer
    text_vocab_size: int
    bov_token: int = 64000
    eov_token: int = 64001

    @property
    def video_vocab_offset(self) -> int:
        return self.text_vocab_size

    def _device(self):
        return next(self.video_tokenizer.parameters()).device

    @torch.inference_mode()
    def tokenize_video(self, video: np.ndarray) -> np.ndarray:
        idx, _ = self.video_tokenizer.encode(torch.as_tensor(np.asarray(video),
                                                             device=self._device()))
        idx = idx.cpu().numpy()
        flat = idx.reshape(idx.shape[0], -1) + self.video_vocab_offset
        b = flat.shape[0]
        bov = np.full((b, 1), self.bov_token + self.video_vocab_offset)
        eov = np.full((b, 1), self.eov_token + self.video_vocab_offset)
        return np.concatenate([bov, flat, eov], axis=1).astype(np.int64)

    @torch.inference_mode()
    def detokenize_video(self, tokens: np.ndarray, grid: tuple) -> np.ndarray:
        body = np.asarray(tokens)[:, 1:-1] - self.video_vocab_offset
        t, h, w = grid
        idx = torch.as_tensor(body.reshape(-1, t, h, w), device=self._device())
        return self.video_tokenizer.decode_indices(idx).float().cpu().numpy()
