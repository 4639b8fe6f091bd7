"""CLIP text encoder (counterpart of tclight_tpu/models/clip_text.py):
the ViT-L/14 text tower that SD1.5 cross-attends to, and the ViT-B/32 and
ViT-H/14 towers of the evaluation's text metrics. Returns the final-layer
hidden states."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    intermediate_size: int = 3072
    dtype: torch.dtype = torch.float32

    @staticmethod
    def sd15(dtype=torch.float32) -> "CLIPTextConfig":
        return CLIPTextConfig(dtype=dtype)

    @staticmethod
    def vit_b32(dtype=torch.float32) -> "CLIPTextConfig":
        """openai CLIP ViT-B/32's text tower (hidden 512, projection 512)."""
        return CLIPTextConfig(hidden_size=512, num_layers=12, num_heads=8,
                              intermediate_size=2048, dtype=dtype)

    @staticmethod
    def vit_h14(dtype=torch.float32) -> "CLIPTextConfig":
        """laion CLIP-ViT-H-14's text tower (the PickScore_v1 backbone)."""
        return CLIPTextConfig(hidden_size=1024, num_layers=24, num_heads=16,
                              intermediate_size=4096, dtype=dtype)

    @staticmethod
    def tiny(dtype=torch.float32) -> "CLIPTextConfig":
        return CLIPTextConfig(vocab_size=1000, hidden_size=32, num_layers=2,
                              num_heads=2, max_positions=77,
                              intermediate_size=64, dtype=dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.heads = cfg.num_heads
        self.q_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.k_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.v_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.out_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x, mask):
        b, s, c = x.shape
        h, d = self.heads, c // self.heads

        def split(t):
            return t.reshape(b, s, h, d).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / d ** 0.5
        logits = logits.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, c)
        return self.out_proj(out)


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.mlp_fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.mlp_fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp_fc2(quick_gelu(self.mlp_fc1(self.layer_norm2(x))))


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = cfg = config
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_positions, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}", CLIPLayer(cfg))
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.to(cfg.dtype)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids: (B, S) int -> last hidden states (B, S, hidden) f32."""
        s = input_ids.shape[1]
        x = self.token_embedding(input_ids) + self.position_embedding[None, :s]
        causal = torch.ones(s, s, dtype=torch.bool,
                            device=input_ids.device).tril()
        for i in range(self.config.num_layers):
            x = getattr(self, f"layers_{i}")(x, causal)
        return self.final_layer_norm(x).float()
