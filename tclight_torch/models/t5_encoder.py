"""The T5 encoder stack and its HF checkpoint converter (counterpart of
tclight_tpu/models/t5_encoder.py): RMS layer norms without mean or bias,
attention logits not scaled by 1 / sqrt(d_kv), a learned relative-position
bias made by block 0 and reused by every block, a relu or gated-gelu
feed-forward, padded positions zeroed at the output.

The modules carry the flax module names (`shared`, `block_{i}_ln0`,
`block_{i}_attn.q`, `block_{i}_ff.wi`, `final_layer_norm`), so
`models/bridge.py`'s `flax_to_state_dict` maps JAX's parameter tree onto
them; `convert_t5_encoder` renames a HF `T5EncoderModel` state dict onto
them (HF's Linear weights are already (out, in)). The attention is a
matmul and a softmax, as JAX's einsum: q.k^T summed in f32, the
probabilities cast to the compute dtype for p.v.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["T5Config", "T5LayerNorm", "relative_position_bucket", "T5SelfAttention", "T5FF",
           "T5Encoder", "convert_t5_encoder"]


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 1024
    d_kv: int = 128
    d_ff: int = 65536
    n_layers: int = 24
    n_heads: int = 128
    rel_buckets: int = 32
    rel_max_distance: int = 128
    gated_ff: bool = False       # t5-11b (v1.0) uses plain relu
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32

    @staticmethod
    def t5_11b() -> "T5Config":
        return T5Config()

    @staticmethod
    def tiny() -> "T5Config":
        return T5Config(vocab_size=128, d_model=32, d_kv=8, d_ff=64, n_layers=2, n_heads=4)


class T5LayerNorm(nn.Module):
    """RMS-only layer norm: the variance in f32, rsqrt cast to x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))

    def forward(self, x):
        var = x.float().pow(2).mean(-1, keepdim=True)
        x = x * torch.rsqrt(var + self.eps).to(x.dtype)
        return x * self.weight.to(x.dtype)


def relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int, max_dist: int
                             ) -> torch.Tensor:
    """HF T5's bidirectional bucketing: half the buckets per direction,
    exact below num_buckets / 4, logarithmic up to max_dist."""
    num_buckets //= 2
    ret = (rel_pos > 0).to(torch.int32) * num_buckets
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    val_large = max_exact + (torch.log(n.float() / max_exact + 1e-9)
                             / math.log(max_dist / max_exact)
                             * (num_buckets - max_exact)).to(torch.int32)
    val_large = val_large.clamp(max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n.to(torch.int32), val_large)


def _linear(n_in: int, n_out: int, dtype: torch.dtype) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=False, dtype=dtype)


class T5SelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_rel_bias: bool = False):
        super().__init__()
        self.cfg, self.has_rel_bias = cfg, has_rel_bias
        inner = cfg.n_heads * cfg.d_kv
        self.q, self.k, self.v = (_linear(cfg.d_model, inner, cfg.dtype) for _ in range(3))
        self.o = _linear(inner, cfg.d_model, cfg.dtype)
        if has_rel_bias:
            self.relative_attention_bias = nn.Embedding(cfg.rel_buckets, cfg.n_heads)

    def forward(self, x, mask, pos_bias):
        """x (B, S, d_model), mask (B, S) bool, pos_bias (1, H, S, S) f32 or
        None (block 0 makes it) -> (out, pos_bias)."""
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = (proj(x).reshape(b, s, cfg.n_heads, cfg.d_kv).transpose(1, 2)
                   for proj in (self.q, self.k, self.v))
        if self.has_rel_bias:
            pos = torch.arange(s, device=x.device)
            buckets = relative_position_bucket(pos[None, :] - pos[:, None], cfg.rel_buckets,
                                               cfg.rel_max_distance)
            pos_bias = self.relative_attention_bias(buckets.long()).float().permute(2, 0, 1)[None]
        # T5 does not scale q.k^T by 1 / sqrt(d_kv)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if pos_bias is not None:
            logits = logits + pos_bias
        logits = logits.masked_fill(~mask[:, None, None, :], -1e9)
        probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, -1)
        return self.o(out), pos_bias


class T5FF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.gated = cfg.gated_ff
        if self.gated:
            self.wi_0 = _linear(cfg.d_model, cfg.d_ff, cfg.dtype)
            self.wi_1 = _linear(cfg.d_model, cfg.d_ff, cfg.dtype)
        else:
            self.wi = _linear(cfg.d_model, cfg.d_ff, cfg.dtype)
        self.wo = _linear(cfg.d_ff, cfg.d_model, cfg.dtype)

    def forward(self, x):
        if self.gated:
            h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        else:
            h = F.relu(self.wi(x))
        return self.wo(h)


class T5Encoder(nn.Module):
    """input_ids (B, S), attention_mask (B, S) or None -> the last hidden
    state (B, S, d_model) with padded positions zeroed."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model, dtype=cfg.dtype)
        for i in range(cfg.n_layers):
            setattr(self, f"block_{i}_ln0", T5LayerNorm(cfg.d_model, cfg.layer_norm_eps, cfg.dtype))
            setattr(self, f"block_{i}_attn", T5SelfAttention(cfg, has_rel_bias=i == 0))
            setattr(self, f"block_{i}_ln1", T5LayerNorm(cfg.d_model, cfg.layer_norm_eps, cfg.dtype))
            setattr(self, f"block_{i}_ff", T5FF(cfg))
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps, cfg.dtype)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None):
        input_ids = input_ids.long()
        mask = (torch.ones_like(input_ids, dtype=torch.bool) if attention_mask is None
                else attention_mask.bool())
        x = self.shared(input_ids)
        pos_bias = None
        for i in range(self.cfg.n_layers):
            attn, pos_bias = getattr(self, f"block_{i}_attn")(
                getattr(self, f"block_{i}_ln0")(x), mask, pos_bias)
            x = x + attn
            x = x + getattr(self, f"block_{i}_ff")(getattr(self, f"block_{i}_ln1")(x))
        x = self.final_layer_norm(x)
        return x * mask[..., None].to(x.dtype)


def convert_t5_encoder(sd: Mapping, cfg: T5Config) -> dict:
    """A HF `T5EncoderModel` state dict -> `T5Encoder`'s state dict (the
    values as they are: numpy arrays or tensors)."""
    out = {"shared.weight": sd["shared.weight"],
           "final_layer_norm.weight": sd["encoder.final_layer_norm.weight"]}
    ff = ("wi_0", "wi_1", "wo") if cfg.gated_ff else ("wi", "wo")
    for i in range(cfg.n_layers):
        r = f"encoder.block.{i}.layer."
        for n in ("q", "k", "v", "o"):
            out[f"block_{i}_attn.{n}.weight"] = sd[f"{r}0.SelfAttention.{n}.weight"]
        if i == 0:
            out["block_0_attn.relative_attention_bias.weight"] = \
                sd[f"{r}0.SelfAttention.relative_attention_bias.weight"]
        out[f"block_{i}_ln0.weight"] = sd[f"{r}0.layer_norm.weight"]
        for n in ff:
            out[f"block_{i}_ff.{n}.weight"] = sd[f"{r}1.DenseReluDense.{n}.weight"]
        out[f"block_{i}_ln1.weight"] = sd[f"{r}1.layer_norm.weight"]
    return out
