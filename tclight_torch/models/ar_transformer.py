"""Autoregressive decoder (the Llama / Mistral / Pixtral family) with a
static KV cache (counterpart of tclight_tpu/models/ar_transformer.py).

- `GQAAttention`: grouped-query attention whose cache holds `max_seq_len`
  slots, updated at `cur_len`; the mask runs over absolute positions, so
  the empty slots past the current position are masked too (-1e30), as in
  JAX, which attends over every slot;
- `RMSNorm`: the variance in f32, rsqrt cast to the input's dtype, then
  the products;
- `SwiGLUMLP`, `TransformerBlock`, `Transformer` (logits in f32);
- `sample_top_p` / `sample_top_k` and `ARGenerator.generate`: prefill,
  then one token a step, then the trim at the first stop token (batch 1).

The attention is a matmul and a softmax, as JAX's `jnp.einsum` (no flash
kernel on this path): q.k^T of the compute-dtype q and k summed in f32
(JAX's preferred_element_type), the f32 softmax cast to the compute dtype
before p.v. A query head h reads K/V head h // (n_heads / n_kv_heads),
which is JAX's `jnp.repeat` of the K/V heads, without the copy.

Sampling draws Gumbel noise from a `torch.Generator`; JAX's
`jax.random.categorical` is argmax(logits + gumbel), so a caller that
passes JAX's draw (`gumbel`) gets JAX's tokens.

The modules carry the flax module names (`layers_{i}`, `attention.wq`,
`feed_forward.w1`, ...), so `models/bridge.py` maps JAX's parameter trees
onto them. Their parameters are made in the config's dtype on the current
default device (build under `torch.device(...)`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tclight_torch.models.rope import RopeSpec, apply_rope_tables, build_rope_tables

__all__ = ["ARConfig", "RMSNorm", "rope_frequencies", "apply_rope", "KVCache", "init_cache",
           "GQAAttention", "SwiGLUMLP", "TransformerBlock", "Transformer", "gumbel_noise",
           "sample_top_p", "sample_top_k", "ARGenerator"]


@dataclasses.dataclass(frozen=True)
class ARConfig:
    vocab_size: int = 32000
    dim: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: Optional[int] = None
    ffn_hidden: int = 1024
    max_seq_len: int = 1024
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32
    # the video2world variant's cross-attention hooks: as in JAX, no
    # module reads them, so the decoder has no cross-attention (ROADMAP C12)
    cross_attn_layers: tuple = ()
    cross_dim: int = 0
    # None keeps the default v1 1D RoPE at (rope_theta, max_seq_len)
    rope_spec: Optional[RopeSpec] = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.dim // self.n_heads

    @staticmethod
    def tiny(vocab_size: int = 256) -> "ARConfig":
        return ARConfig(vocab_size=vocab_size, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                        ffn_hidden=128, max_seq_len=128)

    @staticmethod
    def pixtral_12b() -> "ARConfig":
        """Pixtral-12B's text decoder: 40 layers, dim 5120, 32 heads, 8 KV
        heads of 128, FFN 14336, vocab 131072, 4300 cache slots, bf16."""
        return ARConfig(vocab_size=131072, dim=5120, n_layers=40, n_heads=32, n_kv_heads=8,
                        head_dim=128, ffn_hidden=14336, max_seq_len=4300, rope_theta=1e9,
                        dtype=torch.bfloat16)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().pow(2).mean(-1, keepdim=True)
        out = x * torch.rsqrt(var + self.eps).to(x.dtype)
        return out * self.weight.to(x.dtype)


@functools.lru_cache(maxsize=8)
def _rope_tables_for(cfg: ARConfig) -> np.ndarray:
    """(L, D, 2) cos / sin tables of the config's RoPE (v1 1D at
    (rope_theta, max_seq_len) by default)."""
    spec = cfg.rope_spec or RopeSpec(variant="v1", rope_dim="1D", theta=cfg.rope_theta,
                                     max_position_embeddings=cfg.max_seq_len)
    return build_rope_tables(spec, cfg.hd, cfg.max_seq_len)


def rope_frequencies(head_dim: int, max_seq: int, theta: float) -> np.ndarray:
    """(max_seq, head_dim // 2, 2) f32 cos / sin of the pair angles (the
    ViT's tables)."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    freqs = np.outer(np.arange(max_seq), inv)
    return np.stack([np.cos(freqs), np.sin(freqs)], -1).astype(np.float32)


def apply_rope(x: torch.Tensor, rope: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); rope (max_seq, D/2, 2); positions (S,) or (B, S).
    Interleaved pair rotation, the result in x's dtype."""
    cs = rope[positions]
    if cs.ndim == 3:
        cs = cs[None]
    cos = cs[..., 0][:, :, None, :]
    sin = cs[..., 1][:, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, max_seq, n_kv, hd)
    v: torch.Tensor


def init_cache(cfg: ARConfig, batch: int, device=None) -> list[KVCache]:
    shape = (batch, cfg.max_seq_len, cfg.n_kv_heads, cfg.hd)
    return [KVCache(torch.zeros(shape, dtype=cfg.dtype, device=device),
                    torch.zeros(shape, dtype=cfg.dtype, device=device))
            for _ in range(cfg.n_layers)]


def _linear(n_in: int, n_out: int, dtype: torch.dtype) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=False, dtype=dtype)


def grouped_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    """softmax(q.k^T / sqrt(d)) v for q (B, Sq, H, D) and k, v (B, Skv, G,
    D), query head h on K/V head h // (H / G): logits in f32 from the
    inputs' values, masked where `mask` (Sq, Skv) is False to -1e30, the
    probabilities cast to `dtype` for p.v. Returns (B, Sq, H, D)."""
    b, sq, h, d = q.shape
    g = k.shape[2]
    qg = q.reshape(b, sq, g, h // g, d).permute(0, 2, 3, 1, 4).float()   # (B, G, R, Sq, D)
    kg = k.permute(0, 2, 3, 1).float()                                     # (B, G, D, Skv)
    logits = torch.matmul(qg, kg[:, :, None]) / math.sqrt(d)               # (B, G, R, Sq, Skv)
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    out = torch.matmul(probs, v.permute(0, 2, 1, 3).to(dtype)[:, :, None])  # (B, G, R, Sq, D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)


class GQAAttention(nn.Module):
    def __init__(self, cfg: ARConfig):
        super().__init__()
        self.cfg = cfg
        hd = cfg.hd
        self.wq = _linear(cfg.dim, cfg.n_heads * hd, cfg.dtype)
        self.wk = _linear(cfg.dim, cfg.n_kv_heads * hd, cfg.dtype)
        self.wv = _linear(cfg.dim, cfg.n_kv_heads * hd, cfg.dtype)
        self.wo = _linear(cfg.n_heads * hd, cfg.dim, cfg.dtype)

    def forward(self, x, rope, positions, cache: KVCache | None, cur_len: int):
        cfg = self.cfg
        hd = cfg.hd
        b, s, _ = x.shape
        x = x.to(cfg.dtype)
        q = self.wq(x).reshape(b, s, cfg.n_heads, hd)
        k = self.wk(x).reshape(b, s, cfg.n_kv_heads, hd)
        v = self.wv(x).reshape(b, s, cfg.n_kv_heads, hd)
        variant = cfg.rope_spec.variant if cfg.rope_spec is not None else "v1"
        q = apply_rope_tables(q, rope, positions, variant)
        k = apply_rope_tables(k, rope, positions, variant)
        q_pos = positions if positions.ndim == 1 else positions[0]
        if cache is not None:
            # the static cache updated in place at cur_len
            if cur_len + s > cache.k.shape[1]:
                raise ValueError(f"{cur_len + s} positions do not fit the cache's "
                                 f"{cache.k.shape[1]} slots")
            cache.k[:, cur_len: cur_len + s] = k.to(cache.k.dtype)
            cache.v[:, cur_len: cur_len + s] = v.to(cache.v.dtype)
            k_all, v_all = cache.k, cache.v
            key_pos = torch.arange(cache.k.shape[1], device=x.device)
        else:
            k_all, v_all, key_pos = k, v, q_pos
        mask = key_pos[None, :] <= q_pos[:, None]  # causal over absolute positions
        out = grouped_attention(q, k_all, v_all, mask, cfg.dtype)
        return self.wo(out.reshape(b, s, cfg.n_heads * hd)), cache


class SwiGLUMLP(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.w1 = _linear(dim, hidden, dtype)
        self.w3 = _linear(dim, hidden, dtype)
        self.w2 = _linear(hidden, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class TransformerBlock(nn.Module):
    def __init__(self, cfg: ARConfig):
        super().__init__()
        self.attention = GQAAttention(cfg)
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype)
        self.feed_forward = SwiGLUMLP(cfg.dim, cfg.ffn_hidden, cfg.dtype)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype)

    def forward(self, x, rope, positions, cache, cur_len):
        h, new_cache = self.attention(self.attention_norm(x), rope, positions, cache, cur_len)
        x = x + h
        x = x + self.feed_forward(self.ffn_norm(x))
        return x, new_cache


class Transformer(nn.Module):
    """Decoder-only transformer, called with token ids or with embeddings
    (the VLM's image features stitched into the prompt)."""

    def __init__(self, cfg: ARConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_embeddings = nn.Embedding(cfg.vocab_size, cfg.dim, dtype=cfg.dtype)
        for i in range(cfg.n_layers):
            setattr(self, f"layers_{i}", TransformerBlock(cfg))
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype)
        self.output = _linear(cfg.dim, cfg.vocab_size, cfg.dtype)
        self._rope: torch.Tensor | None = None

    def rope(self, device: torch.device) -> torch.Tensor:
        """The RoPE table on `device` (made on first use: not a buffer, so
        no dtype cast of the module reaches it)."""
        if self._rope is None or self._rope.device != device:
            self._rope = torch.from_numpy(_rope_tables_for(self.cfg)).to(device)
        return self._rope

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.tok_embeddings(tokens)

    def forward(self, tokens=None, embeddings=None, caches=None, cur_len: int = 0,
                positions=None):
        """-> (logits (B, S, vocab) f32, caches: updated in place, or
        Nones without)."""
        x = self.embed(tokens) if embeddings is None else embeddings
        s = x.shape[1]
        if positions is None:
            positions = torch.arange(s, device=x.device) + cur_len
        rope = self.rope(x.device)
        new_caches = []
        for i in range(self.cfg.n_layers):
            cache = caches[i] if caches is not None else None
            x, nc = getattr(self, f"layers_{i}")(x, rope, positions, cache, cur_len)
            new_caches.append(nc)
        logits = self.output(self.norm(x))
        return logits.float(), new_caches


# ------------------------------------------------------------------ sampling


def gumbel_noise(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)) for u uniform in [tiny, 1), as
    `jax.random.gumbel` draws them."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def _categorical(logits, generator, gumbel):
    if gumbel is None:
        gumbel = gumbel_noise(logits.shape, generator, logits.device)
    return torch.argmax(logits + torch.as_tensor(gumbel, device=logits.device), dim=-1)


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """The logits kept by the nucleus (the largest whose probabilities
    before them sum to at most top_p; the first always), others -inf."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cutoff = (torch.cumsum(sorted_probs, dim=-1) - sorted_probs) > top_p
    kept_min = torch.where(cutoff, torch.inf, sorted_logits).min(dim=-1, keepdim=True).values
    return torch.where(logits >= kept_min, logits, -torch.inf)


def sample_top_p(logits: torch.Tensor, generator: torch.Generator | None = None,
                 temperature: float = 1.0, top_p: float = 0.9,
                 gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """Nucleus sampling; greedy at temperature <= 1e-5. `gumbel` (the
    logits' shape) replaces the draw from `generator`."""
    if temperature <= 1e-5:
        return torch.argmax(logits, dim=-1)
    return _categorical(top_p_filter(logits / temperature, top_p), generator, gumbel)


def sample_top_k(logits: torch.Tensor, generator: torch.Generator | None = None,
                 temperature: float = 1.0, top_k: int = 50,
                 gumbel: torch.Tensor | None = None) -> torch.Tensor:
    if temperature <= 1e-5:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
    return _categorical(torch.where(logits >= kth, logits, -torch.inf), generator, gumbel)


class ARGenerator:
    """Prefill, then one token a step against the static cache.
    `last_times` holds the last call's prefill and decode seconds (after a
    device synchronise)."""

    def __init__(self, model: Transformer):
        self.model = model
        self.cfg = model.cfg
        self.last_times: dict = {}

    @staticmethod
    def _clock(device: torch.device) -> float:
        """The host's clock once the device has finished its queued work."""
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    @torch.inference_mode()
    def generate(self, prompt_tokens=None, prompt_embeddings: torch.Tensor | None = None,
                 max_gen_len: int = 100, temperature: float = 0.6, top_p: float = 0.9,
                 stop_tokens: tuple = (), generator: torch.Generator | None = None,
                 gumbel=None) -> np.ndarray:
        """-> (B, max_gen_len) token ids; with batch 1 trimmed after the
        first stop token. Every step runs whatever the tokens (as JAX's
        scan does); `gumbel[i]` (B, vocab), when given, is step i's noise."""
        device = next(self.model.parameters()).device
        if prompt_embeddings is not None:
            b, prompt_len = prompt_embeddings.shape[:2]
            tokens = None
        else:
            tokens = torch.as_tensor(np.asarray(prompt_tokens), device=device)
            b, prompt_len = tokens.shape
        if prompt_len + max_gen_len - 1 > self.cfg.max_seq_len:
            raise ValueError(f"a prompt of {prompt_len} and {max_gen_len} tokens do not fit "
                             f"max_seq_len {self.cfg.max_seq_len}")
        caches = init_cache(self.cfg, b, device)

        def noise(i):
            return None if gumbel is None else gumbel[i]

        t0 = self._clock(device)
        logits, caches = self.model(tokens=tokens, embeddings=prompt_embeddings,
                                    caches=caches, cur_len=0)
        cur = sample_top_p(logits[:, -1], generator, temperature, top_p, noise(0))
        t1 = self._clock(device)
        out = [cur]
        # the positions stay on the device: a host tensor copied each step
        # would wait for the queued step
        first = torch.full((1,), prompt_len, device=device)
        for i in range(1, max_gen_len):
            pos = prompt_len + i - 1
            logits, caches = self.model(tokens=cur[:, None], caches=caches, cur_len=pos,
                                        positions=first + (i - 1))
            cur = sample_top_p(logits[:, -1], generator, temperature, top_p, noise(i))
            out.append(cur)
        out_np = torch.stack(out, dim=1).cpu().numpy()
        t2 = self._clock(device)
        self.last_times = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                           "decode_steps": max_gen_len - 1}
        # trim at the first stop token (batch 1 only, as in JAX)
        if stop_tokens and b == 1:
            hits = np.nonzero(np.isin(out_np[0], list(stop_tokens)))[0]
            if hits.size:
                out_np = out_np[:, : hits[0] + 1]
        return out_np
