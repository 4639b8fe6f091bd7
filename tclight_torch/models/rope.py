"""Rotary position embeddings of the AR stack (counterpart of
tclight_tpu/models/rope.py).

- 1D RoPE with the optional YaRN long-context extension (scale factors
  smoothed between the beta_slow / beta_fast cutoffs, and the mscale
  magnitude correction);
- 2D spatial and 3D video RoPE (the T / H / W bands);
- the two conventions: v1 rotates interleaved pairs (mistral / llama), v2
  rotates the two halves (TransformerEngine).

The tables are host numpy, (L, D, 2) cos / sin with mscale applied, built
as the JAX package builds them (float64, then float32); `apply_rope_tables`
reads them for torch tensors. Dimensions past the table's width pass
through unrotated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

__all__ = ["RopeSpec", "build_rope_tables", "apply_rope_tables",
           "yarn_scale_factors", "yarn_mscale"]


@dataclasses.dataclass(frozen=True)
class RopeSpec:
    variant: str = "v1"              # "v1" (interleaved) | "v2" (half split)
    rope_dim: str = "1D"             # "1D" | "2D" | "3D"
    theta: float = 10000.0
    max_position_embeddings: Optional[int] = None
    original_max_position_embeddings: Optional[int] = None
    apply_yarn: bool = False
    scale: Optional[float] = None
    extrapolation_factor: int = 1
    attn_factor: int = 1
    beta_fast: int = 32
    beta_slow: int = 1
    latent_shape: Optional[tuple] = None            # (H, W) or (T, H, W)
    original_latent_shape: Optional[tuple] = None
    pad_to_multiple_of: Optional[int] = None
    # a leading zero-frequency position (a begin-of-video token)
    prepend_bov: bool = False


def yarn_scale_factors(inv_freq: np.ndarray, original_seq_len: int, beta_fast: int,
                       beta_slow: int, scale: float) -> np.ndarray:
    """YaRN's per-frequency factors: 1 / scale below the low cutoff, 1
    above the high one, linear between."""
    high = 2 * math.pi * beta_fast / original_seq_len
    low = 2 * math.pi * beta_slow / original_seq_len
    smooth = np.clip((inv_freq - low) / (high - low), 0.0, 1.0)
    return (1.0 - smooth) / scale + smooth


def yarn_mscale(scale: float, attn_factor: float = 1.0) -> float:
    if scale is None or scale <= 1:
        return 1.0 * attn_factor
    return (0.1 * math.log(scale) + 1.0) * attn_factor


def _freqs_and_mscale(spec: RopeSpec, head_dim: int, max_seq: int):
    """Rotation angles per position and the mscale: 1D -> (S, D/2); 2D and
    3D -> (L, D), the bands concatenated twice."""
    if spec.rope_dim == "1D":
        inv = 1.0 / (spec.theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
        mscale = 1.0
        if spec.apply_yarn:
            inv = inv * yarn_scale_factors(inv, spec.original_max_position_embeddings,
                                           spec.beta_fast, spec.beta_slow, spec.scale)
            mscale = yarn_mscale(spec.scale, spec.attn_factor)
        return np.outer(np.arange(max_seq, dtype=np.float64), inv), mscale

    if spec.rope_dim == "2D":
        h, w = spec.latent_shape
        dim_h = head_dim // 2
        # as the reference: (theta ** range) / dim, in float32, where
        # theta ** k overflows to inf (frequency 0) past the first bands
        with np.errstate(over="ignore"):
            spatial_inv = (1.0 / (np.float32(spec.theta)
                                  ** np.arange(0, dim_h, 2, dtype=np.float32) / dim_h)
                           ).astype(np.float64)
        mscale = 1.0
        if spec.apply_yarn:
            spatial_inv = spatial_inv * yarn_scale_factors(
                spatial_inv, spec.original_latent_shape[0], spec.beta_fast, spec.beta_slow,
                spec.scale)
            mscale = yarn_mscale(spec.scale, spec.attn_factor)
        seq = np.arange(max(h, w), dtype=np.float64)
        emb_h = np.outer(seq[:h], spatial_inv)
        emb_w = np.outer(seq[:w], spatial_inv)
        grid = np.concatenate(
            [np.broadcast_to(emb_h[:, None, :], (h, w, emb_h.shape[-1])),
             np.broadcast_to(emb_w[None, :, :], (h, w, emb_w.shape[-1]))] * 2, axis=-1)
        return grid.reshape(h * w, -1), mscale

    if spec.rope_dim == "3D":
        t, h, w = spec.latent_shape
        dim_h = head_dim // 6 * 2
        dim_t = head_dim - 2 * dim_h
        sp_range = np.arange(0, dim_h, 2, dtype=np.float64)[: dim_h // 2] / dim_h
        spatial_inv = 1.0 / (spec.theta ** sp_range)
        t_range = np.arange(0, dim_t, 2, dtype=np.float64)[: dim_t // 2] / dim_t
        temporal_inv = 1.0 / (spec.theta ** t_range)
        mscale = 1.0
        if spec.apply_yarn:
            spatial_inv = spatial_inv * yarn_scale_factors(
                spatial_inv, spec.original_latent_shape[1], spec.beta_fast, spec.beta_slow,
                spec.scale)
            temporal_inv = temporal_inv * yarn_scale_factors(
                temporal_inv, spec.original_latent_shape[0], spec.beta_fast, spec.beta_slow,
                spec.scale)
            mscale = yarn_mscale(spec.scale, spec.attn_factor)
        seq = np.arange(max(t, h, w), dtype=np.float64)
        emb_t = np.outer(seq[:t], temporal_inv)
        emb_h = np.outer(seq[:h], spatial_inv)
        emb_w = np.outer(seq[:w], spatial_inv)
        grid = np.concatenate(
            [np.broadcast_to(emb_t[:, None, None, :], (t, h, w, emb_t.shape[-1])),
             np.broadcast_to(emb_h[None, :, None, :], (t, h, w, emb_h.shape[-1])),
             np.broadcast_to(emb_w[None, None, :, :], (t, h, w, emb_w.shape[-1]))] * 2,
            axis=-1)
        return grid.reshape(t * h * w, -1), mscale

    raise ValueError(f"invalid rope_dim {spec.rope_dim}")


def build_rope_tables(spec: RopeSpec, head_dim: int,
                      max_seq: Optional[int] = None) -> np.ndarray:
    """(L, D, 2) float32 cos / sin tables, mscale applied. v1 1D repeats
    each pair's angle interleaved, v2 1D concatenates the halves; the 2D
    and 3D angles are already full width."""
    if spec.rope_dim == "1D":
        if max_seq is None:
            max_seq = spec.max_position_embeddings
        freqs, mscale = _freqs_and_mscale(spec, head_dim, max_seq)
        if spec.variant == "v1":
            emb = np.stack([freqs, freqs], axis=-1).reshape(freqs.shape[0], -1)
        else:
            emb = np.concatenate([freqs, freqs], axis=-1)
    else:
        emb, mscale = _freqs_and_mscale(spec, head_dim, 0)
        if spec.prepend_bov:
            emb = np.concatenate([np.zeros((1, emb.shape[-1])), emb], axis=0)
        if spec.pad_to_multiple_of:
            pad = (-emb.shape[0]) % spec.pad_to_multiple_of
            if pad:
                emb = np.concatenate([emb, np.zeros((pad, emb.shape[-1]))], axis=0)
    return np.stack([np.cos(emb) * mscale, np.sin(emb) * mscale], axis=-1).astype(np.float32)


def apply_rope_tables(x: torch.Tensor, rope: torch.Tensor, positions: torch.Tensor,
                      variant: str = "v1") -> torch.Tensor:
    """x (B, S, H, D); rope (L, D', 2) on x's device; positions (S,) or
    (B, S). v1 rotates interleaved pairs, v2 the halves; dimensions past
    D' pass through. The products run in the promoted dtype of x and the
    f32 table (f32), and the result is cast back to x's dtype, as in JAX."""
    cs = rope[positions]
    if cs.ndim == 3:
        cs = cs[None]
    rot_dim = rope.shape[1]
    t, t_pass = x[..., :rot_dim], x[..., rot_dim:]
    cos = cs[..., 0][:, :, None, :]
    sin = cs[..., 1][:, :, None, :]
    if variant == "v1":
        tr = t.reshape(t.shape[:-1] + (-1, 2))
        rot = torch.stack([-tr[..., 1], tr[..., 0]], dim=-1).reshape(t.shape)
    else:
        half = rot_dim // 2
        rot = torch.cat([-t[..., half:], t[..., :half]], dim=-1)
    out = t * cos + rot * sin
    if t_pass.shape[-1]:
        out = torch.cat([out, t_pass.to(out.dtype)], dim=-1)
    return out.to(x.dtype)
