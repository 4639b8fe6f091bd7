"""Shared building blocks of the diffusion models (counterpart of
tclight_tpu/models/layers.py): resnet blocks, up/downsampling, timestep
embeddings and the GEGLU feed-forward.

Modules take NCHW activations. Attribute names follow the JAX package's
parameter names, so `models/bridge.py` maps a parameter tree one to one.

Hazard: flax's GroupNorm / LayerNorm epsilons are set per layer; the ones
here are copied layer by layer (1e-5 in the UNet resnets and transformer
LayerNorms, 1e-6 in `Transformer2D.norm` and throughout the VAE).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers Timesteps, SD settings).
    timesteps: (B,) -> (B, dim) f32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """2-layer MLP lifting the sinusoidal embedding to time_embed_dim."""

    def __init__(self, in_features: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_features, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


class ResnetBlock2D(nn.Module):
    """GroupNorm-SiLU-Conv resnet block with timestep conditioning."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 groups: int = 32):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=1e-5)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_channels)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=1e-5)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return h + residual


class Downsample2D(nn.Module):
    """Stride-2 conv with SD's asymmetric (0, 1) padding."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


def upsample_nearest(x: torch.Tensor, out_size: tuple[int, int] | None = None
                     ) -> torch.Tensor:
    """Nearest 2x upsample, or a nearest resize to an odd skip size.

    Hazard: `jax.image.resize(method="nearest")` samples at half-pixel
    centres, which is torch's "nearest-exact"; torch's "nearest" floors
    without the half-pixel offset and picks other rows (e.g. 45 rows from
    22 at the 960x720 level-2 -> 1 upsample)."""
    h, w = x.shape[-2:]
    th, tw = out_size if out_size is not None else (2 * h, 2 * w)
    if (th, tw) == (2 * h, 2 * w):
        return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    return F.interpolate(x, size=(th, tw), mode="nearest-exact")


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor, out_size: tuple[int, int] | None = None
                ) -> torch.Tensor:
        return self.conv(upsample_nearest(x, out_size))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU feed-forward (mult=4), as in SD transformer blocks."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net_0 = GEGLU(dim, dim * mult)
        self.net_2 = nn.Linear(dim * mult, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net_2(self.net_0(x))
