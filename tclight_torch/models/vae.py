"""AutoencoderKL (SD VAE) (counterpart of tclight_tpu/models/vae.py).

Images in [-1, 1], NHWC at the boundary, NCHW inside. The scaling factor
0.18215 is applied by the pipeline. The mid-block attention is a plain
single-head matmul + softmax, as in the JAX package (an XLA einsum there,
not a TPU kernel). GroupNorm epsilon is 1e-6 throughout.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.18215
    dtype: torch.dtype = torch.float32

    @staticmethod
    def sd15(dtype=torch.bfloat16) -> "VAEConfig":
        return VAEConfig(dtype=dtype)

    @staticmethod
    def tiny(dtype=torch.float32) -> "VAEConfig":
        return VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                         norm_groups=8, dtype=dtype)


class VAEResnet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=1e-6)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=1e-6)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return h + residual


class VAEAttention(nn.Module):
    """Single-head self-attention over spatial positions (mid block)."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out_0 = nn.Linear(channels, channels)

    def forward(self, x):
        b, c, h, w = x.shape
        z = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.to_q(z), self.to_k(z), self.to_v(z)
        logits = torch.matmul(q.float(), k.float().transpose(1, 2))
        probs = torch.softmax(logits / c ** 0.5, dim=-1).to(z.dtype)
        z = self.to_out_0(torch.matmul(probs, v))
        return z.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        ch = cfg.block_out_channels
        g = cfg.norm_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        cur = ch[0]
        for lvl in range(len(ch)):
            for blk in range(cfg.layers_per_block):
                self.add_module(f"down_{lvl}_res_{blk}", VAEResnet(cur, ch[lvl], g))
                cur = ch[lvl]
            if lvl < len(ch) - 1:
                self.add_module(f"down_{lvl}_ds", nn.Conv2d(cur, cur, 3, stride=2))
        self.mid_res_0 = VAEResnet(cur, ch[-1], g)
        self.mid_attn = VAEAttention(ch[-1], g)
        self.mid_res_1 = VAEResnet(ch[-1], ch[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels,
                                    2 * cfg.latent_channels, 1)

    def forward(self, x):
        cfg = self.config
        ch = cfg.block_out_channels
        h = self.conv_in(x)
        for lvl in range(len(ch)):
            for blk in range(cfg.layers_per_block):
                h = getattr(self, f"down_{lvl}_res_{blk}")(h)
            if lvl < len(ch) - 1:
                h = getattr(self, f"down_{lvl}_ds")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return self.quant_conv(h)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        ch = cfg.block_out_channels
        g = cfg.norm_groups
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels,
                                         cfg.latent_channels, 1)
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch[-1], 3, padding=1)
        self.mid_res_0 = VAEResnet(ch[-1], ch[-1], g)
        self.mid_attn = VAEAttention(ch[-1], g)
        self.mid_res_1 = VAEResnet(ch[-1], ch[-1], g)
        cur = ch[-1]
        for lvl in reversed(range(len(ch))):
            for blk in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{lvl}_res_{blk}", VAEResnet(cur, ch[lvl], g))
                cur = ch[lvl]
            if lvl > 0:
                self.add_module(f"up_{lvl}_us", nn.Conv2d(cur, cur, 3, padding=1))
        self.conv_norm_out = nn.GroupNorm(g, ch[0], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[0], cfg.in_channels, 3, padding=1)

    def forward(self, z):
        cfg = self.config
        ch = cfg.block_out_channels
        h = self.conv_in(self.post_quant_conv(z))
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        for lvl in reversed(range(len(ch))):
            for blk in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{lvl}_res_{blk}")(h)
            if lvl > 0:
                h = h.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
                h = getattr(self, f"up_{lvl}_us")(h)
        return self.conv_out(F.silu(self.conv_norm_out(h))).float()


class AutoencoderKL(nn.Module):
    """encode(x) -> (mean, logvar); decode(z) -> image. NHWC, [-1, 1]."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.to(config.dtype)

    def encode(self, x: torch.Tensor):
        moments = self.encoder(x.permute(0, 3, 1, 2).to(self.config.dtype))
        mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean.float(), torch.clamp(logvar, -30.0, 20.0).float()

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        img = self.decoder(z.permute(0, 3, 1, 2).to(self.config.dtype))
        return img.permute(0, 2, 3, 1)
