"""The Cosmos causal video tokenizer's networks (counterpart of the part of
tclight_tpu/cosmos/dv_tokenizer.py that the continuous tokenizer builds
on): the causal 3D Haar wavelet patching, `CausalConv3d`, the per-frame
norm, the hybrid down / up samplers, the factorized resnet block, the
spatial and causal temporal attention blocks, `DVTokenizerConfig`,
`EncoderFactorized` and `DecoderFactorized`; the FSQ quantizer (eps
1e-3 bound, codes in [-1, 1]), `CausalDiscreteVideoTokenizer` (encode ->
(indices, codes, loss)) and the chunked `DiscreteVideoFSQTokenizer`.

The modules carry the reference's names (tokenizer/modules.py), so their
state dicts have the Cosmos checkpoint's keys (`convert_dv.py`). Inside,
tensors are PyTorch's (B, C, T, H, W); the encoder takes and the decoder
gives JAX's channel-last (B, T, H, W, C). Every convolution is causal in
time: time is left-padded with copies of the first frame, so chunk by
chunk streaming matches the whole sequence. The attention blocks are one
head over C channels, `scaled_dot_product_attention` (the JAX package's
is an einsum and a softmax, with no TPU kernel behind it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["FSQuantizer", "patcher3d", "unpatcher3d", "CausalConv3d", "CausalNormalize",
           "CausalHybridDownsample3d", "CausalHybridUpsample3d", "CausalResnetBlockFactorized3d",
           "CausalAttnBlock", "CausalTemporalAttnBlock", "DVTokenizerConfig",
           "EncoderFactorized", "DecoderFactorized", "CausalDiscreteVideoTokenizer",
           "DiscreteVideoFSQTokenizer"]

# ---------------------------------------------------------------- FSQ


class FSQuantizer:
    """Finite scalar quantization over the last axis, parameter-free when
    the latent width equals len(levels) (the Cosmos DV config: 6 channels,
    levels (8, 8, 8, 5, 5, 5), 64,000 codes)."""

    def __init__(self, levels: Sequence[int] = (8, 8, 8, 5, 5, 5)):
        self.levels = np.asarray(levels, np.int32)
        self.dim = len(levels)
        self.basis = np.concatenate([[1], np.cumprod(self.levels[:-1])]).astype(np.int32)
        self.codebook_size = int(np.prod(self.levels.astype(np.int64)))
        assert self.codebook_size < 2 ** 31, "codebook must fit int32"

    def bound(self, z: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
        """tanh into [-half_l, half_l], shifted by arctanh(offset / half_l)
        so that even levels sit between integers (the shift in f64, then
        f32, as JAX takes it from numpy)."""
        lv = self.levels.astype(np.float32)
        half_l = (lv - 1) * (1 + eps) / 2
        offset = np.where(lv % 2 == 0, 0.5, 0.0)
        shift = np.arctanh(offset / half_l)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=z.device)

        return torch.tanh(z + t(shift)) * t(half_l) - t(offset)

    def _half_width(self, device) -> torch.Tensor:
        return torch.as_tensor((self.levels // 2).astype(np.float32), device=device)

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        """Round (straight through), then renormalise to [-1, 1]."""
        zb = self.bound(z)
        q = zb + (torch.round(zb) - zb).detach()
        return q / self._half_width(z.device)

    def codes_to_indices(self, zhat: torch.Tensor) -> torch.Tensor:
        hw = self._half_width(zhat.device)
        digits = zhat * hw + hw
        basis = torch.as_tensor(self.basis, device=zhat.device)
        return (digits.to(torch.int32) * basis).sum(-1, dtype=torch.int32)

    def indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        hw = self._half_width(indices.device)
        basis = torch.as_tensor(self.basis, device=indices.device)
        lv = torch.as_tensor(self.levels, device=indices.device)
        digits = (indices.to(torch.int32)[..., None] // basis) % lv
        return (digits.float() - hw) / hw

    def __call__(self, z: torch.Tensor):
        """z (..., dim) -> (indices, quantized, a zero loss)."""
        q = self.quantize(z)
        loss = torch.zeros(z.shape[:1] + (1,) * (z.dim() - 1), dtype=z.dtype, device=z.device)
        return self.codes_to_indices(q), q, loss


_H = 1.0 / math.sqrt(2.0)

# ---------------------------------------------------------------- Haar patching


def _reflect_tail(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x with one more element along `dim`, the reflection of the last but
    one (F.pad(..., (0, 1), mode='reflect') along `dim`)."""
    return torch.cat([x, x.narrow(dim, x.shape[dim] - 2, 1)], dim=dim)


def _dwt1d(x: torch.Tensor, dim: int):
    """One causal Haar analysis step along `dim`: (lo, hi), each of length
    ceil(L / 2); an odd length is first reflect-padded by one."""
    if x.shape[dim] % 2:
        x = _reflect_tail(x, dim)
    n = x.shape[dim] // 2
    pair = x.unflatten(dim, (n, 2))
    even, odd = pair.select(dim + 1, 0), pair.select(dim + 1, 1)
    return (even + odd) * _H, (even - odd) * _H


def _idwt1d(lo: torch.Tensor, hi: torch.Tensor, dim: int) -> torch.Tensor:
    """Inverse of `_dwt1d` (the length doubles)."""
    even, odd = (lo + hi) * _H, (lo - hi) * _H
    return torch.stack([even, odd], dim=dim + 1).flatten(dim, dim + 1)


def _dwt3d(x: torch.Tensor) -> torch.Tensor:
    """One 3D level on (B, C, T, H, W): t, then h, then w; sub-bands
    channel-major [lll .. hhh], each scaled by 1 / (2 sqrt 2)."""
    parts = [x]
    for dim in (2, 3, 4):
        parts = [band for p in parts for band in _dwt1d(p, dim)]
    return torch.cat(parts, dim=1) / (2.0 * math.sqrt(2.0))


def _idwt3d(x: torch.Tensor) -> torch.Tensor:
    parts = list(x.chunk(8, dim=1))
    for dim in (4, 3, 2):
        parts = [_idwt1d(parts[i], parts[i + 1], dim) for i in range(0, len(parts), 2)]
    return parts[0] * (2.0 * math.sqrt(2.0))


def patcher3d(x: torch.Tensor, patch_size: int = 1, method: str = "haar") -> torch.Tensor:
    """Causal 3D patching of (B, C, T, H, W): the first frame repeated
    `patch_size` times, then log2(patch_size) Haar levels (or the pixel
    shuffle of "rearrange")."""
    if patch_size == 1:
        return x
    x = torch.cat([x[:, :, :1].expand(-1, -1, patch_size, -1, -1), x[:, :, 1:]], dim=2)
    if method == "haar":
        for _ in range(int(math.log2(patch_size))):
            x = _dwt3d(x)
        return x
    if method == "rearrange":
        b, c, t, h, w = x.shape
        p = patch_size
        x = x.reshape(b, c, t // p, p, h // p, p, w // p, p)
        return x.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(b, c * p ** 3, t // p, h // p, w // p)
    raise ValueError(f"unknown patch method: {method}")


def unpatcher3d(x: torch.Tensor, patch_size: int = 1, method: str = "haar") -> torch.Tensor:
    """Inverse of `patcher3d`, dropping the repeated first frames."""
    if patch_size == 1:
        return x
    if method == "haar":
        for _ in range(int(math.log2(patch_size))):
            x = _idwt3d(x)
        return x[:, :, patch_size - 1:]
    if method == "rearrange":
        b, c, t, h, w = x.shape
        p = patch_size
        x = x.reshape(b, c // p ** 3, p, p, p, t, h, w)
        x = x.permute(0, 1, 5, 2, 6, 3, 7, 4).reshape(b, c // p ** 3, t * p, h * p, w * p)
        return x[:, :, patch_size - 1:]
    raise ValueError(f"unknown patch method: {method}")


# ---------------------------------------------------------------- causal blocks


class CausalConv3d(nn.Module):
    """A 3D convolution that only looks back in time: time is left-padded
    with (kt - 1) + (1 - time_stride) copies of the first frame, height
    and width with `padding` zeros on each side."""

    def __init__(self, cin: int, cout: int, kernel_size=(3, 3, 3), stride: int = 1,
                 time_stride: int = 1, padding: int = 1):
        super().__init__()
        self.time_pad = (kernel_size[0] - 1) + (1 - time_stride)
        self.padding = padding
        self.conv3d = nn.Conv3d(cin, cout, kernel_size, stride=(time_stride, stride, stride))

    def forward(self, x):
        if self.time_pad > 0:
            x = torch.cat([x[:, :, :1].expand(-1, -1, self.time_pad, -1, -1), x], dim=2)
        if self.padding:
            p = self.padding
            x = F.pad(x, (p, p, p, p))
        return self.conv3d(x)


class CausalNormalize(nn.Module):
    """GroupNorm (eps 1e-6); with one group, over each frame's (C, H, W)
    alone, so no statistic crosses time."""

    def __init__(self, channels: int, num_groups: int = 1):
        super().__init__()
        self.num_groups = num_groups
        self.norm = nn.GroupNorm(num_groups, channels, eps=1e-6)

    def forward(self, x):
        if self.num_groups != 1:
            return self.norm(x)
        var, mean = torch.var_mean(x, dim=(1, 3, 4), correction=0, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.norm.eps)
        shape = (1, -1, 1, 1, 1)
        return y * self.norm.weight.view(shape) + self.norm.bias.view(shape)


class CausalHybridDownsample3d(nn.Module):
    """Strided convolution plus average pooling, spatial then temporal."""

    def __init__(self, ch: int, spatial_down: bool = True, temporal_down: bool = True):
        super().__init__()
        self.spatial_down, self.temporal_down = spatial_down, temporal_down
        if spatial_down:
            self.conv1 = CausalConv3d(ch, ch, (1, 3, 3), stride=2, padding=0)
        if temporal_down:
            self.conv2 = CausalConv3d(ch, ch, (3, 1, 1), time_stride=2, padding=0)
        if spatial_down or temporal_down:
            self.conv3 = CausalConv3d(ch, ch, (1, 1, 1), padding=0)

    def forward(self, x):
        if not self.spatial_down and not self.temporal_down:
            return x
        if self.spatial_down:
            xp = F.pad(x, (0, 1, 0, 1))
            x = self.conv1(xp) + F.avg_pool3d(xp, (1, 2, 2), stride=(1, 2, 2))
        if self.temporal_down:
            xp = torch.cat([x[:, :, :1], x], dim=2)
            x = self.conv2(xp) + F.avg_pool3d(xp, (2, 1, 1), stride=(2, 1, 1))
        return self.conv3(x)


class CausalHybridUpsample3d(nn.Module):
    """Repeat-interleave plus a residual convolution; temporal upsampling
    gives 2T - 1 frames, which keeps the causal 1 + k * ratio contract."""

    def __init__(self, ch: int, spatial_up: bool = True, temporal_up: bool = True):
        super().__init__()
        self.spatial_up, self.temporal_up = spatial_up, temporal_up
        if temporal_up:
            self.conv1 = CausalConv3d(ch, ch, (3, 1, 1), padding=0)
        if spatial_up:
            self.conv2 = CausalConv3d(ch, ch, (1, 3, 3), padding=1)
        if spatial_up or temporal_up:
            self.conv3 = CausalConv3d(ch, ch, (1, 1, 1), padding=0)

    def forward(self, x):
        if not self.spatial_up and not self.temporal_up:
            return x
        if self.temporal_up:
            if x.shape[2] > 1:
                x = x.repeat_interleave(2, dim=2)[:, :, 1:]
            x = self.conv1(x) + x
        if self.spatial_up:
            x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
            x = self.conv2(x) + x
        return self.conv3(x)


class CausalResnetBlockFactorized3d(nn.Module):
    """Resnet block with factorized (1,3,3) + (3,1,1) convolutions."""

    def __init__(self, cin: int, cout: int, num_groups: int = 1):
        super().__init__()
        self.norm1 = CausalNormalize(cin, 1)
        self.conv1 = nn.Sequential(CausalConv3d(cin, cout, (1, 3, 3), padding=1),
                                   CausalConv3d(cout, cout, (3, 1, 1), padding=0))
        self.norm2 = CausalNormalize(cout, num_groups)
        self.conv2 = nn.Sequential(CausalConv3d(cout, cout, (1, 3, 3), padding=1),
                                   CausalConv3d(cout, cout, (3, 1, 1), padding=0))
        if cin != cout:
            self.nin_shortcut = CausalConv3d(cin, cout, (1, 1, 1), padding=0)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class _QKVBlock(nn.Module):
    def __init__(self, ch: int, num_groups: int = 1):
        super().__init__()
        self.norm = CausalNormalize(ch, num_groups)
        self.q, self.k, self.v, self.proj_out = (CausalConv3d(ch, ch, (1, 1, 1), padding=0)
                                                 for _ in range(4))

    def qkv(self, x):
        h = self.norm(x)
        return self.q(h), self.k(h), self.v(h)


class CausalAttnBlock(_QKVBlock):
    """Single-head spatial self-attention within each frame."""

    def forward(self, x):
        b, c, t, hh, ww = x.shape
        q, k, v = (a.permute(0, 2, 3, 4, 1).reshape(b * t, 1, hh * ww, c) for a in self.qkv(x))
        o = F.scaled_dot_product_attention(q, k, v)
        o = o.reshape(b, t, hh, ww, c).permute(0, 4, 1, 2, 3)
        return x + self.proj_out(o)


class CausalTemporalAttnBlock(_QKVBlock):
    """Single-head causal self-attention over time at each pixel."""

    def forward(self, x):
        b, c, t, hh, ww = x.shape
        q, k, v = (a.permute(0, 3, 4, 2, 1).reshape(b * hh * ww, 1, t, c) for a in self.qkv(x))
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        o = o.reshape(b, hh, ww, t, c).permute(0, 4, 3, 1, 2)
        return x + self.proj_out(o)


# ---------------------------------------------------------------- encoder / decoder


@dataclasses.dataclass(frozen=True)
class DVTokenizerConfig:
    """Cosmos DV8x16x16 defaults (configs/base/tokenizer.py:29-55)."""

    in_channels: int = 3
    out_channels: int = 3
    channels: int = 128
    channels_mult: tuple = (2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: tuple = (32,)
    resolution: int = 1024
    patch_size: int = 4
    patch_method: str = "haar"
    z_channels: int = 16
    z_factor: int = 1
    embedding_dim: int = 6
    levels: tuple = (8, 8, 8, 5, 5, 5)
    legacy_mode: bool = False
    spatial_compression: int = 16
    temporal_compression: int = 8
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny() -> "DVTokenizerConfig":
        """Every block type at small widths: attention at the first level,
        spatial and temporal downsampling at level 0, spatial only at 1,
        the mirrored temporal upsampling."""
        return DVTokenizerConfig(channels=16, channels_mult=(1, 1, 2), num_res_blocks=1,
                                 attn_resolutions=(16,), resolution=32, patch_size=2,
                                 z_channels=8, spatial_compression=8, temporal_compression=4)


def _attn_pair(ch: int) -> nn.Sequential:
    return nn.Sequential(CausalAttnBlock(ch), CausalTemporalAttnBlock(ch))


def _mid(ch: int) -> nn.Module:
    mid = nn.Module()
    mid.block_1 = CausalResnetBlockFactorized3d(ch, ch)
    mid.attn_1 = _attn_pair(ch)
    mid.block_2 = CausalResnetBlockFactorized3d(ch, ch)
    return mid


def _run_mid(mid: nn.Module, h):
    return mid.block_2(mid.attn_1(mid.block_1(h)))


def _factorized(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(CausalConv3d(cin, cout, (1, 3, 3), padding=1),
                         CausalConv3d(cout, cout, (3, 1, 1), padding=0))


class EncoderFactorized(nn.Module):
    """(B, T, H, W, in_channels) in [-1, 1] -> (B, C, t, h, w), C = z_channels."""

    def __init__(self, cfg: DVTokenizerConfig, z_channels: int):
        super().__init__()
        self.cfg = cfg
        n_res = len(cfg.channels_mult)
        logp = int(math.log2(cfg.patch_size))
        n_sdown = int(math.log2(cfg.spatial_compression)) - logp
        n_tdown = int(math.log2(cfg.temporal_compression)) - logp
        if n_sdown > n_res or n_tdown > n_res:
            raise ValueError("more downsamplings than levels")
        self.conv_in = _factorized(cfg.in_channels * cfg.patch_size ** 3, cfg.channels)
        self.down = nn.ModuleList()
        curr_res = cfg.resolution // cfg.patch_size
        block_in = cfg.channels
        for i in range(n_res):
            level = nn.Module()
            block_out = cfg.channels * cfg.channels_mult[i]
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            for _ in range(cfg.num_res_blocks):
                level.block.append(CausalResnetBlockFactorized3d(block_in, block_out))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(_attn_pair(block_in))
            if i != n_res - 1:
                level.downsample = CausalHybridDownsample3d(block_in, i < n_sdown, i < n_tdown)
                curr_res //= 2
            self.down.append(level)
        self.mid = _mid(block_in)
        self.norm_out = CausalNormalize(block_in, 1)
        self.conv_out = _factorized(block_in, z_channels)

    def forward(self, x):
        cfg = self.cfg
        h = patcher3d(x.permute(0, 4, 1, 2, 3), cfg.patch_size, cfg.patch_method)
        h = self.conv_in(h)
        for level in self.down:
            for j, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[j](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = _run_mid(self.mid, h)
        return self.conv_out(F.silu(self.norm_out(h)))


class DecoderFactorized(nn.Module):
    """(B, C, t, h, w) -> (B, T, H, W, out_channels), with the mirrored
    (`legacy_mode=False`) upsampling schedule: temporal upsampling at the
    reversed levels 1 .. n_tup, spatial wherever it must to reach the
    spatial compression."""

    def __init__(self, cfg: DVTokenizerConfig, z_channels: int):
        super().__init__()
        self.cfg = cfg
        n_res = len(cfg.channels_mult)
        logp = int(math.log2(cfg.patch_size))
        n_sup = int(math.log2(cfg.spatial_compression)) - logp
        n_tup = int(math.log2(cfg.temporal_compression)) - logp
        block_in = cfg.channels * cfg.channels_mult[-1]
        curr_res = (cfg.resolution // cfg.patch_size) // 2 ** (n_res - 1)
        self.conv_in = _factorized(z_channels, block_in)
        self.mid = _mid(block_in)
        levels = [None] * n_res
        for i in reversed(range(n_res)):
            level = nn.Module()
            block_out = cfg.channels * cfg.channels_mult[i]
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(CausalResnetBlockFactorized3d(block_in, block_out))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(_attn_pair(block_in))
            if i != 0:
                i_rev = n_res - i - 1
                temporal_up = i_rev < n_tup if cfg.legacy_mode else 0 < i_rev < n_tup + 1
                spatial_up = temporal_up or (i_rev < n_sup and n_sup > n_tup)
                level.upsample = CausalHybridUpsample3d(block_in, spatial_up, temporal_up)
                curr_res *= 2
            levels[i] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = CausalNormalize(block_in, 1)
        self.conv_out = _factorized(block_in, cfg.out_channels * cfg.patch_size ** 3)

    def forward(self, z):
        cfg = self.cfg
        h = _run_mid(self.mid, self.conv_in(z))
        for level in reversed(self.up):
            for j, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[j](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        h = self.conv_out(F.silu(self.norm_out(h)))
        return unpatcher3d(h, cfg.patch_size, cfg.patch_method).permute(0, 2, 3, 4, 1)


# ---------------------------------------------------------------- the discrete tokenizer


class CausalDiscreteVideoTokenizer(nn.Module):
    """encode: (B, T, H, W, 3) -> (indices (B, t, h, w), quantized codes
    (B, t, h, w, embedding_dim), a zero loss); decode(codes) and
    decode_indices(indices) -> (B, T, H, W, 3)."""

    def __init__(self, cfg: DVTokenizerConfig):
        super().__init__()
        if cfg.embedding_dim != len(cfg.levels):
            raise ValueError("FSQ projections are only needed when embedding_dim != "
                             "len(levels); the Cosmos DV configs never use them")
        self.cfg = cfg
        zc = cfg.z_factor * cfg.z_channels
        self.encoder = EncoderFactorized(cfg, zc)
        self.decoder = DecoderFactorized(cfg, cfg.z_channels)
        self.quant_conv = CausalConv3d(zc, cfg.embedding_dim, (1, 1, 1), padding=0)
        self.post_quant_conv = CausalConv3d(cfg.embedding_dim, cfg.z_channels, (1, 1, 1),
                                            padding=0)
        self.quantizer = FSQuantizer(cfg.levels)
        self.to(cfg.dtype)

    def _dtype(self):
        return self.quant_conv.conv3d.weight.dtype

    def encode(self, x: torch.Tensor):
        h = self.quant_conv(self.encoder(x.to(self._dtype())))
        return self.quantizer(h.permute(0, 2, 3, 4, 1).float())

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(quant.to(self._dtype()).permute(0, 4, 1, 2, 3)))

    def decode_indices(self, indices: torch.Tensor) -> torch.Tensor:
        return self.decode(self.quantizer.indices_to_codes(indices))

    def forward(self, x):
        indices, quant, loss = self.encode(x)
        return self.decode(quant), indices, loss


class DiscreteVideoFSQTokenizer:
    """Pixel-chunked encode / decode around the tokenizer: T splits into
    `pixel_chunk_duration`-frame causal chunks, each encoded on its own
    (the reference's streaming contract), the batch of chunks capped at
    max_enc / max_dec_batch_size."""

    def __init__(self, module: CausalDiscreteVideoTokenizer, pixel_chunk_duration: int = 33,
                 compression_ratio: Sequence[int] = (8, 16, 16), max_enc_batch_size: int = 8,
                 max_dec_batch_size: int = 4):
        self.module = module
        self.pixel_chunk_duration = pixel_chunk_duration
        self.compress_ratio = tuple(compression_ratio)
        self.max_enc_batch_size = max_enc_batch_size
        self.max_dec_batch_size = max_dec_batch_size
        self.latent_ch = module.cfg.embedding_dim

    def _latent_duration(self, pixel_chunk_duration: int) -> int:
        return 1 + (pixel_chunk_duration - 1) // self.compress_ratio[0]

    @torch.inference_mode()
    def encode(self, video: torch.Tensor, pixel_chunk_duration: int | None = None):
        """(B, T, H, W, 3) -> (codes (B, t, h, w, C), indices (B, t, h, w));
        T must divide into pixel chunks."""
        b, t, h, w, c = video.shape
        pcd = pixel_chunk_duration or self.pixel_chunk_duration
        assert t % pcd == 0, f"T={t} not divisible by chunk {pcd}"
        n = t // pcd
        chunks = video.reshape(b * n, pcd, h, w, c)
        quants, idxs = [], []
        for i in range(0, b * n, self.max_enc_batch_size):
            idx, q, _ = self.module.encode(chunks[i:i + self.max_enc_batch_size])
            quants.append(q)
            idxs.append(idx)
        q, idx = torch.cat(quants), torch.cat(idxs)
        lcd = self._latent_duration(pcd)
        assert q.shape[1] == lcd, (q.shape, lcd)
        return (q.reshape(b, n * lcd, *q.shape[2:]), idx.reshape(b, n * lcd, *idx.shape[2:]))

    @torch.inference_mode()
    def decode(self, indices: torch.Tensor, pixel_chunk_duration: int | None = None
               ) -> torch.Tensor:
        """(B, t, h, w) -> (B, T, H, W, 3)."""
        b, t = indices.shape[:2]
        pcd = pixel_chunk_duration or self.pixel_chunk_duration
        lcd = self._latent_duration(pcd)
        assert t % lcd == 0, f"latent T={t} not divisible by chunk {lcd}"
        n = t // lcd
        chunks = indices.reshape(b * n, lcd, *indices.shape[2:])
        outs = [self.module.decode_indices(chunks[i:i + self.max_dec_batch_size])
                for i in range(0, b * n, self.max_dec_batch_size)]
        out = torch.cat(outs)
        assert out.shape[1] == pcd
        return out.reshape(b, n * pcd, *out.shape[2:])
