"""UNet2DCondition (SD1.5 family) with first-class token merging
(counterpart of tclight_tpu/models/unet.py).

The IC-Light conv_in widening is `in_channels` in the config; the concat of
the conditioning latents is done by the caller. VidToMe token merging is a
`ToMeSpec` handed to `forward`: merge -> self-attention -> unmerge, with the
global token banks passed in and returned as a dict. The generic-SD
editing path's hooks are arguments of `forward`: Plug-and-Play's Q/K and
conv-feature injection (`pnp_attn`, `pnp_conv`, on a [source | uncond |
cond] batch) and ControlNet's residuals (`down_residuals`, `mid_residual`).

Layout: NHWC at `forward`'s boundary, (B*F, H, W, C) with B the CFG batch
and F the frames of a chunk; NCHW inside.

With a `mesh` (parallel/mesh.py), `x` is this rank's share of the batch
(`mesh.split_rows`): the resnets and convolutions run on the share, and
each Transformer2D gathers the batch before its block, whose token
merging mixes frames, and splits it again after. The output is the
share; the banks are whole on every rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from tclight_torch.models.layers import (Downsample2D, FeedForward,
                                         ResnetBlock2D, TimestepEmbedding,
                                         Upsample2D, timestep_embedding)
from tclight_torch.ops import tome
from tclight_torch.parallel.mesh import gather_rows, split_rows
from tclight_torch.ops.attention import dot_product_attention, flash_attention
from tclight_torch.utils.logging import span


@dataclasses.dataclass(frozen=True)
class ToMeSpec:
    """Token-merging spec (configs/tclight_default.yaml generation.*)."""

    n_frames: int = 4
    local_ratio: float = 0.6
    merge_global: bool = True
    global_ratio: float = 0.5
    align_batch: bool = True
    max_downsample: int = 2
    target_stride: int = 4


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    num_heads: int = 8
    context_dim: int = 768
    norm_groups: int = 32
    dtype: torch.dtype = torch.float32

    @staticmethod
    def sd15(in_channels: int = 4, dtype=torch.bfloat16) -> "UNetConfig":
        return UNetConfig(in_channels=in_channels, dtype=dtype)

    @staticmethod
    def tiny(in_channels: int = 4, dtype=torch.float32) -> "UNetConfig":
        return UNetConfig(in_channels=in_channels, block_out_channels=(32, 64),
                          layers_per_block=1, num_heads=2, context_dim=32,
                          norm_groups=8, dtype=dtype)


class Attention(nn.Module):
    """Multi-head attention: plain for short KV (skv <= 512), the flash
    kernel of `backend` otherwise (None, "int8" or "int8pv"; see
    ops/attention.py).

    `inject_qk` is Plug-and-Play's source injection: the batch holds
    [source | uncond | cond] in thirds, and every sample's Q and K become
    the source third's."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or dim, inner, bias=False)
        self.to_out_0 = nn.Linear(inner, inner)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                backend: Optional[str] = None, inject_qk: bool = False) -> torch.Tensor:
        ctx = x if context is None else context
        b, sq = x.shape[:2]
        skv = ctx.shape[1]
        q, k = self.to_q(x), self.to_k(ctx)
        if inject_qk:
            # repeat copies: the tiled q and k are contiguous, as the
            # flash kernels need them
            third = b // 3
            q, k = q[:third].repeat(3, 1, 1), k[:third].repeat(3, 1, 1)
        q = q.reshape(b, sq, self.heads, self.dim_head)
        k = k.reshape(b, skv, self.heads, self.dim_head)
        v = self.to_v(ctx).reshape(b, skv, self.heads, self.dim_head)
        with span("attention"):
            if skv <= 512:
                out = dot_product_attention(q, k, v)
            else:
                out = flash_attention(q, k, v, backend=backend)
        return self.to_out_0(out.reshape(b, sq, self.heads * self.dim_head))


class BasicTransformerBlock(nn.Module):
    """Self-attn -> cross-attn -> GEGLU FF, with token merging around the
    self-attention."""

    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.attn1 = Attention(dim, heads, dim // heads)
        self.attn2 = Attention(dim, heads, dim // heads, context_dim=context_dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context, tome_spec: Optional[ToMeSpec],
                merge_active: bool, randf: int, flip: bool,
                bank: Optional[torch.Tensor], use_global: bool,
                dup_after_attn1: bool = False, attn_backend: Optional[str] = None,
                pnp_attn: bool = False):
        h = self.norm1(x)
        new_bank = bank
        spec = tome_spec
        if merge_active and spec is not None and spec.n_frames > 1:
            f = spec.n_frames
            with span("tome"):  # the merge
                levels = tome.plan_local_levels(f, h.shape[1], spec.local_ratio,
                                                spec.target_stride)
                joined = tome.join_frame(h, f)
                merged, infos = tome.local_merge_sequence(
                    joined, joined, levels, randf, spec.align_batch)
                # the local chain's row maps (and the global level's) compose
                # into one gather of the attention output
                rows = tome.local_unmerge_rows(infos)
                g_rows = None
                if spec.merge_global and use_global and bank is not None:
                    l_len = merged.shape[1]
                    merged, mi_g, _ = tome.global_merge(
                        merged, bank, merged, bank, spec.global_ratio, flip,
                        spec.align_batch)
                    g_rows = tome.global_unmerge_rows(mi_g, flip, l_len)
                    new_bank = tome.gather_rows(merged, g_rows)
                elif spec.merge_global:
                    new_bank = merged
            attn_out = self.attn1(merged, backend=attn_backend, inject_qk=pnp_attn)
            with span("tome"):  # the unmerge
                if g_rows is not None:
                    rows = tome.compose_rows(g_rows, rows)
                attn_out = tome.split_frame(tome.gather_rows(attn_out, rows), f)
        else:
            attn_out = self.attn1(h, backend=attn_backend, inject_qk=pnp_attn)
        x = x + attn_out
        if dup_after_attn1:
            # CFG-prefix dedup: everything so far ran on the shared half;
            # the [uncond | cond] pair first diverges at the cross-attention
            # below, so the tokens AND the bank this block produced are
            # duplicated into the full CFG batch here (unet.py:211-219)
            x = torch.cat([x, x], dim=0)
            if new_bank is not None:
                new_bank = torch.cat([new_bank, new_bank], dim=0)
        x = x + self.attn2(self.norm2(x), context, backend=attn_backend)
        x = x + self.ff(self.norm3(x))
        return x, new_bank


class Transformer2D(nn.Module):
    """GroupNorm + 1x1 proj in/out around one BasicTransformerBlock."""

    def __init__(self, channels: int, heads: int, context_dim: int,
                 norm_groups: int):
        super().__init__()
        self.norm = nn.GroupNorm(norm_groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks_0 = BasicTransformerBlock(channels, heads,
                                                          context_dim)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, context, tome_spec, merge_active, randf, flip, bank,
                use_global, dup_after_attn1: bool = False,
                attn_backend: Optional[str] = None, pnp_attn: bool = False, mesh=None):
        x = gather_rows(x, mesh)
        b, c, hh, ww = x.shape
        residual = x
        z = self.proj_in(self.norm(x))
        z = z.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        if dup_after_attn1 and bank is not None:
            # banks are kept at the full CFG batch; this block computes on
            # the shared half, whose two copies are identical (unet.py:245)
            bank = bank[: bank.shape[0] // 2]
        z, new_bank = self.transformer_blocks_0(
            z, context, tome_spec, merge_active, randf, flip, bank, use_global,
            dup_after_attn1, attn_backend, pnp_attn)
        if dup_after_attn1:
            residual = torch.cat([residual, residual], dim=0)
        z = z.reshape(residual.shape[0], hh, ww, c).permute(0, 3, 1, 2)
        return split_rows(self.proj_out(z) + residual, mesh), new_bank


class UNet2DCondition(nn.Module):
    """SD1.5-topology conditional UNet (cross-attention on every level but
    the last, plus mid), NHWC at the boundary, with ToMe plumbing.

    forward(x, t, context, ...) -> (eps (B*F, H, W, C_out) f32, new_banks).
    `attn_backend` goes to every attention, as the JAX UNet threads its
    field of that name.

    Editing hooks (levels count from the finest, 0, as in JAX, so
    `n - 2` is the second-coarsest):
    - `pnp_attn`: Q/K injection in every up-block self-attention but
      (level n - 2, block 0);
    - `pnp_conv`: the source third's features tiled over the batch after
      the resnet of (level n - 2, block 1), before its attention;
    - `down_residuals` (NHWC, one per skip) are added to the skips and
      `mid_residual` (NHWC) after the mid block.
    The CFG-prefix dedup (`cfg_dedup`) excludes all four."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        self.config = cfg = config
        ch = cfg.block_out_channels
        n = len(ch)
        temb_dim = ch[0] * 4
        self.time_embedding = TimestepEmbedding(ch[0], temb_dim)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)

        def attn(level):
            return Transformer2D(ch[level], cfg.num_heads, cfg.context_dim,
                                 cfg.norm_groups)

        cur = ch[0]
        skip_ch = [cur]
        for lvl in range(n):
            for blk in range(cfg.layers_per_block):
                self.add_module(f"down_{lvl}_res_{blk}", ResnetBlock2D(
                    cur, ch[lvl], temb_dim, cfg.norm_groups))
                cur = ch[lvl]
                if lvl < n - 1:
                    self.add_module(f"down_{lvl}_attn_{blk}", attn(lvl))
                skip_ch.append(cur)
            if lvl < n - 1:
                self.add_module(f"down_{lvl}_ds", Downsample2D(cur))
                skip_ch.append(cur)
        self.mid_res_0 = ResnetBlock2D(cur, ch[-1], temb_dim, cfg.norm_groups)
        self.mid_attn = attn(n - 1)
        self.mid_res_1 = ResnetBlock2D(ch[-1], ch[-1], temb_dim, cfg.norm_groups)
        cur = ch[-1]
        for lvl in reversed(range(n)):
            for blk in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{lvl}_res_{blk}", ResnetBlock2D(
                    cur + skip_ch.pop(), ch[lvl], temb_dim, cfg.norm_groups))
                cur = ch[lvl]
                if lvl < n - 1:
                    self.add_module(f"up_{lvl}_attn_{blk}", attn(lvl))
            if lvl > 0:
                self.add_module(f"up_{lvl}_us", Upsample2D(cur))
        self.conv_norm_out = nn.GroupNorm(cfg.norm_groups, ch[0], eps=1e-5)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)
        self.to(cfg.dtype)

    @staticmethod
    def _merge_active(spec, h, w, h0, w0) -> bool:
        if spec is None:
            return False
        downsample = int(math.ceil(math.sqrt((h0 * w0) / (h * w))))
        return downsample <= spec.max_downsample

    def forward(self, x: torch.Tensor, timesteps, context: torch.Tensor,
                tome_spec: Optional[ToMeSpec] = None, randf: int = 0,
                flip: bool = False, banks: Optional[dict] = None,
                use_global: bool = False, cfg_dedup: bool = False,
                attn_backend: Optional[str] = None, pnp_attn: bool = False, pnp_conv: bool = False,
                down_residuals=None, mid_residual=None, mesh=None):
        with span("unet"):
            cfg = self.config
            ch = cfg.block_out_channels
            n = len(ch)
            # CFG-prefix dedup: `x` is the SINGLE shared half of the
            # [uncond | cond] pair, `context` the full CFG batch; the first
            # attention block duplicates its tokens and bank before its
            # cross-attention (see BasicTransformerBlock)
            rows = x.shape[0] * (1 if mesh is None else mesh.shape["data"])
            if cfg_dedup and (context.shape[0] != 2 * rows or n < 2):
                raise ValueError("cfg_dedup: x is the shared half, context the "
                                 "full batch, and the UNet needs an attention level")
            if cfg_dedup and (pnp_attn or pnp_conv or down_residuals is not None
                              or mid_residual is not None):
                raise ValueError("cfg_dedup excludes PnP and ControlNet residuals")
            if mesh is not None and (pnp_attn or pnp_conv or down_residuals is not None
                                     or mid_residual is not None):
                raise ValueError("a data-split batch excludes PnP and ControlNet residuals")
            x = x.permute(0, 3, 1, 2)
            h0, w0 = x.shape[-2:]
            timesteps = torch.as_tensor(timesteps, dtype=torch.float32,
                                        device=x.device)
            if timesteps.dim() == 0:
                timesteps = timesteps.expand(x.shape[0])
            banks = banks or {}
            new_banks: dict = {}

            temb = self.time_embedding(
                timestep_embedding(timesteps, ch[0]).to(cfg.dtype))
            temb_full = torch.cat([temb, temb]) if cfg_dedup else temb
            pending = cfg_dedup

            def run_attn(key, h, dup=False, inject=False):
                active = self._merge_active(tome_spec, h.shape[-2], h.shape[-1],
                                            h0, w0)
                h, nb = getattr(self, key)(h, context, tome_spec, active, randf,
                                           flip, banks.get(key), use_global, dup,
                                           attn_backend, inject, mesh)
                if nb is not None:
                    new_banks[key] = nb
                return h

            h = self.conv_in(x)
            skips = [split_rows(torch.cat([gather_rows(h, mesh)] * 2), mesh) if cfg_dedup else h]
            for lvl in range(n):
                for blk in range(cfg.layers_per_block):
                    h = getattr(self, f"down_{lvl}_res_{blk}")(
                        h, temb if pending else temb_full)
                    if lvl < n - 1:
                        h = run_attn(f"down_{lvl}_attn_{blk}", h, pending)
                        pending = False
                    skips.append(h)
                if lvl < n - 1:
                    h = getattr(self, f"down_{lvl}_ds")(h)
                    skips.append(h)

            if down_residuals is not None:
                if len(down_residuals) != len(skips):
                    raise ValueError(f"{len(down_residuals)} residuals for {len(skips)} skips")
                skips = [s + r.permute(0, 3, 1, 2).to(s.dtype)
                         for s, r in zip(skips, down_residuals)]

            h = self.mid_res_0(h, temb_full)
            h = run_attn("mid_attn", h)
            h = self.mid_res_1(h, temb_full)
            if mid_residual is not None:
                h = h + mid_residual.permute(0, 3, 1, 2).to(h.dtype)

            for lvl in reversed(range(n)):
                for blk in range(cfg.layers_per_block + 1):
                    h = torch.cat([h, skips.pop()], dim=1)
                    h = getattr(self, f"up_{lvl}_res_{blk}")(h, temb_full)
                    if pnp_conv and lvl == n - 2 and blk == 1:
                        h = h[: h.shape[0] // 3].repeat(3, 1, 1, 1)
                    if lvl < n - 1:
                        h = run_attn(f"up_{lvl}_attn_{blk}", h,
                                     inject=pnp_attn and not (lvl == n - 2 and blk == 0))
                if lvl > 0:
                    h = getattr(self, f"up_{lvl}_us")(
                        h, out_size=tuple(skips[-1].shape[-2:]))

            h = self.conv_out(torch.nn.functional.silu(self.conv_norm_out(h)))
            return h.permute(0, 2, 3, 1).float(), new_banks
