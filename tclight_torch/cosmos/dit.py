"""GeneralDIT, the Cosmos-1.0 adaLN video diffusion transformer
(counterpart of tclight_tpu/cosmos/dit.py).

The modules carry the reference's names (general_dit.py, module/blocks.py,
module/attention.py), so a module's `state_dict()` has the Cosmos
checkpoint's keys (`convert_dit.py`):

- 3D patchify in the reference's channel-major patch order, `(c r m n)`,
  then `x_embedder.proj.1` (Linear, no bias).
- `t_embedder`: sincos features (cos | sin halves), then `linear_1`, SiLU,
  `linear_2`; with adaLN-LoRA the embedding is the raw sincos vector and
  `linear_2` gives the (B, 3D) LoRA term shared by every block.
- 3D video RoPE (head dim split into t | h | w, per-axis NTK factors,
  rotate-half), q and k of self-attention only.
- `extra_pos_embedder`: learnable per-axis embeddings summed over the
  (t, h, w) grid and RMS-normalized, added at the start of every block.
- Per block, [FA, CA, MLP] sub-blocks, each a no-affine LayerNorm with an
  adaLN modulation (shift, scale, gate), per-head RMSNorm on q and k,
  bias-free projections, a GELU MLP.
- `final_layer`: LayerNorm, 2-chunk adaLN, a linear head, the unpatch in
  the `(p1 p2 t C)` order.
- `condition_video_input_mask` (video2world's extra channel) and the
  augment-sigma embedder of the video-conditioned variant.

Layout is JAX's: channel-last (B, T, H, W, C) latents, tokens one flat
(B, T*H*W, D) sequence. Self-attention over more than 512 tokens (with no
mask) is `ops.attention.flash_attention` with the DiT's `attn_backend`:
on the card the kernel K1 (or K6 / K7), on the CPU its plain version;
shorter or masked attention is the plain `dot_product_attention`.

With a `mesh`, the forward is context-parallel
(parallel/sharded.build_cp_dit_forward): each data rank runs T / data of
the frames, and so that share of the tokens, gathers K and V over the
data group before each self-attention, and the output's frames are
gathered at the end.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tclight_torch.ops.attention import dot_product_attention, flash_attention
from tclight_torch.parallel.mesh import gather_rows

__all__ = ["DiTConfig", "GeneralDIT", "VideoExtendGeneralDIT", "make_edm_denoiser",
           "timesteps_embedding", "RMSNormTE", "video_rope_angles", "apply_rope_rotate_half",
           "init_dit_"]


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """The reference GeneralDIT's constructor arguments; `context_dim` is
    its `crossattn_emb_channels`."""

    in_channels: int = 16
    out_channels: int = 16
    model_channels: int = 512
    num_blocks: int = 8
    num_heads: int = 8
    context_dim: int = 1024          # T5 feature dim
    mlp_ratio: float = 4.0
    block_config: str = "FA-CA-MLP"
    patch_spatial: int = 2
    patch_temporal: int = 1
    max_frames: int = 32
    max_img_h: int = 128             # pre-patchify latent pixels
    max_img_w: int = 128
    concat_padding_mask: bool = True
    use_cross_attn_mask: bool = False
    affline_emb_norm: bool = True
    use_adaln_lora: bool = True
    adaln_lora_dim: int = 256
    rope_h_extrapolation_ratio: float = 1.0
    rope_w_extrapolation_ratio: float = 1.0
    rope_t_extrapolation_ratio: float = 1.0
    extra_per_block_abs_pos_emb: bool = True
    extra_h_extrapolation_ratio: float = 1.0
    extra_w_extrapolation_ratio: float = 1.0
    extra_t_extrapolation_ratio: float = 1.0
    add_augment_sigma_embedding: bool = False   # VideoExtendGeneralDIT
    norm_eps: float = 1e-6
    base_fps: int = 24
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny(**overrides) -> "DiTConfig":
        base = dict(in_channels=4, out_channels=4, model_channels=64, num_blocks=2,
                    num_heads=4, context_dim=32, max_frames=8, max_img_h=16, max_img_w=16)
        base.update(overrides)
        return DiTConfig(**base)

    @staticmethod
    def faditv2_7b(**overrides) -> "DiTConfig":
        """Cosmos-1.0-Diffusion-7B Text2World (config/base/net.py:22-42 and
        the text2world inference override)."""
        base = dict(in_channels=16, out_channels=16, model_channels=4096, num_blocks=28,
                    num_heads=32, max_img_h=240, max_img_w=240, max_frames=128,
                    patch_spatial=2, patch_temporal=1, rope_t_extrapolation_ratio=2.0,
                    extra_per_block_abs_pos_emb=True)
        base.update(overrides)
        return DiTConfig(**base)

    @staticmethod
    def faditv2_14b(**overrides) -> "DiTConfig":
        """The 14B net (config/base/net.py:45-48 and the t2w overrides)."""
        base = dict(model_channels=5120, num_heads=40, num_blocks=36,
                    rope_h_extrapolation_ratio=2.0, rope_w_extrapolation_ratio=2.0,
                    rope_t_extrapolation_ratio=2.0, extra_h_extrapolation_ratio=2.0,
                    extra_w_extrapolation_ratio=2.0, extra_t_extrapolation_ratio=2.0)
        base.update(overrides)
        return DiTConfig.faditv2_7b(**base)

    @staticmethod
    def video2world_7b(**overrides) -> "DiTConfig":
        """Video2World: one more input channel, the condition mask. The
        reference never builds its augment-sigma embedder, so released
        checkpoints carry none and the default here is False."""
        base = dict(in_channels=17)
        base.update(overrides)
        return DiTConfig.faditv2_7b(**base)


def timesteps_embedding(timesteps: torch.Tensor, num_channels: int) -> torch.Tensor:
    """Sincos features, cos | sin halves, in f32."""
    half = num_channels // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                 device=timesteps.device)
    emb = torch.exp(exponent / half)
    ang = timesteps.float()[:, None] * emb[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


class TimestepEmbedding(nn.Module):
    """Returns (emb (B, D), adaln_lora (B, 3D) or None): with adaLN-LoRA
    the embedding is the raw sincos input and `linear_2` gives the LoRA
    term."""

    def __init__(self, dim: int, use_adaln_lora: bool):
        super().__init__()
        self.use_adaln_lora = use_adaln_lora
        self.linear_1 = nn.Linear(dim, dim, bias=not use_adaln_lora)
        self.linear_2 = nn.Linear(dim, 3 * dim if use_adaln_lora else dim,
                                  bias=not use_adaln_lora)

    def forward(self, sample):
        h = self.linear_2(F.silu(self.linear_1(sample.to(self.linear_1.weight.dtype))))
        if self.use_adaln_lora:
            return sample, h
        return h, None


class RMSNormTE(nn.Module):
    """TransformerEngine RMSNorm: x / sqrt(mean(x^2) + eps) * weight, in f32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


def _rms_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x / (eps + ||x||_2 / sqrt(D)) over the channels."""
    xf = x.float()
    norm = eps + torch.linalg.vector_norm(xf, dim=-1, keepdim=True) / np.sqrt(x.shape[-1])
    return (xf / norm).to(x.dtype)


def video_rope_angles(head_dim: int, t: int, h: int, w: int, h_ratio: float = 1.0,
                      w_ratio: float = 1.0, t_ratio: float = 1.0, base_fps: int = 24,
                      fps: Optional[float] = None) -> np.ndarray:
    """(T*H*W, head_dim) rotate-half angle table: head_dim split
    dim_h = dim_w = head_dim // 6 * 2, dim_t the rest; per-axis NTK theta
    10000 * ratio ** (dim / (dim - 2)); half-angles ordered [t | h | w]
    and repeated twice."""
    dim_h = head_dim // 6 * 2
    dim_w = dim_h
    dim_t = head_dim - 2 * dim_h
    h_ntk = h_ratio ** (dim_h / (dim_h - 2))
    w_ntk = w_ratio ** (dim_w / (dim_w - 2))
    t_ntk = t_ratio ** (dim_t / (dim_t - 2))
    spatial_range = np.arange(0, dim_h, 2)[: dim_h // 2] / dim_h
    temporal_range = np.arange(0, dim_t, 2)[: dim_t // 2] / dim_t
    h_freqs = 1.0 / (10000.0 * h_ntk) ** spatial_range
    w_freqs = 1.0 / (10000.0 * w_ntk) ** spatial_range
    t_freqs = 1.0 / (10000.0 * t_ntk) ** temporal_range
    tpos = np.arange(t, dtype=np.float64)
    if fps is not None:
        tpos = tpos / fps * base_fps
    half_t = np.outer(tpos, t_freqs)
    half_h = np.outer(np.arange(h), h_freqs)
    half_w = np.outer(np.arange(w), w_freqs)
    et = np.broadcast_to(half_t[:, None, None, :], (t, h, w, half_t.shape[1]))
    eh = np.broadcast_to(half_h[None, :, None, :], (t, h, w, half_h.shape[1]))
    ew = np.broadcast_to(half_w[None, None, :, :], (t, h, w, half_w.shape[1]))
    half = np.concatenate([et, eh, ew], axis=-1).reshape(t * h * w, -1)
    return np.concatenate([half, half], axis=-1).astype(np.float32)


def apply_rope_rotate_half(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D), angles (S, D) f32 -> rotate-half RoPE, in f32."""
    ang = angles[None, :, None, :].float()
    cos, sin = torch.cos(ang), torch.sin(ang)
    d = x.shape[-1] // 2
    xf = x.float()
    rot = torch.cat([-xf[..., d:], xf[..., :d]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


class Attention(nn.Module):
    """module/attention.py `Attention` with qkv_norm "RRI": per-head
    RMSNorm on q and k (`to_q.1`, `to_k.1`), none on v; RoPE on q and k of
    self-attention; bias-free projections."""

    def __init__(self, cfg: DiTConfig, is_selfattn: bool):
        super().__init__()
        d, hd = cfg.model_channels, cfg.model_channels // cfg.num_heads
        ctx_dim = d if is_selfattn else cfg.context_dim
        self.heads, self.head_dim, self.is_selfattn = cfg.num_heads, hd, is_selfattn
        self.to_q = nn.Sequential(nn.Linear(d, d, bias=False), RMSNormTE(hd, cfg.norm_eps))
        self.to_k = nn.Sequential(nn.Linear(ctx_dim, d, bias=False), RMSNormTE(hd, cfg.norm_eps))
        self.to_v = nn.Sequential(nn.Linear(ctx_dim, d, bias=False), nn.Identity())
        self.to_out = nn.Sequential(nn.Linear(d, d, bias=False), nn.Identity())

    def forward(self, x, context=None, rope_angles=None, mask=None, attn_backend=None,
                mesh=None):
        b, s, _ = x.shape
        ctx = x if context is None else context.to(x.dtype)
        sk = ctx.shape[1]
        q = self.to_q[1](self.to_q[0](x).reshape(b, s, self.heads, self.head_dim))
        k = self.to_k[1](self.to_k[0](ctx).reshape(b, sk, self.heads, self.head_dim))
        v = self.to_v[0](ctx).reshape(b, sk, self.heads, self.head_dim)
        s_all = s
        if self.is_selfattn:
            if rope_angles is not None:
                q = apply_rope_rotate_half(q, rope_angles)
                k = apply_rope_rotate_half(k, rope_angles)
            # context parallel: every rank's queries see all the keys
            k, v = gather_rows(k, mesh, 1), gather_rows(v, mesh, 1)
            s_all = k.shape[1]
        if self.is_selfattn and mask is None and s_all > 512:
            o = flash_attention(q, k, v, backend=attn_backend)
        else:
            o = dot_product_attention(q, k, v, mask=mask)
        return self.to_out[0](o.reshape(b, s, self.heads * self.head_dim))


class GPT2FeedForward(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.layer1 = nn.Linear(d, hidden, bias=False)
        self.layer2 = nn.Linear(hidden, d, bias=False)

    def forward(self, x):
        return self.layer2(F.gelu(self.layer1(x)))


class _AttnBlock(nn.Module):
    """The reference's VideoAttn wrapper: its `attn`."""

    def __init__(self, cfg: DiTConfig, is_selfattn: bool):
        super().__init__()
        self.attn = Attention(cfg, is_selfattn)

    def forward(self, x, **kw):
        return self.attn(x, **kw)


def _adaln(cfg: DiTConfig, n_chunks: int) -> nn.Sequential:
    """SiLU -> Linear [-> Linear], bias-free."""
    d = cfg.model_channels
    if cfg.use_adaln_lora:
        return nn.Sequential(nn.SiLU(), nn.Linear(d, cfg.adaln_lora_dim, bias=False),
                             nn.Linear(cfg.adaln_lora_dim, n_chunks * d, bias=False))
    return nn.Sequential(nn.SiLU(), nn.Linear(d, n_chunks * d, bias=False))


def _layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x.float(), x.shape[-1:], eps=eps).to(x.dtype)


_BLOCK_TYPES = {"fa": "full_attn", "full_attn": "full_attn", "ca": "cross_attn",
                "cross_attn": "cross_attn", "mlp": "mlp", "ff": "mlp"}


class DITBuildingBlock(nn.Module):
    """One FA / CA / MLP sub-block with adaLN (blocks.py:337-465)."""

    def __init__(self, cfg: DiTConfig, block_type: str):
        super().__init__()
        self.cfg, self.block_type = cfg, block_type
        self.adaLN_modulation = _adaln(cfg, 3)
        if block_type == "mlp":
            self.block = GPT2FeedForward(cfg.model_channels,
                                         int(cfg.model_channels * cfg.mlp_ratio))
        elif block_type in ("full_attn", "cross_attn"):
            self.block = _AttnBlock(cfg, block_type == "full_attn")
        else:
            raise ValueError(f"Unknown block type {block_type}")

    def forward(self, x, emb, context, crossattn_mask=None, rope_angles=None,
                adaln_lora=None, attn_backend=None, mesh=None):
        mod = self.adaLN_modulation(emb)
        if self.cfg.use_adaln_lora:
            mod = mod + adaln_lora
        shift, scale, gate = mod.chunk(3, dim=-1)
        h = _layer_norm(x, self.cfg.norm_eps) * (1 + scale[:, None]) + shift[:, None]
        if self.block_type == "mlp":
            h = self.block(h)
        elif self.block_type == "full_attn":
            h = self.block(h, rope_angles=rope_angles, attn_backend=attn_backend, mesh=mesh)
        else:
            h = self.block(h, context=context, mask=crossattn_mask, attn_backend=attn_backend)
        return x + gate[:, None] * h


class GeneralDITTransformerBlock(nn.Module):
    """One layer: the block_config's sub-blocks, the extra per-block
    positional embedding added first."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.blocks = nn.ModuleList(DITBuildingBlock(cfg, _BLOCK_TYPES[tok])
                                    for tok in cfg.block_config.lower().split("-"))

    def forward(self, x, emb, context, crossattn_mask=None, rope_angles=None,
                adaln_lora=None, extra_pos_emb=None, attn_backend=None, mesh=None):
        if extra_pos_emb is not None:
            x = x + extra_pos_emb
        for blk in self.blocks:
            x = blk(x, emb, context, crossattn_mask, rope_angles, adaln_lora, attn_backend,
                    mesh)
        return x


class LearnablePosEmbAxis(nn.Module):
    """Per-axis learnable embeddings summed over the (t, h, w) grid, then
    channel-RMS-normalized."""

    def __init__(self, cfg: DiTConfig, len_t: int, len_h: int, len_w: int):
        super().__init__()
        d = cfg.model_channels
        self.eps = cfg.norm_eps
        self.pos_emb_h = nn.Parameter(torch.zeros(len_h, d))
        self.pos_emb_w = nn.Parameter(torch.zeros(len_w, d))
        self.pos_emb_t = nn.Parameter(torch.zeros(len_t, d))

    def forward(self, t: int, h: int, w: int):
        lt, lh, lw = self.pos_emb_t.shape[0], self.pos_emb_h.shape[0], self.pos_emb_w.shape[0]
        if t > lt or h > lh or w > lw:
            raise ValueError(f"latent grid ({t},{h},{w}) exceeds the learnable pos-emb "
                             f"tables ({lt},{lh},{lw}): raise max_frames/max_img_h/max_img_w")
        emb = (self.pos_emb_t[:t, None, None, :] + self.pos_emb_h[None, :h, None, :]
               + self.pos_emb_w[None, None, :w, :])
        return _rms_normalize(emb, self.eps).reshape(t * h * w, -1)


class FinalLayer(nn.Module):
    """No-affine LayerNorm, 2-chunk adaLN (plus the LoRA term's first 2D),
    a linear head."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        self.adaLN_modulation = _adaln(cfg, 2)
        out = cfg.patch_spatial ** 2 * cfg.patch_temporal * cfg.out_channels
        self.linear = nn.Linear(cfg.model_channels, out, bias=False)

    def forward(self, x, emb, adaln_lora=None):
        cfg = self.cfg
        mod = self.adaLN_modulation(emb)
        if cfg.use_adaln_lora:
            mod = mod + adaln_lora[:, : 2 * cfg.model_channels]
        shift, scale = mod.chunk(2, dim=-1)
        h = _layer_norm(x, cfg.norm_eps) * (1 + scale[:, None]) + shift[:, None]
        return self.linear(h)


class PatchEmbed(nn.Module):
    """The linear patch embedding; `proj.0` is the reference's rearrange."""

    def __init__(self, in_features: int, dim: int):
        super().__init__()
        self.proj = nn.Sequential(nn.Identity(), nn.Linear(in_features, dim, bias=False))

    def forward(self, z):
        return self.proj(z)


class GeneralDIT(nn.Module):
    """Video DiT denoiser: (B, T, H, W, C) latents, timesteps (B,) and
    context (B, M, context_dim) -> (B, T, H, W, C_out) f32.

    Optional inputs: `crossattn_mask` (B, M), `fps`, `padding_mask` (B, H,
    W) (1 = padded; zeros when omitted and `concat_padding_mask` is set),
    `condition_video_input_mask` (B, T, H, W, 1), concatenated to x as its
    last channel, and `condition_video_augment_sigma` (B,) for the
    augment-sigma embedder (zeros when omitted)."""

    def __init__(self, cfg: DiTConfig, attn_backend: Optional[str] = None):
        super().__init__()
        self.cfg, self.attn_backend = cfg, attn_backend
        d = cfg.model_channels
        p, pt = cfg.patch_spatial, cfg.patch_temporal
        in_ch = cfg.in_channels + (1 if cfg.concat_padding_mask else 0)
        self.x_embedder = PatchEmbed(in_ch * pt * p * p, d)
        # index 0 is the reference's parameter-free sincos stage
        self.t_embedder = nn.Sequential(nn.Identity(), TimestepEmbedding(d, cfg.use_adaln_lora))
        if cfg.add_augment_sigma_embedding:
            self.augment_sigma_embedder = nn.Sequential(
                nn.Identity(), TimestepEmbedding(d, cfg.use_adaln_lora))
        if cfg.affline_emb_norm:
            self.affline_norm = RMSNormTE(d, cfg.norm_eps)
        if cfg.extra_per_block_abs_pos_emb:
            self.extra_pos_embedder = LearnablePosEmbAxis(
                cfg, cfg.max_frames // pt, cfg.max_img_h // p, cfg.max_img_w // p)
        self.blocks = nn.ModuleDict({f"block{i}": GeneralDITTransformerBlock(cfg)
                                     for i in range(cfg.num_blocks)})
        self.final_layer = FinalLayer(cfg)
        self.to(cfg.dtype)

    def forward(self, x, timesteps, context, crossattn_mask=None, fps=None,
                padding_mask=None, condition_video_input_mask=None,
                condition_video_augment_sigma=None, mesh=None):
        cfg = self.cfg
        dtype = self.x_embedder.proj[1].weight.dtype
        if condition_video_input_mask is not None:
            x = torch.cat([x, condition_video_input_mask.to(x.dtype)], dim=-1)
        b, t, h, w, _ = x.shape
        pt, p = cfg.patch_temporal, cfg.patch_spatial
        gt, gh, gw = t // pt, h // p, w // p
        if cfg.concat_padding_mask:
            if padding_mask is None:
                padding_mask = torch.zeros((b, h, w), dtype=x.dtype, device=x.device)
            pm = padding_mask.to(x.dtype)[:, None, :, :, None].expand(b, t, h, w, 1)
            x = torch.cat([x, pm], dim=-1)

        # context parallel: this data rank's frames, and so its tokens
        n_data = 1 if mesh is None else mesh.shape["data"]
        if gt % n_data:
            raise ValueError(f"{gt} latent frames do not split over {n_data} data ranks")
        gt_loc = gt // n_data
        t0 = 0 if mesh is None else mesh.data_index * gt_loc
        x = x[:, t0 * pt:(t0 + gt_loc) * pt]
        tok = slice(t0 * gh * gw, (t0 + gt_loc) * gh * gw)

        # 3D patchify, channel-major: b (t r) (h m) (w n) c -> b (t h w) (c r m n)
        z = x.reshape(b, gt_loc, pt, gh, p, gw, p, x.shape[-1])
        z = z.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(b, gt_loc * gh * gw, -1)
        z = self.x_embedder(z.to(dtype))

        sincos = timesteps_embedding(torch.as_tensor(timesteps, device=x.device).reshape(-1),
                                     cfg.model_channels)
        emb, adaln_lora = self.t_embedder[1](sincos)
        if cfg.add_augment_sigma_embedding:
            if condition_video_augment_sigma is None:
                condition_video_augment_sigma = torch.zeros((b,), device=x.device)
            aug = timesteps_embedding(
                torch.as_tensor(condition_video_augment_sigma, device=x.device).reshape(-1),
                cfg.model_channels)
            emb = emb + self.augment_sigma_embedder[1](aug)[0]
        emb = emb.to(dtype)
        if cfg.affline_emb_norm:
            emb = self.affline_norm(emb)
        if adaln_lora is not None:
            adaln_lora = adaln_lora.to(dtype)

        head_dim = cfg.model_channels // cfg.num_heads
        fps_val = None if fps is None else float(fps)
        rope = torch.from_numpy(video_rope_angles(
            head_dim, gt, gh, gw, cfg.rope_h_extrapolation_ratio,
            cfg.rope_w_extrapolation_ratio, cfg.rope_t_extrapolation_ratio, cfg.base_fps,
            fps_val)[tok]).to(x.device)
        extra_pos = None
        if cfg.extra_per_block_abs_pos_emb:
            extra_pos = self.extra_pos_embedder(gt, gh, gw)[tok][None].to(dtype)
        mask = None
        if cfg.use_cross_attn_mask and crossattn_mask is not None:
            mask = crossattn_mask[:, None, None, :].bool()
        for blk in self.blocks.values():
            z = blk(z, emb, context, mask, rope, adaln_lora, extra_pos, self.attn_backend, mesh)
        z = self.final_layer(z, emb, adaln_lora)

        # unpatch in the (p1 p2 t C) output order
        z = z.reshape(b, gt_loc, gh, gw, p, p, pt, cfg.out_channels)
        z = z.permute(0, 1, 6, 2, 4, 3, 5, 7).reshape(b, gt_loc * pt, h, w, cfg.out_channels)
        return gather_rows(z.float(), mesh, 1)


def VideoExtendGeneralDIT(cfg: DiTConfig, attn_backend: Optional[str] = None) -> GeneralDIT:
    """The video-conditioned variant: the same network with the
    augment-sigma embedder; pass `condition_video_input_mask` /
    `condition_video_augment_sigma` at call time."""
    if not cfg.add_augment_sigma_embedding:
        cfg = dataclasses.replace(cfg, add_augment_sigma_embedding=True)
    return GeneralDIT(cfg, attn_backend)


@torch.no_grad()
def init_dit_(model: GeneralDIT, gen: torch.Generator, gate_std: float = 0.5) -> GeneralDIT:
    """Random weights in place, drawn on the module's device from `gen`:
    N(0, 1 / fan_in) for every Linear, unit RMSNorm weights, N(0, 0.02)
    positional tables. The adaLN modulations' last layers, which the
    reference zero-initialises (so that a fresh DiT's blocks add nothing),
    get N(0, gate_std^2 / fan_in), so that every block and its attention
    count."""
    last = f"adaLN_modulation.{2 if model.cfg.use_adaln_lora else 1}"
    for name, m in model.named_modules():
        if isinstance(m, nn.Linear):
            std = m.weight.shape[1] ** -0.5
            m.weight.normal_(0.0, std * (gate_std if name.endswith(last) else 1.0),
                             generator=gen)
            if m.bias is not None:
                m.bias.normal_(0.0, 0.02, generator=gen)
        elif isinstance(m, RMSNormTE):
            m.weight.fill_(1.0)
        elif isinstance(m, LearnablePosEmbAxis):
            for prm in (m.pos_emb_t, m.pos_emb_h, m.pos_emb_w):
                prm.normal_(0.0, 0.02, generator=gen)
    return model


def make_edm_denoiser(model: GeneralDIT, context, sigma_data: float = 0.5, mesh=None,
                      **extra):
    """The DiT as an EDM x0-prediction function, x0_fn(x, sigma). With
    `mesh`, the forward runs context-parallel (build_cp_dit_forward).
    `extra` goes to every forward (e.g. `condition_video_input_mask`)."""
    from tclight_torch.cosmos.edm import EDMScaling
    from tclight_torch.parallel.sharded import build_cp_dit_forward

    scaling = EDMScaling(sigma_data)
    fwd = build_cp_dit_forward(model, mesh)

    def x0_fn(x, sigma):
        sigma_b = torch.full((x.shape[0],), float(sigma), dtype=torch.float32, device=x.device)
        c_skip, c_out, c_in, c_noise = scaling(sigma_b)
        bshape = (-1,) + (1,) * (x.dim() - 1)
        f = fwd(x * c_in.reshape(bshape), c_noise, context, **extra)
        return c_skip.reshape(bshape) * x + c_out.reshape(bshape) * f

    return x0_fn
