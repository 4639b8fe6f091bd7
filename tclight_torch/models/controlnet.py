"""ControlNet (SD1.5 family) (counterpart of tclight_tpu/models/controlnet.py).

diffusers' `ControlNetModel` as the editing path runs it: the UNet's down
and mid stack (the same module names, so `convert_unet`'s key rules serve
the trunk), a conditioning embedder that takes the full-resolution control
image to latent resolution, and 1x1 zero convs on every skip and on the mid
output. `UNet2DCondition.forward(down_residuals=..., mid_residual=...)` adds
the residuals.

No token merging: the reference merges tokens in the UNet only, so the
control branch runs per-frame self-attention over every token (the flash
kernel K1 where a level has more than 512 tokens).

Layout: NHWC at `forward`'s boundary, NCHW inside; the residuals come back
NHWC.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tclight_torch.models.layers import (Downsample2D, ResnetBlock2D, TimestepEmbedding,
                                         timestep_embedding)
from tclight_torch.models.unet import Transformer2D, UNetConfig
from tclight_torch.utils.device import resolve_device

__all__ = ["ControlNetCondEmbedding", "ControlNetModel", "convert_controlnet",
           "load_controlnet", "reference_state_dict"]

# diffusers ControlNetConditioningEmbedding's channel plan
_COND_EMBED_CHANNELS = (16, 32, 96, 256)


class ControlNetCondEmbedding(nn.Module):
    """Control image (B, 3, H, W) -> (B, ch0, H/8, W/8): conv_in, three
    stride-2 channel steps, conv_out (zero at initialisation)."""

    def __init__(self, out_channels: int):
        super().__init__()
        chans = _COND_EMBED_CHANNELS
        self.conv_in = nn.Conv2d(3, chans[0], 3, padding=1)
        for i in range(len(chans) - 1):
            self.add_module(f"blocks_{2 * i}", nn.Conv2d(chans[i], chans[i], 3, padding=1))
            self.add_module(f"blocks_{2 * i + 1}",
                            nn.Conv2d(chans[i], chans[i + 1], 3, stride=2, padding=1))
        self.conv_out = nn.Conv2d(chans[-1], out_channels, 3, padding=1)
        self.n_blocks = 2 * (len(chans) - 1)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.conv_in(cond))
        for i in range(self.n_blocks):
            h = F.silu(getattr(self, f"blocks_{i}")(h))
        return self.conv_out(h)


class ControlNetModel(nn.Module):
    """The SD down + mid stack emitting zero-conv residuals.

    forward(x (B, h, w, C_in), t, context (B, S, ctx), cond_image (B, H, W, 3))
    -> (down_residuals: one NHWC tensor per UNet skip, mid_residual NHWC)."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        self.config = cfg = config
        ch = cfg.block_out_channels
        n = len(ch)
        temb_dim = ch[0] * 4
        self.time_embedding = TimestepEmbedding(ch[0], temb_dim)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.controlnet_cond_embedding = ControlNetCondEmbedding(ch[0])
        cur = ch[0]
        skip_ch = [cur]
        for lvl in range(n):
            for blk in range(cfg.layers_per_block):
                self.add_module(f"down_{lvl}_res_{blk}", ResnetBlock2D(
                    cur, ch[lvl], temb_dim, cfg.norm_groups))
                cur = ch[lvl]
                if lvl < n - 1:
                    self.add_module(f"down_{lvl}_attn_{blk}", Transformer2D(
                        ch[lvl], cfg.num_heads, cfg.context_dim, cfg.norm_groups))
                skip_ch.append(cur)
            if lvl < n - 1:
                self.add_module(f"down_{lvl}_ds", Downsample2D(cur))
                skip_ch.append(cur)
        self.mid_res_0 = ResnetBlock2D(cur, ch[-1], temb_dim, cfg.norm_groups)
        self.mid_attn = Transformer2D(ch[-1], cfg.num_heads, cfg.context_dim, cfg.norm_groups)
        self.mid_res_1 = ResnetBlock2D(ch[-1], ch[-1], temb_dim, cfg.norm_groups)
        for i, c in enumerate(skip_ch):
            self.add_module(f"controlnet_down_{i}", nn.Conv2d(c, c, 1))
        self.controlnet_mid = nn.Conv2d(ch[-1], ch[-1], 1)
        self.to(cfg.dtype)

    def forward(self, x: torch.Tensor, timesteps, context: torch.Tensor,
                cond_image: torch.Tensor):
        cfg = self.config
        ch = cfg.block_out_channels
        n = len(ch)
        x = x.permute(0, 3, 1, 2)
        timesteps = torch.as_tensor(timesteps, dtype=torch.float32, device=x.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(x.shape[0])
        temb = self.time_embedding(timestep_embedding(timesteps, ch[0]).to(cfg.dtype))

        def attn(key, h):
            # per frame, every token: no ToMe spec, no bank
            return getattr(self, key)(h, context, None, False, 0, False, None, False)[0]

        h = self.conv_in(x) + self.controlnet_cond_embedding(
            cond_image.permute(0, 3, 1, 2).to(cfg.dtype))
        skips = [h]
        for lvl in range(n):
            for blk in range(cfg.layers_per_block):
                h = getattr(self, f"down_{lvl}_res_{blk}")(h, temb)
                if lvl < n - 1:
                    h = attn(f"down_{lvl}_attn_{blk}", h)
                skips.append(h)
            if lvl < n - 1:
                h = getattr(self, f"down_{lvl}_ds")(h)
                skips.append(h)
        h = self.mid_res_0(h, temb)
        h = attn("mid_attn", h)
        h = self.mid_res_1(h, temb)
        down = [getattr(self, f"controlnet_down_{i}")(s).permute(0, 2, 3, 1)
                for i, s in enumerate(skips)]
        return down, self.controlnet_mid(h).permute(0, 2, 3, 1)


def convert_controlnet(sd: Mapping[str, np.ndarray], n_levels: int = 4) -> dict:
    """A diffusers ControlNetModel state dict (control_v11* checkpoints) ->
    the flax-layout tree of the JAX package's ControlNet: the trunk through
    `convert_unet`'s rules, the embedder and the zero convs here."""
    from tclight_torch.models.convert import convert_unet

    heads = ("controlnet_cond_embedding.", "controlnet_down_blocks.", "controlnet_mid_block.")
    trunk = {k: v for k, v in sd.items() if not k.startswith(heads)}
    params = convert_unet(trunk, n_levels=n_levels)["params"]

    def put(path: str, key: str, v) -> None:
        node = params
        for part in path.split("/"):
            node = node.setdefault(part, {})
        v = np.asarray(v)
        node["kernel" if key == "weight" else "bias"] = (
            np.transpose(v, (2, 3, 1, 0)) if key == "weight" else v)

    for k, v in sd.items():
        if not k.startswith(heads):
            continue
        if m := re.fullmatch(
                r"controlnet_cond_embedding\.(conv_in|conv_out|blocks\.\d+)\.(weight|bias)", k):
            put("controlnet_cond_embedding/" + m[1].replace("blocks.", "blocks_"), m[2], v)
        elif m := re.fullmatch(r"controlnet_down_blocks\.(\d+)\.(weight|bias)", k):
            put(f"controlnet_down_{m[1]}", m[2], v)
        elif m := re.fullmatch(r"controlnet_mid_block\.(weight|bias)", k):
            put("controlnet_mid", m[1], v)
        else:
            raise KeyError(f"unmatched controlnet key {k}")
    return {"params": params}


def reference_state_dict(model: ControlNetModel) -> dict[str, torch.Tensor]:
    """A `ControlNetModel`'s weights as a diffusers ControlNetModel state
    dict (`convert_controlnet`'s inverse)."""
    from tclight_torch.models.convert import _rename, _unet_trunk_rules

    n = len(model.config.block_out_channels)
    return _rename(model.state_dict(), _unet_trunk_rules(n) + [
        (r"^controlnet_cond_embedding\.blocks_(\d+)\.", r"controlnet_cond_embedding.blocks.\1."),
        (r"^controlnet_down_(\d+)\.", r"controlnet_down_blocks.\1."),
        (r"^controlnet_mid\.", "controlnet_mid_block."),
    ])


def load_controlnet(ckpt_path: str | Path, config: UNetConfig,
                    device: str | torch.device = "cuda") -> ControlNetModel:
    """A `ControlNetModel` of `config` on `device` (eval mode, no grads)
    from a local control_v11* checkpoint file."""
    from tclight_torch.models import bridge
    from tclight_torch.models.convert import load_torch_state_dict

    dev = resolve_device(device)
    tree = convert_controlnet(load_torch_state_dict(ckpt_path),
                              n_levels=len(config.block_out_channels))
    with torch.device(dev):
        model = ControlNetModel(config)
    model.load_state_dict(bridge.controlnet_state_dict(tree))
    return model.eval().requires_grad_(False)
