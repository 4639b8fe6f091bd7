"""IC-Light / SD model stack (counterpart of tclight_tpu/pipeline/iclight.py).

SD1.5 with an 8-channel (fc) or 12-channel (fbc) conv_in; the
conditioning latents are concatenated by the Generator. Stacks come with
random weights made from a seed, from state dicts the caller hands in
(the tests bridge the JAX package's weights with `models/bridge.py`), or
from local checkpoint files (`load_iclight`), laid out as the JAX
package reads them:

  <model_dir>/unet.safetensors          diffusers UNet state dict
  <model_dir>/vae.safetensors           diffusers VAE state dict
  <model_dir>/text_encoder.safetensors  transformers CLIP text model state dict
  <model_dir>/tokenizer/                CLIP tokenizer files (optional)
  <model_dir>/iclight_sd15_fc.safetensors   (or _fbc) IC-Light weight offsets
"""

from __future__ import annotations

import dataclasses
import hashlib
from pathlib import Path
from typing import Any

import torch
from torch import nn

from tclight_torch.diffusion.schedulers import DPMSolverMultistepScheduler
from tclight_torch.models import bridge
from tclight_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from tclight_torch.models.convert import (convert_clip_text, convert_unet, convert_vae,
                                          expand_conv_in, load_torch_state_dict,
                                          merge_offsets)
from tclight_torch.models.unet import ToMeSpec, UNet2DCondition, UNetConfig
from tclight_torch.models.vae import AutoencoderKL, VAEConfig
from tclight_torch.utils.device import resolve_device

__all__ = ["DummyTokenizer", "ICLightModels", "init_like_flax", "build_iclight",
           "build_tiny_iclight", "build_full_width_random", "load_tokenizer",
           "load_iclight"]


class DummyTokenizer:
    """Deterministic hash tokenizer (the subset of the CLIPTokenizer
    interface the pipeline uses); the same ids as the JAX package's."""

    model_max_length = 77
    bos_token_id = 1
    eos_token_id = 2

    def __init__(self, vocab_size: int = 1000):
        self.vocab_size = vocab_size

    def __call__(self, text: str, truncation: bool = False,
                 add_special_tokens: bool = False) -> dict:
        ids = [3 + int(hashlib.md5(w.encode()).hexdigest(), 16) % (self.vocab_size - 3)
               for w in text.lower().split()]
        return {"input_ids": ids}


@dataclasses.dataclass
class ICLightModels:
    unet: UNet2DCondition
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    tokenizer: Any
    scheduler: DPMSolverMultistepScheduler
    tome_spec: ToMeSpec | None = None
    attn_backend: str | None = None  # None, "int8" or "int8pv" (ops/attention.py)

    @property
    def latent_scale(self) -> float:
        return self.vae.config.scaling_factor

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    def with_tome(self, tome_spec: ToMeSpec | None,
                  attn_backend: str | None = None) -> "ICLightModels":
        """The same modules, run with `tome_spec` and the attention
        `attn_backend`."""
        return dataclasses.replace(self, tome_spec=tome_spec, attn_backend=attn_backend)


@torch.no_grad()
def init_like_flax(module: nn.Module, gen: torch.Generator) -> None:
    """Random weights with flax's default scales: N(0, 1/fan_in) for
    Dense/Conv kernels and embeddings, zero biases, unit norm scales."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, m.weight.shape[1] ** -0.5, generator=gen)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    if isinstance(module, CLIPTextModel):
        module.position_embedding.normal_(0.0, 0.01, generator=gen)


def build_iclight(ucfg: UNetConfig, vcfg: VAEConfig, tcfg: CLIPTextConfig,
                  num_inference_steps: int = 25, seed: int = 0,
                  state_dicts: dict | None = None,
                  device: str | torch.device | None = "cuda") -> ICLightModels:
    """An IC-Light stack on `device`: random weights from `seed`, or the
    `state_dicts` {"unet", "vae", "text_encoder"} when given."""
    dev = resolve_device(device)
    if tcfg.hidden_size != ucfg.context_dim:
        raise ValueError("the UNet's context_dim must match the text width")
    with torch.device(dev):
        unet = UNet2DCondition(ucfg)
        vae = AutoencoderKL(vcfg)
        text = CLIPTextModel(tcfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, module in (("unet", unet), ("vae", vae), ("text_encoder", text)):
        if state_dicts is not None:
            module.load_state_dict(state_dicts[name])
        else:
            init_like_flax(module, gen)
        module.eval().requires_grad_(False)
    return ICLightModels(
        unet=unet, vae=vae, text_encoder=text,
        tokenizer=DummyTokenizer(vocab_size=tcfg.vocab_size),
        scheduler=DPMSolverMultistepScheduler(
            num_inference_steps=num_inference_steps))


def build_tiny_iclight(seed: int = 0, num_inference_steps: int = 4,
                       in_channels: int = 8, dtype=torch.float32,
                       state_dicts: dict | None = None,
                       device: str | torch.device | None = "cuda"
                       ) -> ICLightModels:
    """Tiny IC-Light stack for tests and smoke runs."""
    return build_iclight(UNetConfig.tiny(in_channels, dtype=dtype),
                         VAEConfig.tiny(dtype=dtype), CLIPTextConfig.tiny(),
                         num_inference_steps, seed, state_dicts, device)


def build_full_width_random(seed: int = 0, num_inference_steps: int = 25,
                            device: str | torch.device | None = "cuda"
                            ) -> ICLightModels:
    """The full SD1.5 IC-Light stack on random weights, with the shapes of
    bench.py: UNet sd15 (8-channel conv_in) and VAE sd15 in bf16, the CLIP
    ViT-L/14 text tower in f32."""
    return build_iclight(UNetConfig.sd15(in_channels=8), VAEConfig.sd15(),
                         CLIPTextConfig.sd15(), num_inference_steps, seed,
                         None, device)


def load_tokenizer(tokenizer_dir: str | Path):
    """The CLIP tokenizer saved in `tokenizer_dir` (transformers' files)."""
    from transformers import CLIPTokenizer

    return CLIPTokenizer.from_pretrained(str(tokenizer_dir))


def load_iclight(model_dir: str | Path, mode: str = "fc", num_inference_steps: int = 25,
                 device: str | torch.device | None = "cuda") -> ICLightModels:
    """The IC-Light stack from the checkpoint files in `model_dir` (layout
    in the module docstring), as the JAX package's `load_iclight` builds
    it: the UNet's conv_in zero-extended to 8 (`fc`) or 12 (`fbc`) input
    channels and the mode's IC-Light offsets added when their file is
    there; the diffusers / transformers keys go through `models/convert.py`
    and `models/bridge.py`. The configs are SD1.5's, or the tiny ones of
    `build_tiny_iclight` when the UNet's first width is theirs (32, not
    320). The UNet and the VAE run in bf16 on the card and in f32 on the
    CPU; the CLIP text model in f32. The tokenizer comes from `tokenizer/`
    when it is there, else the DummyTokenizer, as in the JAX package."""
    if mode not in ("fc", "fbc"):
        raise ValueError(f"mode must be 'fc' or 'fbc', got {mode!r}")
    dev = resolve_device(device)
    model_dir = Path(model_dir)
    in_channels = {"fc": 8, "fbc": 12}[mode]
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32

    sd_unet = load_torch_state_dict(model_dir / "unet.safetensors")
    width = sd_unet["conv_in.weight"].shape[0]
    size = next((name for name in ("sd15", "tiny")
                 if getattr(UNetConfig, name)().block_out_channels[0] == width), None)
    if size is None:
        raise ValueError(f"{model_dir}: a UNet of first width {width} is neither SD1.5's "
                         "(320) nor the tiny test stack's (32)")
    ucfg = getattr(UNetConfig, size)(in_channels=in_channels, dtype=dtype)
    vcfg = getattr(VAEConfig, size)(dtype=dtype)
    tcfg = getattr(CLIPTextConfig, size)()

    sd_unet = expand_conv_in(sd_unet, in_channels)
    offset_file = model_dir / f"iclight_sd15_{mode}.safetensors"
    if offset_file.exists():
        sd_unet = merge_offsets(sd_unet, load_torch_state_dict(offset_file))
    state_dicts = {
        "unet": bridge.unet_state_dict(
            convert_unet(sd_unet, n_levels=len(ucfg.block_out_channels))),
        "vae": bridge.vae_state_dict(convert_vae(
            load_torch_state_dict(model_dir / "vae.safetensors"),
            n_levels=len(vcfg.block_out_channels))),
        "text_encoder": bridge.clip_text_state_dict(convert_clip_text(
            load_torch_state_dict(model_dir / "text_encoder.safetensors"))),
    }
    del sd_unet
    models = build_iclight(ucfg, vcfg, tcfg, num_inference_steps,
                           state_dicts=state_dicts, device=dev)
    tok_dir = model_dir / "tokenizer"
    tokenizer = load_tokenizer(tok_dir) if tok_dir.exists() else DummyTokenizer()
    return dataclasses.replace(models, tokenizer=tokenizer)
