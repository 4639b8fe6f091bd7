"""IC-Light / SD model stack (counterpart of tclight_tpu/pipeline/iclight.py).

SD1.5 with an 8-channel (fc) or 12-channel (fbc) conv_in; the
conditioning latents are concatenated by the Generator. This slice builds
stacks with random weights, made from a seed, or from state dicts the
caller hands in (the tests bridge the JAX package's weights with
`models/bridge.py`). Loading diffusers checkpoints is a later slice.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import torch
from torch import nn

from tclight_torch.diffusion.schedulers import DPMSolverMultistepScheduler
from tclight_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from tclight_torch.models.unet import ToMeSpec, UNet2DCondition, UNetConfig
from tclight_torch.models.vae import AutoencoderKL, VAEConfig
from tclight_torch.utils.device import resolve_device

__all__ = ["DummyTokenizer", "ICLightModels", "init_like_flax", "build_iclight",
           "build_tiny_iclight", "build_full_width_random"]


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

    @property
    def latent_scale(self) -> float:
        return self.vae.config.scaling_factor

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    def with_tome(self, tome_spec: ToMeSpec | None) -> "ICLightModels":
        """The same modules, run with `tome_spec`."""
        return dataclasses.replace(self, tome_spec=tome_spec)


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
