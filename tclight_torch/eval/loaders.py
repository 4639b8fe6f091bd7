"""The metric models of the evaluate CLI, from local checkpoints
(counterpart of tclight_tpu/eval/loaders.py): CLIP ViT-B/32 for
clip-frame / clip-text, PickScore's CLIP ViT-H/14 for pick-score, RAFT or
MemFlow for the warp-error flows, lpips 'vgg' for frame-lpips. Nothing is
downloaded: every loader takes a local path and raises when it is missing.

Checkpoint layouts (`.safetensors`, read by the port's own reader, or
torch `.pt` / `.pth` state dicts, read with weights_only=True;
transformers / torchvision / lpips key names):

  clip_dir/   vision.safetensors | clip_vision.safetensors | vision.pt | vision.pth
                  (CLIPVisionModelWithProjection state dict)
              text.safetensors | clip_text.safetensors | text.pt | text.pth
                  (CLIPTextModelWithProjection state dict, optional)
              tokenizer/  (transformers tokenizer files, optional; without
                  it the text metrics are skipped)
  pick_dir/   the same layout with ViT-H/14 shapes (PickScore_v1)
  lpips_dir/  vgg16.safetensors | vgg16.pt | vgg16.pth (torchvision
                  vgg16 `features.N` state dict)
              lpips_vgg.safetensors | lpips_vgg.pt | lpips_vgg.pth
                  (lpips 'vgg' lin heads, lin{i}.model.1.weight)
  flow:       raft-things.pth (RAFT) or MemFlowNet_things.pth (MemFlow),
              `module.` prefixes allowed

The models run on `device` (the card unless the caller asks for the
CPU). A checkpoint whose widths are those of a model's `tiny()` config
loads into that config (small test checkpoints); any other loads into the
published one.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from tclight_torch.utils.device import resolve_device
from tclight_torch.utils.logging import get_logger

log = get_logger()


def _load_sd(path: Path) -> dict:
    from tclight_torch.models.convert import load_torch_state_dict

    return load_torch_state_dict(path)


def _find(dirpath: Path, names: list[str]) -> Path | None:
    return next((dirpath / n for n in names if (dirpath / n).exists()), None)


def _width(sd: dict, suffix: str) -> int | None:
    return next((np.shape(v)[0] for k, v in sd.items() if k.endswith(suffix)), None)


def load_clip_embed(clip_dir: str | Path, variant: str = "b32",
                    device: str | torch.device | None = "cuda"):
    """The (frames, prompt) -> (image_embs, text_emb) callable from local
    CLIP checkpoints. variant: 'b32' (openai ViT-B/32) or 'h14'."""
    from tclight_torch.models import bridge
    from tclight_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from tclight_torch.models.clip_vision import (CLIPVisionConfig, CLIPVisionModel,
                                                  convert_clip_vision, make_clip_embed_fn)
    from tclight_torch.models.convert import convert_clip_text
    from tclight_torch.pipeline.iclight import load_tokenizer

    dev = resolve_device(device)
    clip_dir = Path(clip_dir)
    vis_path = _find(clip_dir, ["vision.safetensors", "clip_vision.safetensors",
                                "vision.pt", "vision.pth"])
    if vis_path is None:
        raise FileNotFoundError(f"no vision checkpoint under {clip_dir}")
    sd = _load_sd(vis_path)
    vcfg = CLIPVisionConfig.vit_h14() if variant == "h14" else CLIPVisionConfig.vit_b32()
    if _width(sd, "embeddings.class_embedding") == CLIPVisionConfig.tiny().hidden_size:
        vcfg = CLIPVisionConfig.tiny()
    vision = CLIPVisionModel(vcfg)
    vision.load_state_dict(bridge.clip_vision_state_dict(convert_clip_vision(sd)))
    vision.to(dev).eval()

    text = tproj = tokenizer = None
    txt_path = _find(clip_dir, ["text.safetensors", "clip_text.safetensors",
                                "text.pt", "text.pth"])
    if txt_path is not None:
        sd = _load_sd(txt_path)
        if "text_projection.weight" in sd:
            tproj = np.asarray(sd.pop("text_projection.weight")).T
        tcfg = CLIPTextConfig.vit_h14() if variant == "h14" else CLIPTextConfig.vit_b32()
        if _width(sd, "final_layer_norm.weight") == CLIPTextConfig.tiny().hidden_size:
            tcfg = CLIPTextConfig.tiny()
        text = CLIPTextModel(tcfg)
        text.load_state_dict(bridge.clip_text_state_dict(convert_clip_text(sd)))
        text.to(dev).eval()
        tok_dir = clip_dir / "tokenizer"
        tokenizer = load_tokenizer(tok_dir) if tok_dir.exists() else None
        if tokenizer is None:
            log.warning("no tokenizer under %s; text metrics disabled", clip_dir)
            text = None
    return make_clip_embed_fn(vision, text, tproj, tokenizer, image_size=vcfg.image_size)


def load_lpips(lpips_dir: str | Path, device: str | torch.device | None = "cuda"):
    """LPIPS('vgg') from local VGG16 + lin-head checkpoints."""
    from tclight_torch.models import bridge
    from tclight_torch.models.vgg_lpips import (LPIPS, VGG16Features, convert_vgg16_features,
                                                load_lpips_lin_weights)

    dev = resolve_device(device)
    lpips_dir = Path(lpips_dir)
    vgg_path = _find(lpips_dir, ["vgg16.safetensors", "vgg16.pt", "vgg16.pth"])
    lin_path = _find(lpips_dir, ["lpips_vgg.safetensors", "lpips_vgg.pt", "lpips_vgg.pth"])
    if vgg_path is None or lin_path is None:
        raise FileNotFoundError(f"need vgg16 + lpips_vgg checkpoints under {lpips_dir}")
    vgg = VGG16Features()
    vgg.load_state_dict(bridge.vgg16_state_dict(convert_vgg16_features(_load_sd(vgg_path))))
    return LPIPS(vgg.to(dev), load_lpips_lin_weights(_load_sd(lin_path)))


def load_flow_backend(name: str, ckpt: str | Path | None,
                      device: str | torch.device | None = "cuda"):
    """('farneback' | 'raft' | 'memflow', checkpoint) -> (backend name,
    model or None) for data.flow_backends.compute_flow_pairs."""
    if name == "farneback":
        return name, None
    if name not in ("raft", "memflow"):
        raise ValueError(f"unknown flow model {name}")
    if ckpt is None or not Path(str(ckpt)).exists():
        raise FileNotFoundError(f"--flow_model {name} needs --flow_ckpt pointing at a local "
                                f"checkpoint (got {ckpt})")
    if name == "raft":
        from tclight_torch.models import bridge
        from tclight_torch.models.raft import RAFTConfig, RAFTFlowModel, convert_raft_params

        sd = _load_sd(Path(ckpt))
        tiny = RAFTConfig.tiny()
        cfg = tiny if _width(sd, "fnet.conv1.weight") == tiny.fnet_dim // 4 else RAFTConfig()
        return name, RAFTFlowModel(bridge.raft_state_dict(convert_raft_params(sd, cfg)), cfg,
                                   device=device)
    from tclight_torch.data.flow_backends import load_memflow_core

    return name, load_memflow_core(ckpt, device=device)
