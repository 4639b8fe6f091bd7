"""CLIP vision tower and projection for the evaluation metrics (counterpart
of tclight_tpu/models/clip_vision.py): openai ViT-B/32 for clip-frame /
clip-text, laion ViT-H/14 (PickScore's backbone) for pick-score.

`CLIPVisionModel` takes NHWC images in [0, 1], normalizes them with
CLIP's constants, embeds the patches, adds the position embeddings sliced
to the token count, runs pre-LN transformer layers (quick GELU) and
projects the class token. Attention is a matmul and a softmax in f32.
`convert_clip_vision` (numpy, the JAX package's code) maps a transformers
CLIPVisionModelWithProjection (or CLIPModel) state dict onto the flax
tree, and `models.bridge.clip_vision_state_dict` turns it into this
module's state dict.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
from torch import nn

from tclight_torch.models.clip_text import quick_gelu

__all__ = ["CLIP_MEAN", "CLIP_STD", "CLIPVisionConfig", "CLIPVisionModel",
           "convert_clip_vision", "reference_state_dict", "make_clip_embed_fn"]

# openai CLIP's normalization constants
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    projection_dim: int = 512

    @staticmethod
    def vit_b32() -> "CLIPVisionConfig":
        return CLIPVisionConfig()

    @staticmethod
    def vit_h14() -> "CLIPVisionConfig":
        """laion CLIP-ViT-H-14's vision tower (the PickScore_v1 backbone)."""
        return CLIPVisionConfig(image_size=224, patch_size=14, hidden_size=1280,
                                num_layers=32, num_heads=16, intermediate_size=5120,
                                projection_dim=1024)

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(image_size=32, patch_size=16, hidden_size=32, num_layers=2,
                                num_heads=2, intermediate_size=64, projection_dim=16)


class _VisionLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        c = cfg.hidden_size
        self.heads = cfg.num_heads
        self.layer_norm1 = nn.LayerNorm(c, eps=1e-5)
        self.q_proj, self.k_proj = nn.Linear(c, c), nn.Linear(c, c)
        self.v_proj, self.out_proj = nn.Linear(c, c), nn.Linear(c, c)
        self.layer_norm2 = nn.LayerNorm(c, eps=1e-5)
        self.mlp_fc1 = nn.Linear(c, cfg.intermediate_size)
        self.mlp_fc2 = nn.Linear(cfg.intermediate_size, c)

    def forward(self, x):
        b, s, c = x.shape
        h, d = self.heads, c // self.heads
        z = self.layer_norm1(x)

        def split(t):
            return t.reshape(b, s, h, d).transpose(1, 2)

        q, k, v = split(self.q_proj(z)), split(self.k_proj(z)), split(self.v_proj(z))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / np.sqrt(d)
        o = torch.matmul(torch.softmax(logits, -1).to(x.dtype), v)
        x = x + self.out_proj(o.transpose(1, 2).reshape(b, s, c))
        return x + self.mlp_fc2(quick_gelu(self.mlp_fc1(self.layer_norm2(x))))


class CLIPVisionModel(nn.Module):
    """(B, H, W, 3) in [0, 1] -> projected embedding (B, projection_dim)."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        c, p = cfg.hidden_size, cfg.patch_size
        self.patch_embedding = nn.Conv2d(3, c, p, p, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(c))
        self.position_embedding = nn.Parameter(torch.zeros((cfg.image_size // p) ** 2 + 1, c))
        self.pre_layrnorm = nn.LayerNorm(c, eps=1e-5)
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}", _VisionLayer(cfg))
        self.post_layernorm = nn.LayerNorm(c, eps=1e-5)
        self.visual_projection = nn.Linear(c, cfg.projection_dim, bias=False)
        self.register_buffer("mean", torch.from_numpy(CLIP_MEAN), persistent=False)
        self.register_buffer("std", torch.from_numpy(CLIP_STD), persistent=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = ((images - self.mean) / self.std).permute(0, 3, 1, 2)
        z = self.patch_embedding(x).flatten(2).transpose(1, 2)  # (B, tokens, C)
        b = z.shape[0]
        z = torch.cat([self.class_embedding.expand(b, 1, -1), z], 1)
        z = self.pre_layrnorm(z + self.position_embedding[None, :z.shape[1]])
        for i in range(self.cfg.num_layers):
            z = getattr(self, f"layers_{i}")(z)
        return self.visual_projection(self.post_layernorm(z[:, 0]))


def convert_clip_vision(sd: dict) -> dict:
    """transformers CLIPVisionModelWithProjection (or the vision half of
    CLIPModel) -> the flax tree of the JAX package's CLIPVisionModel."""
    params: dict = {}

    def put(path, val):
        node = params
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def strip(k):
        for pre in ("vision_model.", "clip.vision_model."):
            if k.startswith(pre):
                return k[len(pre):]
        return k

    def lin(path, leaf, v):
        put(f"{path}/" + ("kernel" if leaf == "weight" else "bias"),
            v.T if leaf == "weight" else v)

    for k, v in sd.items():
        v = np.asarray(v)
        if "position_ids" in k:
            continue
        if k == "visual_projection.weight":
            put("visual_projection/kernel", v.T)
            continue
        k = strip(k)
        if k == "embeddings.class_embedding":
            put("class_embedding", v)
        elif k == "embeddings.position_embedding.weight":
            put("position_embedding", v)
        elif k == "embeddings.patch_embedding.weight":
            put("patch_embedding/kernel", np.transpose(v, (2, 3, 1, 0)))
        elif k.startswith("pre_layrnorm") or k.startswith("post_layernorm"):
            name, leaf = k.split(".")
            put(f"{name}/{'scale' if leaf == 'weight' else 'bias'}", v)
        else:
            m = re.fullmatch(r"encoder\.layers\.(\d+)\.(self_attn\.(q|k|v|out)_proj|"
                             r"layer_norm[12]|mlp\.fc[12])\.(weight|bias)", k)
            if not m:
                continue
            i, mod, leaf = m.group(1), m.group(2), m.group(4)
            if mod.startswith("self_attn."):
                lin(f"layers_{i}/{mod.split('.')[1]}", leaf, v)
            elif mod.startswith("layer_norm"):
                put(f"layers_{i}/{mod}/{'scale' if leaf == 'weight' else 'bias'}", v)
            else:
                lin(f"layers_{i}/{'mlp_fc1' if mod.endswith('1') else 'mlp_fc2'}", leaf, v)
    return {"params": params}


def reference_state_dict(model: CLIPVisionModel) -> dict[str, torch.Tensor]:
    """`model`'s weights under transformers' CLIPVisionModelWithProjection
    keys: the inverse of `convert_clip_vision` followed by
    `bridge.clip_vision_state_dict`. Writes reference-format checkpoints
    from random weights."""
    out = {}
    for key, val in model.state_dict().items():
        if key.startswith("visual_projection."):
            name = key
        elif key in ("class_embedding", "position_embedding", "patch_embedding.weight"):
            name = "vision_model.embeddings." + {
                "class_embedding": "class_embedding",
                "position_embedding": "position_embedding.weight",
                "patch_embedding.weight": "patch_embedding.weight"}[key]
        else:
            key = re.sub(r"^layers_(\d+)\.([qkv]|out)_proj\.",
                         r"encoder.layers.\1.self_attn.\2_proj.", key)
            key = re.sub(r"^layers_(\d+)\.mlp_fc([12])\.", r"encoder.layers.\1.mlp.fc\2.", key)
            name = "vision_model." + re.sub(r"^layers_(\d+)\.", r"encoder.layers.\1.", key)
        out[name] = val.detach().float().cpu().clone()
    return out


def make_clip_embed_fn(vision_model: CLIPVisionModel, text_model=None,
                       text_projection: np.ndarray | None = None, tokenizer=None,
                       image_size: int = 224):
    """The (frames, prompt) -> (image embeddings (N, P), text embedding (P,)
    or None) callable of the evaluate CLI, on the models' device. Frames
    (N, H, W, 3) in [0, 1] are resized to `image_size`; the prompt is
    tokenized to 77 ids (BOS, the tokens, EOS padding), and its embedding
    is the text tower's output at the first EOS, min(eos_pos, 76),
    projected by `text_projection` (hidden, P)."""
    import cv2

    device = next(vision_model.parameters()).device

    @torch.no_grad()
    def embed(frames: np.ndarray, prompt: str):
        resized = np.stack([cv2.resize(f, (image_size, image_size)) for f in frames])
        x = torch.from_numpy(np.ascontiguousarray(resized, np.float32)).to(device)
        embs = vision_model(x).float().cpu().numpy()
        temb = None
        if text_model is not None and prompt:
            ids = tokenizer(prompt, truncation=True, max_length=77,
                            add_special_tokens=False)["input_ids"]
            ids = [tokenizer.bos_token_id] + ids + [tokenizer.eos_token_id]
            ids = ids + [tokenizer.eos_token_id] * (77 - len(ids))
            hidden = text_model(torch.tensor([ids], dtype=torch.long, device=device))
            eos_pos = len([i for i in ids if i != tokenizer.eos_token_id])
            pooled = hidden[0, min(eos_pos, 76)].float()
            if text_projection is not None:
                pooled = pooled @ torch.from_numpy(
                    np.asarray(text_projection, np.float32)).to(device)
            temb = pooled.cpu().numpy()
        return embs, temb

    return embed
