"""The SigLIP vision tower and the 7-class video safety head of the Cosmos
video content filter (counterpart of tclight_tpu/models/siglip.py).

- `SiglipVisionTower`: a transformers SiglipVisionModel's pooled output:
  patch conv, learned positions, pre-norm encoder layers (tanh GELU), the
  post layer norm, then the attention-pooling head (a learned probe
  cross-attends the tokens, then LayerNorm + MLP with a residual).
- `SafetyClassifier`: Linear-BN-ReLU twice and a Linear to 7 logits, the
  BatchNorms folded to their eval-mode affine.
- `preprocess_siglip`: frames resized (bicubic) to 384 and scaled to
  [-1, 1].

The modules carry the flax module names (`layer_{i}.q_proj`, `head_q`,
`linear_0`, `bn_0_scale` ...), so `models/bridge.py`'s
`flax_to_state_dict` maps JAX's parameter trees onto them; the
converters read transformers' Siglip keys and the Cosmos `safety_filter.pt`
keys. Inputs are channel-last (B, H, W, 3), as in JAX; the attention is a
matmul and a softmax, as JAX's einsum.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["SiglipVisionConfig", "SiglipVisionTower", "convert_siglip_vision",
           "SafetyClassifier", "convert_safety_classifier", "preprocess_siglip"]


@dataclasses.dataclass(frozen=True)
class SiglipVisionConfig:
    image_size: int = 384
    patch_size: int = 14
    hidden_size: int = 1152
    num_layers: int = 27
    num_heads: int = 16
    intermediate_size: int = 4304
    dtype: torch.dtype = torch.float32

    @staticmethod
    def so400m() -> "SiglipVisionConfig":
        """google/siglip-so400m-patch14-384, the guardrail's encoder."""
        return SiglipVisionConfig()

    @staticmethod
    def tiny() -> "SiglipVisionConfig":
        return SiglipVisionConfig(image_size=28, patch_size=14, hidden_size=32, num_layers=2,
                                  num_heads=2, intermediate_size=64)


def _attention(q, k, v, heads: int) -> torch.Tensor:
    """softmax(q.k^T / sqrt(hd)) v over (B, S, D) projections."""
    b, sq, d = q.shape
    hd = d // heads
    q, k, v = (t.reshape(b, t.shape[1], heads, hd).transpose(1, 2) for t in (q, k, v))
    att = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
    return torch.matmul(att, v).transpose(1, 2).reshape(b, sq, d)


class _SiglipLayer(nn.Module):
    def __init__(self, c: SiglipVisionConfig):
        super().__init__()
        d = c.hidden_size
        self.heads = c.num_heads
        self.layer_norm1 = nn.LayerNorm(d, eps=1e-6)
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(d, d) for _ in range(4))
        self.layer_norm2 = nn.LayerNorm(d, eps=1e-6)
        self.fc1 = nn.Linear(d, c.intermediate_size)
        self.fc2 = nn.Linear(c.intermediate_size, d)

    def forward(self, x):
        h = self.layer_norm1(x)
        x = x + self.out_proj(_attention(self.q_proj(h), self.k_proj(h), self.v_proj(h),
                                         self.heads))
        h = self.fc2(F.gelu(self.fc1(self.layer_norm2(x)), approximate="tanh"))
        return x + h


class SiglipVisionTower(nn.Module):
    """images (B, H, W, 3) in [-1, 1] -> pooled features (B, hidden)."""

    def __init__(self, config: SiglipVisionConfig = SiglipVisionConfig()):
        super().__init__()
        c = self.config = config
        d = c.hidden_size
        self.patch_embedding = nn.Conv2d(3, d, c.patch_size, stride=c.patch_size)
        self.position_embedding = nn.Parameter(torch.zeros((c.image_size // c.patch_size) ** 2, d))
        for i in range(c.num_layers):
            setattr(self, f"layer_{i}", _SiglipLayer(c))
        self.post_layernorm = nn.LayerNorm(d, eps=1e-6)
        self.probe = nn.Parameter(torch.zeros(1, 1, d))
        self.head_q, self.head_k, self.head_v, self.head_out = (nn.Linear(d, d) for _ in range(4))
        self.head_layernorm = nn.LayerNorm(d, eps=1e-6)
        self.head_fc1 = nn.Linear(d, c.intermediate_size)
        self.head_fc2 = nn.Linear(c.intermediate_size, d)
        self.to(c.dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        c = self.config
        x = self.patch_embedding(images.to(self.probe.dtype).permute(0, 3, 1, 2))
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2) + self.position_embedding[None]
        for i in range(c.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        x = self.post_layernorm(x)
        # attention pooling: the probe cross-attends the sequence
        o = _attention(self.head_q(self.probe.expand(b, 1, -1)), self.head_k(x), self.head_v(x),
                       c.num_heads)
        h = self.head_out(o)
        h = h + self.head_fc2(F.gelu(self.head_fc1(self.head_layernorm(h)), approximate="tanh"))
        return h[:, 0]


_LAYER_NAMES = {"layer_norm1": "layer_norm1", "layer_norm2": "layer_norm2",
                "self_attn.q_proj": "q_proj", "self_attn.k_proj": "k_proj",
                "self_attn.v_proj": "v_proj", "self_attn.out_proj": "out_proj",
                "mlp.fc1": "fc1", "mlp.fc2": "fc2"}


def convert_siglip_vision(sd: Mapping) -> dict[str, torch.Tensor]:
    """A transformers SiglipVisionModel state dict (keys with or without
    ``vision_model.``) -> `SiglipVisionTower`'s state dict; the head's
    packed in-projection split into head_q / head_k / head_v."""
    out: dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        v = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
        k = k.removeprefix("vision_model.")
        if k.startswith("embeddings."):
            name = {"embeddings.patch_embedding.weight": "patch_embedding.weight",
                    "embeddings.patch_embedding.bias": "patch_embedding.bias",
                    "embeddings.position_embedding.weight": "position_embedding"}[k]
            out[name] = v
        elif k.startswith("post_layernorm."):
            out[k] = v
        elif m := re.fullmatch(r"encoder\.layers\.(\d+)\.(.+)\.(weight|bias)", k):
            i, rest, wb = m.groups()
            out[f"layer_{i}.{_LAYER_NAMES[rest]}.{wb}"] = v
        elif k == "head.probe":
            out["probe"] = v
        elif m := re.fullmatch(r"head\.attention\.in_proj_(weight|bias)", k):
            for name, part in zip(("head_q", "head_k", "head_v"), v.chunk(3, dim=0)):
                out[f"{name}.{m.group(1)}"] = part
        elif m := re.fullmatch(r"head\.attention\.out_proj\.(weight|bias)", k):
            out[f"head_out.{m.group(1)}"] = v
        elif m := re.fullmatch(r"head\.(layernorm|mlp\.fc1|mlp\.fc2)\.(weight|bias)", k):
            out[f"head_{m.group(1).removeprefix('mlp.')}.{m.group(2)}"] = v
        else:
            raise KeyError(f"unmatched siglip key {k}")
    return out


class SafetyClassifier(nn.Module):
    """Linear-BN-ReLU x2 and a Linear to the logits, BN as its folded
    eval-mode affine."""

    def __init__(self, input_size: int = 1152, num_classes: int = 7):
        super().__init__()
        widths = (input_size, 512, 256)
        for i in range(2):
            setattr(self, f"linear_{i}", nn.Linear(widths[i], widths[i + 1]))
            setattr(self, f"bn_{i}_scale", nn.Parameter(torch.ones(widths[i + 1])))
            setattr(self, f"bn_{i}_bias", nn.Parameter(torch.zeros(widths[i + 1])))
        self.logits = nn.Linear(256, num_classes)

    def forward(self, x):
        for i in range(2):
            x = getattr(self, f"linear_{i}")(x)
            x = F.relu(x * getattr(self, f"bn_{i}_scale") + getattr(self, f"bn_{i}_bias"))
        return self.logits(x)


def convert_safety_classifier(sd: Mapping, eps: float = 1e-5) -> dict[str, torch.Tensor]:
    """The Cosmos `safety_filter.pt` (``network.layers.N.*``) -> the
    classifier's state dict, each BatchNorm's running statistics folded
    into its scale and bias (in f32 numpy, as JAX folds them)."""
    def strip(k):
        return k.removeprefix("network.").removeprefix("layers.")

    sd = {strip(k): (v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor)
                     else np.asarray(v)) for k, v in sd.items()}
    out = {}
    for i, (lin, bn) in enumerate(((0, 1), (3, 4))):
        out[f"linear_{i}.weight"], out[f"linear_{i}.bias"] = sd[f"{lin}.weight"], sd[f"{lin}.bias"]
        scale = sd[f"{bn}.weight"] / np.sqrt(sd[f"{bn}.running_var"] + eps)
        out[f"bn_{i}_scale"] = scale.astype(np.float32)
        out[f"bn_{i}_bias"] = (sd[f"{bn}.bias"] - sd[f"{bn}.running_mean"] * scale
                               ).astype(np.float32)
    out["logits.weight"], out["logits.bias"] = sd["6.weight"], sd["6.bias"]
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def preprocess_siglip(frames: np.ndarray, image_size: int = 384) -> np.ndarray:
    """frames (N, H, W, 3) in [0, 1] -> (N, image_size, image_size, 3) in
    [-1, 1] (a bicubic resize)."""
    import cv2

    out = np.stack([cv2.resize(f, (image_size, image_size), interpolation=cv2.INTER_CUBIC)
                    for f in frames])
    return (out * 2.0 - 1.0).astype(np.float32)
