"""HED soft-edge annotator (counterpart of tclight_tpu/models/hed.py), the
control images of the softedge / scribble ControlNet types.

ControlNetHED_Apache2: the input (0..255 RGB) less a learned `norm`, five
VGG-style blocks of 3x3 convolutions and ReLUs (a 2x2 max pool before each
block after the first), and each block's 1x1 projection to an edge logit
map. `hed_edges` resizes the five maps to the frame (cv2 bilinear), takes
their mean and a float64 sigmoid, optionally quantised by controlnet_aux's
`safe_step`. The modules carry the flax names, so `convert_hed` (the JAX
package's converter) and `models.bridge.hed_state_dict` load a
ControlNetHED checkpoint; `reference_state_dict` is their inverse. The
network runs in f32 (full f32 on the card).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tclight_torch.utils.device import full_f32, resolve_device

__all__ = ["ControlNetHED", "convert_hed", "reference_state_dict", "load_hed", "hed_edges",
           "softedge_model_fn"]

_BLOCK_PLAN = ((3, 64, 2), (64, 128, 2), (128, 256, 3), (256, 512, 3), (512, 512, 3))


class ControlNetHED(nn.Module):
    """forward(x (B, H, W, 3) in 0..255) -> five edge-logit maps (B, h, w)
    at strides 1, 2, 4, 8, 16."""

    def __init__(self, width_mult: float = 1.0):
        super().__init__()
        self.norm = nn.Parameter(torch.zeros(1, 1, 1, 3))
        cin = 3
        for bi, (_, out_ch, n_layers) in enumerate(_BLOCK_PLAN, start=1):
            out_ch = max(1, int(out_ch * width_mult))
            for li in range(n_layers):
                setattr(self, f"block{bi}_conv{li}", nn.Conv2d(cin, out_ch, 3, padding=1))
                cin = out_ch
            setattr(self, f"block{bi}_projection", nn.Conv2d(out_ch, 1, 1))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        h = (x - self.norm).permute(0, 3, 1, 2)
        projections = []
        for bi, (_, _, n_layers) in enumerate(_BLOCK_PLAN, start=1):
            if bi > 1:
                h = F.max_pool2d(h, 2, 2)
            for li in range(n_layers):
                h = F.relu(getattr(self, f"block{bi}_conv{li}")(h))
            projections.append(getattr(self, f"block{bi}_projection")(h)[:, 0])
        return projections


def convert_hed(sd: Mapping[str, np.ndarray]) -> dict:
    """ControlNetHED_Apache2 state dict -> the JAX package's flax tree."""
    p: dict = {}

    def put(path, v):
        node = p
        parts = path.split("/")
        for q in parts[:-1]:
            node = node.setdefault(q, {})
        node[parts[-1]] = np.asarray(v)

    for k, v in sd.items():
        if k == "norm":
            put("norm", np.asarray(v).reshape(1, 1, 1, 3))
        elif m := re.fullmatch(r"block(\d)\.convs\.(\d)\.(weight|bias)", k):
            bi, li, wb = m.groups()
            put(f"block{bi}_conv{li}/{'kernel' if wb == 'weight' else 'bias'}",
                np.transpose(v, (2, 3, 1, 0)) if wb == "weight" else v)
        elif m := re.fullmatch(r"block(\d)\.projection\.(weight|bias)", k):
            bi, wb = m.groups()
            put(f"block{bi}_projection/{'kernel' if wb == 'weight' else 'bias'}",
                np.transpose(v, (2, 3, 1, 0)) if wb == "weight" else v)
        else:
            raise KeyError(f"unmatched HED key {k}")
    return {"params": p}


def reference_state_dict(model: ControlNetHED) -> dict[str, torch.Tensor]:
    """`model`'s weights under ControlNetHED_Apache2's keys (`norm` as (1, 3,
    1, 1), `blockN.convs.M`, `blockN.projection`), f32 on the CPU."""
    out = {}
    for key, val in model.state_dict().items():
        val = val.detach().float().cpu().clone()
        if key == "norm":
            out["norm"] = val.reshape(1, 3, 1, 1)
        elif m := re.fullmatch(r"block(\d)_conv(\d)\.(weight|bias)", key):
            out[f"block{m.group(1)}.convs.{m.group(2)}.{m.group(3)}"] = val
        else:
            out[re.sub(r"^block(\d)_projection\.", r"block\1.projection.", key)] = val
    return out


def load_hed(ckpt_path: str | Path, device: str | torch.device = "cuda") -> ControlNetHED:
    """A ControlNetHED checkpoint (.pth or .safetensors) as the port's
    model on `device`, f32."""
    from tclight_torch.models import bridge
    from tclight_torch.models.convert import load_torch_state_dict

    device = resolve_device(device)
    with torch.device(device):
        model = ControlNetHED()
    model.load_state_dict(bridge.hed_state_dict(convert_hed(load_torch_state_dict(ckpt_path))))
    return model.eval().requires_grad_(False)


@torch.inference_mode()
def hed_edges(model: ControlNetHED, frames: np.ndarray, batch: int = 4,
              safe: bool = False) -> np.ndarray:
    """frames (N, H, W, 3) in [0, 1] -> edge maps (N, H, W) in [0, 1]: the
    five logit maps resized to (H, W) (cv2 bilinear, f32), their mean and
    sigmoid in float64; `safe` quantises to controlnet_aux's safe steps."""
    import cv2

    dev = next(model.parameters()).device
    n, h, w, _ = frames.shape
    out = np.zeros((n, h, w), np.float32)
    for i in range(0, n, batch):
        chunk = torch.from_numpy(np.ascontiguousarray(frames[i: i + batch] * 255.0,
                                                      np.float32)).to(dev)
        with full_f32():
            projs = [pm.float().cpu().numpy() for pm in model(chunk)]
        for b in range(chunk.shape[0]):
            maps = [cv2.resize(pm[b], (w, h), interpolation=cv2.INTER_LINEAR) for pm in projs]
            edge = 1.0 / (1.0 + np.exp(-np.mean(np.stack(maps), axis=0, dtype=np.float64)))
            if safe:
                y = edge.astype(np.float64) * 2.0
                edge = (np.floor(y * 2.0 + 0.5) / 2.0 / 2.0).clip(0, 1)
            out[i + b] = edge.astype(np.float32)
    return out


def softedge_model_fn(ckpt_path, device: str | torch.device = "cuda"):
    """The `model_fn` of `control_preprocess` for softedge / scribble:
    frames -> the edge maps as three equal channels."""
    model = load_hed(ckpt_path, device)

    def fn(frames: np.ndarray) -> np.ndarray:
        return np.repeat(hed_edges(model, frames)[..., None], 3, axis=-1)

    return fn
