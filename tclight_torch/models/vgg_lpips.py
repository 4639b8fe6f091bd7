"""VGG16 features, the perceptual loss and LPIPS (counterpart of
tclight_tpu/models/vgg_lpips.py).

`VGG16Features` takes NHWC images in [0, 1], normalizes them with
ImageNet's constants and returns the NCHW feature maps after the ReLUs of
convs 1, 3, 6, 9 and 12 (blocks 1_2 .. 5_3), the pools 2x2 VALID max
pools. `LPIPS` unit-normalizes each tap's channels (rsqrt with eps 1e-10),
weights the squared differences by the lin heads (clamped at 0 by
`load_lpips_lin_weights`), averages over space and sums over taps.
`convert_vgg16_features` (numpy, the JAX package's code) maps torchvision's
`features.N` keys onto the flax tree; `models.bridge.vgg16_state_dict`
turns it into this module's state dict.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["VGG16Features", "convert_vgg16_features", "reference_state_dict",
           "VGGPerceptualLoss", "LPIPS", "load_lpips_lin_weights"]

# torchvision's ImageNet normalization
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)

# VGG16's conv widths, "M" a max pool
_VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512, "M")
_LPIPS_TAPS = (1, 3, 6, 9, 12)  # conv indices, counting convs only


class VGG16Features(nn.Module):
    def __init__(self):
        super().__init__()
        cin, i = 3, 0
        for item in _VGG16_PLAN:
            if item != "M":
                self.add_module(f"conv_{i}", nn.Conv2d(cin, item, 3, padding=1))
                cin, i = item, i + 1
        self.register_buffer("mean", torch.from_numpy(_MEAN)[:, None, None], persistent=False)
        self.register_buffer("std", torch.from_numpy(_STD)[:, None, None], persistent=False)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x (B, H, W, 3) in [0, 1] -> the five taps, NCHW."""
        h = (x.permute(0, 3, 1, 2) - self.mean) / self.std
        feats, i = [], 0
        for item in _VGG16_PLAN:
            if item == "M":
                h = F.max_pool2d(h, 2, 2)
                continue
            h = F.relu(getattr(self, f"conv_{i}")(h))
            if i in _LPIPS_TAPS:
                feats.append(h)
            i += 1
        return feats


def convert_vgg16_features(sd: dict) -> dict:
    """torchvision vgg16's state dict ('features.N.weight') -> the flax tree."""
    params: dict = {}
    conv_i = layer_idx = 0
    for item in _VGG16_PLAN:
        if item == "M":
            layer_idx += 1  # the MaxPool module
            continue
        params[f"conv_{conv_i}"] = {
            "kernel": np.transpose(np.asarray(sd[f"features.{layer_idx}.weight"]), (2, 3, 1, 0)),
            "bias": np.asarray(sd[f"features.{layer_idx}.bias"]),
        }
        conv_i += 1
        layer_idx += 2  # the Conv and its ReLU
    return {"params": params}


def reference_state_dict(model: VGG16Features) -> dict[str, torch.Tensor]:
    """`model`'s weights under torchvision vgg16's `features.N` keys: the
    inverse of `convert_vgg16_features` followed by `bridge.vgg16_state_dict`."""
    sd, out, conv_i, layer_idx = model.state_dict(), {}, 0, 0
    for item in _VGG16_PLAN:
        if item == "M":
            layer_idx += 1
            continue
        for leaf in ("weight", "bias"):
            out[f"features.{layer_idx}.{leaf}"] = sd[f"conv_{conv_i}.{leaf}"].detach().float().cpu()
        conv_i, layer_idx = conv_i + 1, layer_idx + 2
    return out


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32) if not torch.is_tensor(a) else a,
                           device=device)


class VGGPerceptualLoss:
    """The sum over `layers` of the taps' mean L1 distance."""

    def __init__(self, vgg: VGG16Features, layers: Sequence[int] = (0, 1, 2, 3)):
        self.model = vgg.eval()
        self.layers = tuple(layers)

    def __call__(self, a, b) -> torch.Tensor:
        dev = next(self.model.parameters()).device
        fa, fb = self.model(_tensor(a, dev)), self.model(_tensor(b, dev))
        return sum((fa[i] - fb[i]).abs().mean() for i in self.layers)


class LPIPS:
    """LPIPS('vgg') between image batches (B, H, W, 3) in [0, 1] -> (B,)."""

    def __init__(self, vgg: VGG16Features, lin_weights: Sequence[np.ndarray]):
        """lin_weights: per tap the (C,) nonnegative channel weights (the lpips
        'vgg' checkpoint's 1x1 conv weights)."""
        self.model = vgg.eval()
        dev = next(vgg.parameters()).device
        self.lin = [torch.as_tensor(np.asarray(w, np.float32).reshape(1, -1, 1, 1), device=dev)
                    for w in lin_weights]

    @torch.no_grad()
    def __call__(self, a, b) -> np.ndarray:
        dev = self.lin[0].device
        fa, fb = self.model(_tensor(a, dev)), self.model(_tensor(b, dev))
        total = 0.0
        for f1, f2, w in zip(fa, fb, self.lin):
            n1 = f1 * torch.rsqrt((f1 ** 2).sum(1, keepdim=True) + 1e-10)
            n2 = f2 * torch.rsqrt((f2 ** 2).sum(1, keepdim=True) + 1e-10)
            total = total + ((n1 - n2) ** 2 * w).sum(1).mean(dim=(1, 2))
        return total.cpu().numpy()


def load_lpips_lin_weights(sd: dict) -> list[np.ndarray]:
    """The lpips 'vgg' checkpoint's lin{i}.model.1.weight (1, C, 1, 1),
    clamped at 0."""
    return [np.maximum(np.asarray(sd[f"lin{i}.model.1.weight"]).reshape(-1), 0.0)
            for i in range(5)]
