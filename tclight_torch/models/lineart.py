"""Lineart-anime annotator (counterpart of tclight_tpu/models/lineart.py),
the control images of the lineart / lineart_anime ControlNet types.

The network is Anime2Sketch's pix2pix `UnetGenerator(3, 1, num_downs=8,
ngf=64)` with parameter-free instance norms: stride-2 4x4 convolutions
down (LeakyReLU 0.2 before each but the first), 4x4 transposed
convolutions up (ReLU before each) with skip concatenation, a Tanh head.
The modules carry the flax names, so `convert_lineart_anime` (the JAX
package's converter, which walks netG.pth's nested `model.model.{i}`
Sequentials) and `models.bridge.lineart_state_dict` load a checkpoint;
`reference_state_dict` is their inverse. `lineart_anime_map` pads a frame
by a cubic resize to multiples of 256 (768 x 1024 for 720 x 960), feeds
x * 2 - 1, maps the output to [0, 1] and resizes back. The network runs in
f32 (full f32 on the card).
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tclight_torch.utils.device import full_f32, resolve_device

__all__ = ["LineartAnimeUNet", "convert_lineart_anime", "reference_state_dict",
           "load_lineart", "lineart_anime_map", "lineart_model_fn"]


def _instance_norm(x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm2d(affine=False), eps 1e-5, biased variance."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5)


class _Down(nn.Module):
    def __init__(self, cin: int, cout: int, norm: bool = True):
        super().__init__()
        self.norm = norm
        self.conv = nn.Conv2d(cin, cout, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(F.leaky_relu(x, 0.2))
        return _instance_norm(x) if self.norm else x


class _Up(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _instance_norm(self.conv(F.relu(x)))


class LineartAnimeUNet(nn.Module):
    """forward(x (B, H, W, 3) in [-1, 1], H and W multiples of
    2^num_downs) -> (B, H, W, 1) in [-1, 1]."""

    def __init__(self, ngf: int = 64, num_downs: int = 8):
        super().__init__()
        self.num_downs = num_downs
        g = ngf
        downs = [g, g * 2, g * 4] + [g * 8] * (num_downs - 3)
        self.down0 = nn.Conv2d(3, downs[0], 4, stride=2, padding=1)
        for i in range(1, num_downs):
            # the innermost block has no norm
            setattr(self, f"down{i}", _Down(downs[i - 1], downs[i], norm=i < num_downs - 1))
        ups = list(reversed(downs[:-1]))  # channels after each up conv
        cin = downs[-1]
        for i, ch in enumerate(ups):
            setattr(self, f"up{i}", _Up(cin, ch))
            cin = 2 * ch  # the skip concatenated
        self.head = nn.ConvTranspose2d(cin, 1, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.down0(x.permute(0, 3, 1, 2))
        skips = [h]
        for i in range(1, self.num_downs):
            h = getattr(self, f"down{i}")(h)
            if i < self.num_downs - 1:
                skips.append(h)
        for i in range(self.num_downs - 1):
            h = torch.cat([skips[-(i + 1)], getattr(self, f"up{i}")(h)], dim=1)
        return torch.tanh(self.head(F.relu(h))).permute(0, 2, 3, 1)


def _tk(w):
    """Conv weight (out, in, kh, kw) -> flax (kh, kw, in, out)."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _tkt(w):
    """ConvTranspose2d weight (in, out, kh, kw) -> flax's transpose_kernel
    layout (kh, kw, out, in)."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _block_prefixes(num_downs: int):
    """(flax down name, flax up name, netG.pth prefix, up conv index) of
    each nested block below the outermost: the Sequential indices are
    [1] down conv, [3] submodule, [5] up conv; the innermost's up conv at
    [3]."""
    prefix = "model.model.1."
    for i in range(1, num_downs):
        inner = i == num_downs - 1
        yield f"down{i}", f"up{num_downs - 1 - i}", prefix, 3 if inner else 5
        prefix += "model.3."


def convert_lineart_anime(sd: Mapping[str, np.ndarray], num_downs: int = 8) -> dict:
    """netG.pth (the pix2pix UnetSkipConnectionBlock recursion) -> the JAX
    package's flax tree. Outermost block: [0] down conv, [1] submodule,
    [3] up conv (the head)."""
    sd = {k.removeprefix("module."): np.asarray(v) for k, v in sd.items()}
    p: dict = {"down0": {"kernel": _tk(sd["model.model.0.weight"]),
                         "bias": sd["model.model.0.bias"]},
               "head": {"kernel": _tkt(sd["model.model.3.weight"]),
                        "bias": sd["model.model.3.bias"]}}
    for down, up, prefix, up_idx in _block_prefixes(num_downs):
        p[down] = {"conv": {"kernel": _tk(sd[prefix + "model.1.weight"]),
                            "bias": sd[prefix + "model.1.bias"]}}
        p[up] = {"conv": {"kernel": _tkt(sd[prefix + f"model.{up_idx}.weight"]),
                          "bias": sd[prefix + f"model.{up_idx}.bias"]}}
    return {"params": p}


def reference_state_dict(model: LineartAnimeUNet) -> dict[str, torch.Tensor]:
    """`model`'s weights under netG.pth's nested keys, f32 on the CPU."""
    names = {"down0.": "model.model.0.", "head.": "model.model.3."}
    for down, up, prefix, up_idx in _block_prefixes(model.num_downs):
        names[f"{down}.conv."] = prefix + "model.1."
        names[f"{up}.conv."] = prefix + f"model.{up_idx}."
    out = {}
    for key, val in model.state_dict().items():
        stem, leaf = key.rsplit(".", 1)
        out[names[stem + "."] + leaf] = val.detach().float().cpu().clone()
    return out


def load_lineart(ckpt_path: str | Path, ngf: int = 64, num_downs: int = 8,
                 device: str | torch.device = "cuda") -> LineartAnimeUNet:
    """A netG.pth (or .safetensors) checkpoint as the port's model on
    `device`, f32."""
    from tclight_torch.models import bridge
    from tclight_torch.models.convert import load_torch_state_dict

    device = resolve_device(device)
    with torch.device(device):
        model = LineartAnimeUNet(ngf, num_downs)
    model.load_state_dict(bridge.lineart_state_dict(
        convert_lineart_anime(load_torch_state_dict(ckpt_path), num_downs)))
    return model.eval().requires_grad_(False)


@torch.inference_mode()
def lineart_anime_map(model: LineartAnimeUNet, frames: np.ndarray, batch: int = 2) -> np.ndarray:
    """frames (N, H, W, 3) in [0, 1] -> lineart maps (N, H, W) in [0, 1]:
    a cubic resize up to multiples of 256, x * 2 - 1 in, (y + 1) / 2 out,
    a cubic resize back, clipped."""
    import cv2

    dev = next(model.parameters()).device
    n, h, w, _ = frames.shape
    h2, w2 = 256 * int(np.ceil(h / 256.0)), 256 * int(np.ceil(w / 256.0))
    out = np.zeros((n, h, w), np.float32)
    for i in range(0, n, batch):
        big = np.stack([cv2.resize(f, (w2, h2), interpolation=cv2.INTER_CUBIC)
                        for f in frames[i: i + batch]])
        x = torch.from_numpy(np.ascontiguousarray(big * 2.0 - 1.0, np.float32)).to(dev)
        with full_f32():
            y = model(x)[..., 0].float().cpu().numpy()
        for j, m in enumerate((y + 1.0) / 2.0):
            out[i + j] = cv2.resize(m, (w, h), interpolation=cv2.INTER_CUBIC)
    return np.clip(out, 0.0, 1.0)


def lineart_model_fn(ckpt_path, ngf: int = 64, num_downs: int = 8,
                     device: str | torch.device = "cuda"):
    """The `model_fn` of `control_preprocess` for lineart / lineart_anime:
    frames -> the maps as three equal channels."""
    model = load_lineart(ckpt_path, ngf, num_downs, device)

    def model_fn(frames: np.ndarray) -> np.ndarray:
        return np.repeat(lineart_anime_map(model, frames)[..., None], 3, axis=-1).astype(
            np.float32)

    return model_fn
