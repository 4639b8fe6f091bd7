"""BriaRMBG (RMBG-1.4), the U^2-Net matting network of background-conditioned
relighting (counterpart of tclight_tpu/models/briarmbg.py).

RSU7..RSU4F residual U-blocks in an encoder / decoder, six sigmoid side
outputs at the input resolution; the first is the alpha matte. The module
names are the reference checkpoint's (`stage1.rebnconvin.conv_s1`, ...),
so `reference_state_dict` is the state dict itself and `load_rmbg` reads
a reference checkpoint through `convert_rmbg_params` and the bridge.

Numerics as in JAX: the 2x max pool is a "SAME"-padded reduce window from
-inf (`ceil_mode=True`), the upsampling bilinear with half-pixel centres
(`align_corners=False`; it only upsamples, so no antialiasing), BatchNorm on
its running statistics. It runs in f32, in full f32 on the card
(`utils.device.full_f32`). Layout: NHWC at `forward`'s boundary.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tclight_torch.utils.device import full_f32, resolve_device

__all__ = ["REBNCONV", "RSU", "RSU4F", "BriaRMBG", "random_rmbg", "convert_rmbg_params",
           "reference_state_dict", "load_rmbg", "compute_alpha_mattes"]


class REBNCONV(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dirate: int = 1):
        super().__init__()
        self.conv_s1 = nn.Conv2d(in_ch, out_ch, 3, padding=dirate, dilation=dirate)
        self.bn_s1 = nn.BatchNorm2d(out_ch, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn_s1(self.conv_s1(x)))


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _upsample_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    if x.shape[-2:] == ref.shape[-2:]:
        return x
    return F.interpolate(x, size=ref.shape[-2:], mode="bilinear", align_corners=False)


class RSU(nn.Module):
    """Residual U-block of a given height (RSU7: 7)."""

    def __init__(self, height: int, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.height = height
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch)
        for i in range(2, height):
            self.add_module(f"rebnconv{i}", REBNCONV(mid_ch, mid_ch))
        self.add_module(f"rebnconv{height}", REBNCONV(mid_ch, mid_ch, 2))
        for i in range(height - 1, 0, -1):
            self.add_module(f"rebnconv{i}d", REBNCONV(2 * mid_ch, out_ch if i == 1 else mid_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hin = self.rebnconvin(x)
        encs, h = [], hin
        for i in range(1, self.height):
            h = getattr(self, f"rebnconv{i}")(h)
            encs.append(h)
            if i < self.height - 1:
                h = _maxpool2(h)
        h = getattr(self, f"rebnconv{self.height}")(h)
        for i in range(self.height - 1, 0, -1):
            skip = encs[i - 1]
            h = getattr(self, f"rebnconv{i}d")(torch.cat([_upsample_like(h, skip), skip], 1))
        return h + hin


class RSU4F(nn.Module):
    """The dilated residual U-block (no pooling)."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch)
        self.rebnconv2 = REBNCONV(mid_ch, mid_ch, 2)
        self.rebnconv3 = REBNCONV(mid_ch, mid_ch, 4)
        self.rebnconv4 = REBNCONV(mid_ch, mid_ch, 8)
        self.rebnconv3d = REBNCONV(2 * mid_ch, mid_ch, 4)
        self.rebnconv2d = REBNCONV(2 * mid_ch, mid_ch, 2)
        self.rebnconv1d = REBNCONV(2 * mid_ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hin = self.rebnconvin(x)
        h1 = self.rebnconv1(hin)
        h2 = self.rebnconv2(h1)
        h3 = self.rebnconv3(h2)
        h4 = self.rebnconv4(h3)
        h3d = self.rebnconv3d(torch.cat([h4, h3], 1))
        h2d = self.rebnconv2d(torch.cat([h3d, h2], 1))
        return self.rebnconv1d(torch.cat([h2d, h1], 1)) + hin


class BriaRMBG(nn.Module):
    """forward(x (B, H, W, 3) in [0, 255]) -> six sigmoid maps (B, H, W, 1)
    at the input resolution; the first is the matte."""

    def __init__(self):
        super().__init__()
        self.stage1 = RSU(7, 3, 32, 64)
        self.stage2 = RSU(6, 64, 32, 128)
        self.stage3 = RSU(5, 128, 64, 256)
        self.stage4 = RSU(4, 256, 128, 512)
        self.stage5 = RSU4F(512, 256, 512)
        self.stage6 = RSU4F(512, 256, 512)
        self.stage5d = RSU4F(1024, 256, 512)
        self.stage4d = RSU(4, 1024, 128, 256)
        self.stage3d = RSU(5, 512, 64, 128)
        self.stage2d = RSU(6, 256, 32, 64)
        self.stage1d = RSU(7, 128, 16, 64)
        for i, c in enumerate((64, 64, 128, 256, 512, 512), 1):
            self.add_module(f"side{i}", nn.Conv2d(c, 1, 3, padding=1))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = x.permute(0, 3, 1, 2) / 255.0
        s1 = self.stage1(x)
        s2 = self.stage2(_maxpool2(s1))
        s3 = self.stage3(_maxpool2(s2))
        s4 = self.stage4(_maxpool2(s3))
        s5 = self.stage5(_maxpool2(s4))
        s6 = self.stage6(_maxpool2(s5))
        d5 = self.stage5d(torch.cat([_upsample_like(s6, s5), s5], 1))
        d4 = self.stage4d(torch.cat([_upsample_like(d5, s4), s4], 1))
        d3 = self.stage3d(torch.cat([_upsample_like(d4, s3), s3], 1))
        d2 = self.stage2d(torch.cat([_upsample_like(d3, s2), s2], 1))
        d1 = self.stage1d(torch.cat([_upsample_like(d2, s1), s1], 1))
        return [torch.sigmoid(_upsample_like(getattr(self, f"side{i}")(f), x)).permute(0, 2, 3, 1)
                for i, f in enumerate((d1, d2, d3, d4, d5, s6), 1)]


@torch.no_grad()
def random_rmbg(seed: int = 0, device: str | torch.device | None = "cuda") -> BriaRMBG:
    """BriaRMBG on random weights, for checks without the published
    checkpoint (eval mode, no grads): PyTorch's default init from `seed`,
    BatchNorm's scales, shifts and running statistics moved off their
    defaults, and each side output's convolution rescaled so that its
    logits on a random 64 x 64 image have mean 0 and standard deviation 2.
    Untouched, the logits spread over a few hundredths, and every matte is
    a flat 0.5 that a wrong layer hardly moves."""
    gen = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = BriaRMBG().eval().requires_grad_(False)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.1, generator=gen)
            m.running_var.uniform_(0.5, 1.5, generator=gen)
            m.weight.uniform_(0.5, 1.5, generator=gen)
            m.bias.normal_(0, 0.1, generator=gen)
    logits = {}
    hooks = [getattr(model, f"side{i}").register_forward_hook(
        lambda mod, inp, out, i=i: logits.__setitem__(i, out)) for i in range(1, 7)]
    model(torch.rand(1, 64, 64, 3, generator=gen) * 255.0)
    for h in hooks:
        h.remove()
    for i, out in logits.items():
        conv, g = getattr(model, f"side{i}"), 2.0 / out.std()
        conv.weight.mul_(g)
        conv.bias.copy_((conv.bias - out.mean()) * g)
    return model.to(resolve_device(device))


def convert_rmbg_params(sd: dict) -> dict:
    """A reference RMBG-1.4 state dict -> the JAX package's variables
    {"params", "batch_stats"} (conv OIHW -> HWIO; BatchNorm weight / bias
    -> scale / bias, running statistics -> mean / var)."""
    params: dict = {}
    stats: dict = {}

    def put(tree, path, val):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = val

    bn_leaves = {"weight": (params, "scale"), "bias": (params, "bias"),
                 "running_mean": (stats, "mean"), "running_var": (stats, "var")}
    for k, v in sd.items():
        v = np.asarray(v)
        parts = k.split(".")
        if parts[-2].startswith("bn"):
            if parts[-1] in bn_leaves:
                tree, leaf = bn_leaves[parts[-1]]
                put(tree, parts[:-1] + [leaf], v)
        elif parts[-2].startswith(("conv", "side")):
            if parts[-1] == "weight":
                put(params, parts[:-1] + ["kernel"], np.transpose(v, (2, 3, 1, 0)))
            else:
                put(params, parts[:-1] + ["bias"], v)
    return {"params": params, "batch_stats": stats}


def reference_state_dict(model: BriaRMBG) -> dict[str, torch.Tensor]:
    """The model's weights as a reference RMBG-1.4 state dict (the module
    names and layouts are the reference's)."""
    return dict(model.state_dict())


def load_rmbg(ckpt_path: str | Path, device: str | torch.device = "cuda") -> BriaRMBG:
    """BriaRMBG in f32 on `device` (eval mode, no grads) from a reference
    checkpoint (`.pth` / `.bin` / `.safetensors`)."""
    from tclight_torch.models import bridge
    from tclight_torch.models.convert import load_torch_state_dict

    with torch.device(resolve_device(device)):
        model = BriaRMBG()
    model.load_state_dict(bridge.rmbg_state_dict(
        convert_rmbg_params(load_torch_state_dict(ckpt_path))))
    return model.eval().requires_grad_(False)


def working_size(h: int, w: int) -> tuple[int, int]:
    """The matting resolution (rh, rw) of an h x w frame: the reference's
    ~256-pixel-area scale, times 64 (896 x 1152 for 720 x 960)."""
    scale = (256.0 / float(h * w)) ** 0.5
    return max(64, int(64 * round(h * scale))), max(64, int(64 * round(w * scale)))


@torch.inference_mode()
def compute_alpha_mattes(model: BriaRMBG, frames: np.ndarray, batch: int = 8) -> np.ndarray:
    """Alpha mattes (N, H, W) in [0, 1] of [0, 1] frames (N, H, W, 3): the
    frames resized (bilinear) to `working_size`, matted on the model's
    device in f32, the mattes resized back."""
    import cv2

    n, h, w, _ = frames.shape
    rh, rw = working_size(h, w)
    small = np.stack([cv2.resize(f, (rw, rh)) for f in frames])
    dev = next(model.parameters()).device
    outs = []
    with full_f32():
        for i in range(0, n, batch):
            x = torch.from_numpy(np.ascontiguousarray(small[i: i + batch] * 255.0)).to(dev)
            outs.append(model(x.float())[0].cpu().numpy())
    alpha_small = np.concatenate(outs)[..., 0]
    return np.clip(np.stack([cv2.resize(a, (w, h)) for a in alpha_small]), 0.0, 1.0)
