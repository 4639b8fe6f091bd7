"""Image resampling at pixel coordinates (counterpart of
tclight_tpu/ops/resample.py): bilinear and bicubic (Keys, a = -0.75)
sampling with zero padding, the gather warp's sampler.

It computes what `F.grid_sample(mode, padding_mode="zeros",
align_corners=True)` computes on coordinates normalised as 2x/(W-1)-1, the
reference's own op, but as the JAX package does: in pixel space, tap by
tap. grid_sample's round trip through [-1, 1] moves an integer coordinate
by an ulp, so a zero flow no longer samples (nor back-propagates) exactly
the identity; in the UVT loss the image and warp terms then fail to cancel
exactly, and Adam's eps=1e-15 turns the residual into full-size steps.
"""

from __future__ import annotations

import torch

__all__ = ["identity_grid", "grid_sample_2d", "bilinear_sample", "bicubic_sample"]


def identity_grid(height: int, width: int, dtype=torch.float32,
                  device: str | torch.device = "cpu") -> torch.Tensor:
    """(H, W, 2) grid of pixel coordinates [x, y]."""
    ys, xs = torch.meshgrid(torch.arange(height, dtype=dtype, device=device),
                            torch.arange(width, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)


def _gather_hw(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """img (N, H, W, C) at integer (iy, ix) (N, Ho, Wo); zero outside."""
    n, h, w, c = img.shape
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(n, -1, 1)
    vals = torch.gather(img.reshape(n, h * w, c), 1, idx.expand(-1, -1, c))
    return torch.where(valid[..., None], vals.reshape(*iy.shape, c), 0.0)


def _cubic_weights(t: torch.Tensor, a: float = -0.75):
    """Weights of the taps at offsets -1, 0, 1, 2 from floor(x)."""
    def near(s):
        return ((a + 2.0) * s - (a + 3.0)) * s * s + 1.0

    def far(s):
        return (((s - 5.0) * s + 8.0) * s - 4.0) * a

    return far(1.0 + t), near(t), near(1.0 - t), far(2.0 - t)


def grid_sample_2d(images: torch.Tensor, coords: torch.Tensor,
                   mode: str = "bicubic") -> torch.Tensor:
    """Sample images (N, H, W, C) at pixel coords (N, Ho, Wo, 2) [x, y] with
    zero padding; mode "bilinear" or "bicubic"."""
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    ix0, iy0 = x0.long(), y0.long()
    if mode == "bilinear":
        wx, wy = (x - x0)[..., None], (y - y0)[..., None]
        top = (_gather_hw(images, iy0, ix0) * (1 - wx)
               + _gather_hw(images, iy0, ix0 + 1) * wx)
        bot = (_gather_hw(images, iy0 + 1, ix0) * (1 - wx)
               + _gather_hw(images, iy0 + 1, ix0 + 1) * wx)
        return top * (1 - wy) + bot * wy
    if mode != "bicubic":
        raise ValueError(f"unknown sampling mode {mode!r}")
    wx, wy = _cubic_weights(x - x0), _cubic_weights(y - y0)
    out = None
    for j, wyj in enumerate(wy):
        row = None
        for i, wxi in enumerate(wx):
            contrib = _gather_hw(images, iy0 + (j - 1), ix0 + (i - 1)) * wxi[..., None]
            row = contrib if row is None else row + contrib
        contrib = row * wyj[..., None]
        out = contrib if out is None else out + contrib
    return out


def bilinear_sample(images: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    return grid_sample_2d(images, coords, mode="bilinear")


def bicubic_sample(images: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    return grid_sample_2d(images, coords, mode="bicubic")
