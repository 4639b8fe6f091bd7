"""Reconstruction losses (counterpart of tclight_tpu/ops/losses.py): L1,
L2, SSIM, relaxed multi-scale SSIM, TV and PSNR, with the JAX package's
numerics (the same Gaussian windows, the valid-padding MS-SSIM pyramid
with `start_level` skipping of fine scales, and torch's odd-size average
pool padding). The depthwise Gaussian is a grouped `F.conv2d`.

Layout: images are NHWC float in [0, data_range].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["l1_loss", "l2_loss", "ssim", "relaxed_ms_ssim", "tv_loss", "psnr",
           "MS_SSIM_WEIGHTS"]

MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs().mean()


def l2_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((x - y) ** 2).mean()


def _gauss_1d(size: int, sigma: float, device=None) -> torch.Tensor:
    xs = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _depthwise(x: torch.Tensor, kernel: torch.Tensor, padding) -> torch.Tensor:
    """x (N, C, H, W); kernel (kh, kw) applied to every channel."""
    c = x.shape[1]
    k = kernel.to(x.dtype)[None, None].expand(c, 1, *kernel.shape)
    return F.conv2d(x, k, padding=padding, groups=c)


def _separable_gauss(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Valid-padding separable Gaussian on (N, C, H, W)."""
    return _depthwise(_depthwise(x, win[:, None], 0), win[None, :], 0)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """SSIM with a 2-D Gaussian window and SAME zero padding.
    img1/img2: (N, H, W, C) in [0, 1]."""
    win1d = _gauss_1d(window_size, 1.5, img1.device)
    win2d = win1d[:, None] * win1d[None, :]
    pad = window_size // 2
    a, b = img1.permute(0, 3, 1, 2), img2.permute(0, 3, 1, 2)

    def conv(z):
        return _depthwise(z, win2d, pad)

    mu1, mu2 = conv(a), conv(b)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = conv(a * a) - mu1_sq
    sigma2_sq = conv(b * b) - mu2_sq
    sigma12 = conv(a * b) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


def _relaxed_ssim_level(x, y, win, data_range, k):
    c1 = (k[0] * data_range) ** 2
    c2 = (k[1] * data_range) ** 2
    mu1, mu2 = _separable_gauss(x, win), _separable_gauss(y, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _separable_gauss(x * x, win) - mu1_sq
    sigma2_sq = _separable_gauss(y * y, win) - mu2_sq
    sigma12 = _separable_gauss(x * y, win) - mu1_mu2
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = (2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1) * cs_map
    return ssim_map.mean(dim=(2, 3)), cs_map.mean(dim=(2, 3))  # (N, C) each


def relaxed_ms_ssim(x: torch.Tensor, y: torch.Tensor, start_level: int = 0,
                    data_range: float = 255.0, size_average: bool = True,
                    win_size: int = 11, win_sigma: float = 1.5,
                    weights: tuple[float, ...] = MS_SSIM_WEIGHTS,
                    k: tuple[float, float] = (0.01, 0.03)) -> torch.Tensor:
    """MS-SSIM whose levels below `start_level` contribute ones, so only
    the coarse structure is constrained. x/y: (N, H, W, C); the smaller
    side must exceed (win_size - 1) * 2^(levels - 1)."""
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch {tuple(x.shape)} vs {tuple(y.shape)}")
    smaller = min(x.shape[1], x.shape[2])
    needed = (win_size - 1) * 2 ** (len(weights) - 1)
    if smaller <= needed:
        raise ValueError(f"image side {smaller} too small for {len(weights)}-level "
                         f"ms-ssim (needs > {needed})")
    win = _gauss_1d(win_size, win_sigma, x.device)
    weights_t = torch.tensor(weights, dtype=x.dtype, device=x.device)
    levels = len(weights)
    x, y = x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)
    mcs = []
    ssim_pc = None
    for i in range(levels):
        if i >= start_level:
            ssim_pc, cs = _relaxed_ssim_level(x, y, win, data_range, k)
        else:
            ssim_pc = x.new_ones(x.shape[:2])
            cs = torch.ones_like(ssim_pc)
        if i < levels - 1:
            mcs.append(F.relu(cs))
            pad = (x.shape[2] % 2, x.shape[3] % 2)
            x = F.avg_pool2d(x, 2, stride=2, padding=pad, count_include_pad=True)
            y = F.avg_pool2d(y, 2, stride=2, padding=pad, count_include_pad=True)
    stack = torch.stack(mcs + [F.relu(ssim_pc)])  # (L, N, C)
    val = torch.prod(stack ** weights_t[:, None, None], dim=0)
    if size_average:
        return val.mean()
    return val.mean(dim=1)


def tv_loss(x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Total-variation loss. x: (N, H, W, C)."""
    n, h, w, c = x.shape
    h_tv = ((x[:, 1:] - x[:, :-1]) ** 2).sum()
    w_tv = ((x[:, :, 1:] - x[:, :, :-1]) ** 2).sum()
    return weight * 2.0 * (h_tv / (c * (h - 1) * w) + w_tv / (c * h * (w - 1))) / n


def psnr(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    mse = ((img1 - img2) ** 2).mean()
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))
