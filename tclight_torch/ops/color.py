"""Color-space ops (counterpart of tclight_tpu/ops/color.py): AdaIN
renormalization, the SH DC transforms of the Unique Video Tensor, and the
per-channel quadratic color correction. Layout: NHWC.
"""

from __future__ import annotations

import torch

__all__ = ["calc_mean_std", "adaptive_instance_normalization", "RGB2SH",
           "SH2RGB", "color_correct"]

C0 = 0.28209479177387814  # sqrt(1 / (4 pi)), the degree-0 SH basis constant


def calc_mean_std(feat: torch.Tensor, eps: float = 1e-5
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(sample, channel) spatial mean and std of (N, H, W, C) ->
    (N, 1, 1, C) each; the variance is unbiased (ddof=1)."""
    n, h, w, c = feat.shape
    flat = feat.reshape(n, h * w, c)
    mean = flat.mean(dim=1)
    var = flat.var(dim=1, unbiased=True) + eps
    return mean[:, None, None, :], var.sqrt()[:, None, None, :]


def adaptive_instance_normalization(content_feat: torch.Tensor,
                                    style_feat: torch.Tensor) -> torch.Tensor:
    """Renormalize the content statistics to the style statistics."""
    style_mean, style_std = calc_mean_std(style_feat)
    content_mean, content_std = calc_mean_std(content_feat)
    return (content_feat - content_mean) / content_std * style_std + style_mean


def RGB2SH(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / C0


def SH2RGB(sh: torch.Tensor) -> torch.Tensor:
    return sh * C0 + 0.5


def color_correct(img: torch.Tensor, ref: torch.Tensor, num_iters: int = 5,
                  eps: float = 0.5 / 255) -> torch.Tensor:
    """Warp `img`'s colors to match `ref` with a per-channel quadratic least
    squares fit over unclipped pixels. img/ref: (..., C) in [0, 1]."""
    num_channels = img.shape[-1]
    img_mat = img.reshape(-1, num_channels)
    ref_mat = ref.reshape(-1, num_channels)

    def is_unclipped(z):
        return (z >= eps) & (z <= 1 - eps)

    mask0 = is_unclipped(img_mat)

    def features(m):
        cols = [m[:, c: c + 1] * m[:, c:] for c in range(num_channels)]
        cols.append(m)
        cols.append(torch.ones_like(m[:, :1]))
        return torch.cat(cols, dim=-1)

    for _ in range(num_iters):
        a_mat = features(img_mat)
        warps = []
        for c in range(num_channels):
            b = ref_mat[:, c]
            mask = mask0[:, c] & is_unclipped(img_mat[:, c]) & is_unclipped(b)
            ma = torch.where(mask[:, None], a_mat, 0.0)
            mb = torch.where(mask, b, 0.0)
            # normal equations with a small ridge for stability
            gram = ma.T @ ma + 1e-8 * torch.eye(ma.shape[1], dtype=ma.dtype,
                                                device=ma.device)
            warps.append(torch.linalg.solve(gram, ma.T @ mb))
        img_mat = torch.clamp(a_mat @ torch.stack(warps, dim=-1), 0.0, 1.0)
    return img_mat.reshape(img.shape)
