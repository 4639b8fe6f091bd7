"""Evaluation metrics (counterpart of tclight_tpu/eval/metrics.py).

- `warp_error_ssim`: the edited frame t warped to t+1 along the backward
  flow of the *source* video, both masked by the forward / backward
  consistency of the source's flows, then SSIM (`ssim_uniform`,
  skimage's uniform 7x7 window on uint8 data). The masks and the bilinear
  gather warp run on the device (`ops.flow`), the SSIM on the host.
- `psnr`, `ssim_gaussian` (the reference's 11x11 Gaussian SSIM on [0, 1]
  data) and the CLIP scores (`clip_frame_score`, `clip_text_score`,
  `pick_score`) are numpy / scipy on the host, as the reference defines
  them.
- `frame_lpips`: mean LPIPS between edited and source frames, 4 frames a
  call.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from tclight_torch.ops.flow import compute_fwdbwd_mask, warp_flow
from tclight_torch.utils.device import resolve_device

__all__ = ["ssim_uniform", "warp_error_ssim", "clip_frame_score", "clip_text_score",
           "pick_score", "psnr", "ssim_gaussian", "frame_lpips"]


def ssim_uniform(a: np.ndarray, b: np.ndarray, win: int = 7,
                 data_range: float = 255.0) -> float:
    """skimage.metrics.structural_similarity defaults: uniform win x win
    filter, per-channel mean, sample (ddof=1) covariances, Gaussian off."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]

    pad = win // 2
    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    n = win * win
    cov_norm = n / (n - 1)

    def filt(x):
        # uniform filter via cumulative sums, 'valid' region only
        from scipy.ndimage import uniform_filter

        return uniform_filter(x, size=win)

    vals = []
    for c in range(a.shape[-1]):
        x, y = a[..., c], b[..., c]
        ux, uy = filt(x), filt(y)
        uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
            (ux**2 + uy**2 + c1) * (vx + vy + c2)
        )
        vals.append(s[pad:-pad, pad:-pad].mean())
    return float(np.mean(vals))


def warp_error_ssim(
    edited: np.ndarray,          # (N, H, W, 3) float [0,1] edited frames
    source: np.ndarray,          # (N, H, W, 3) float [0,1] source frames
    flow_fn: Callable[[np.ndarray, np.ndarray], np.ndarray] | None = None,
    flow_fwd: np.ndarray | None = None,
    flow_bwd: np.ndarray | None = None,
    device: str | torch.device | None = "cuda",
) -> float:
    """Flows from the SOURCE video (flow_fwd[i] maps i -> i+1, flow_bwd[i]
    i+1 -> i), SSIM on the EDITED video. flow_fn(a, b) -> the flow from a
    to b computes them when they are not given."""
    n = edited.shape[0]
    if flow_fwd is None or flow_bwd is None:
        assert flow_fn is not None, "need flow_fn or precomputed flows"
        flow_fwd = np.stack([flow_fn(source[i], source[i + 1]) for i in range(n - 1)])
        flow_bwd = np.stack([flow_fn(source[i + 1], source[i]) for i in range(n - 1)])
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    scores = []
    for i in range(n - 1):
        fb = t(flow_bwd[i][None])
        with torch.no_grad():
            _, mask_bwd = compute_fwdbwd_mask(t(flow_fwd[i][None]), fb)
            warped = warp_flow(t(edited[i][None]), fb, mode="bilinear")
        mask = mask_bwd[0, ..., None].cpu().numpy()
        cur = np.where(mask, warped[0].cpu().numpy(), 0.0)
        nxt = np.where(mask, edited[i + 1], 0.0)
        scores.append(ssim_uniform(np.uint8(np.clip(cur, 0, 1) * 255.0),
                                   np.uint8(np.clip(nxt, 0, 1) * 255.0)))
    return float(np.mean(scores))


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """Mean per-frame PSNR of [0,1] images (eval_utils.py:390-392)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = ((a - b) ** 2).reshape(a.shape[0], -1).mean(axis=1)
    return float(np.mean(20.0 * np.log10(1.0 / np.sqrt(np.maximum(mse, 1e-12)))))


def _gaussian_window(win: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(win) - win // 2) ** 2) / (2.0 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float64)


def ssim_gaussian(a: np.ndarray, b: np.ndarray, win: int = 11) -> float:
    """The reference eval ssim (eval_utils.py:395-434): 11x11 Gaussian
    window sigma 1.5, per-channel depthwise conv with same-padding,
    C1=0.01^2, C2=0.03^2 on [0,1] data, mean over the full map.
    a, b: (N, H, W, C) or (H, W, C) in [0,1]."""
    from scipy.signal import convolve2d

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        a, b = a[None], b[None]
    w = _gaussian_window(win)
    c1, c2 = 0.01**2, 0.03**2

    def filt(x):  # (H, W) same-padding depthwise conv
        return convolve2d(x, w, mode="same", boundary="fill")

    vals = []
    for n in range(a.shape[0]):
        for c in range(a.shape[-1]):
            x, y = a[n, ..., c], b[n, ..., c]
            mu1, mu2 = filt(x), filt(y)
            s1 = filt(x * x) - mu1**2
            s2 = filt(y * y) - mu2**2
            s12 = filt(x * y) - mu1 * mu2
            m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
                (mu1**2 + mu2**2 + c1) * (s1 + s2 + c2)
            )
            vals.append(m.mean())
    return float(np.mean(vals))


def frame_lpips(edited: np.ndarray, source: np.ndarray, lpips_obj,
                batch: int = 4) -> float:
    """Mean LPIPS between edited frame i and source frame i over frames
    [0, N-1), `batch` frames a call."""
    n = edited.shape[0] - 1
    vals = [np.asarray(lpips_obj(edited[i:min(i + batch, n)],
                                 source[i:min(i + batch, n)])).reshape(-1)
            for i in range(0, n, batch)]
    return float(np.concatenate(vals).mean())


def clip_frame_score(image_embs: np.ndarray) -> float:
    """Mean pairwise off-diagonal cosine similarity of frame embeddings."""
    e = image_embs / np.linalg.norm(image_embs, axis=-1, keepdims=True)
    sim = e @ e.T
    np.fill_diagonal(sim, 0.0)
    n = len(e)
    return float(sim.sum() / (n * (n - 1)))


def clip_text_score(image_embs: np.ndarray, text_emb: np.ndarray) -> float:
    ie = image_embs / np.linalg.norm(image_embs, axis=-1, keepdims=True)
    te = text_emb / np.linalg.norm(text_emb)
    return float((ie @ te).mean())


def pick_score(image_embs: np.ndarray, text_emb: np.ndarray,
               logit_scale: float = 100.0) -> float:
    ie = image_embs / np.linalg.norm(image_embs, axis=-1, keepdims=True)
    te = text_emb / np.linalg.norm(text_emb)
    return float((logit_scale * (te @ ie.T)).mean())
