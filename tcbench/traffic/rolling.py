"""The seeded rolling-texture clip, in NumPy.

A texture of uniform noise in [low, high] is blurred by a Gaussian of
`blur_px` (wrapping at the edges, so the roll is seamless) and rolled
`shift_px` pixels a frame along the width: a clip whose exact motion is
known and whose neighbouring frames share most of their content, as
TC-Light's inputs do. The seed gives the texture; the same seed gives the
same clip.

The sampling stage takes the clip as IC-Light's concat conditions at the
latent size (H / 8, W / 8). `latents` maps it there without a network: the
mean of each 8 x 8 pixel block, standardised per colour channel by the
first frame's statistics, mixed into the latent channels by a fixed
matrix. The rolled texture thus stays a rolled texture in latent space,
shifted shift_px / 8 latent pixels a frame.
"""

from __future__ import annotations

import numpy as np

# colour -> latent channel mix (unit rows), fixed
_MIX = np.array([[0.8, 0.2, 0.0, 0.56],
                 [0.0, 0.8, 0.2, -0.56],
                 [0.2, 0.0, 0.8, 0.56]], np.float32)


def texture(params: dict, seed: int) -> np.ndarray:
    h, w = params["height"], params["width"]
    rng = np.random.default_rng(seed)
    base = rng.uniform(params["low"], params["high"], (h, w, 3))
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    gain = np.exp(-2.0 * (np.pi * params["blur_px"]) ** 2 * (fy ** 2 + fx ** 2))
    spec = np.fft.rfft2(base - base.mean(), axes=(0, 1)) * gain[..., None]
    return (np.fft.irfft2(spec, s=(h, w), axes=(0, 1)) + base.mean()).astype(np.float32)


def frames(params: dict, seed: int) -> np.ndarray:
    """(N, H, W, 3) float32 in [0, 1]."""
    base = texture(params, seed)
    return np.stack([np.roll(base, params["shift_px"] * t, axis=1)
                     for t in range(params["frames"])])


def latents(params: dict, seed: int, factor: int, channels: int) -> np.ndarray:
    """(N, H / factor, W / factor, channels) float32."""
    if channels > _MIX.shape[1]:
        raise ValueError(f"at most {_MIX.shape[1]} latent channels")
    f = frames(params, seed)
    n, h, w, _ = f.shape
    pooled = f.reshape(n, h // factor, factor, w // factor, factor, 3).mean(axis=(2, 4))
    mean, std = pooled[0].mean(axis=(0, 1)), pooled[0].std(axis=(0, 1))
    return ((pooled - mean) / std) @ _MIX[:, :channels]
