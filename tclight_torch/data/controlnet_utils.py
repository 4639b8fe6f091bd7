"""ControlNet conditioning images (counterpart of
tclight_tpu/data/controlnet_utils.py): the `CONTROLNET_DICT` registry of
control types and the preprocessors that need no network: canny edges,
tile's resample blur and ip2p's identity.

The model-backed types (openpose, softedge, depth, lineart,
lineart_anime) take a `model_fn`, frames -> control images, which the
Generator makes from `generation.annotator_ckpt` (models/hed.py for
softedge, models/lineart.py for lineart / lineart_anime,
models/openpose.py for openpose) or, for depth, from its DPT depth maps.
Without one they raise NotImplementedError, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = ["CONTROLNET_DICT", "MODEL_BACKED", "canny_preprocess", "tile_preprocess",
           "ip2p_preprocess", "control_preprocess"]

CONTROLNET_DICT = {
    "tile": "lllyasviel/control_v11f1e_sd15_tile",
    "ip2p": "lllyasviel/control_v11e_sd15_ip2p",
    "openpose": "lllyasviel/control_v11p_sd15_openpose",
    "softedge": "lllyasviel/control_v11p_sd15_softedge",
    "depth": "lllyasviel/control_v11f1p_sd15_depth",
    "lineart_anime": "lllyasviel/control_v11p_sd15s2_lineart_anime",
    "lineart": "lllyasviel/control_v11p_sd15_lineart",
    "canny": "lllyasviel/control_v11p_sd15_canny",
}

MODEL_BACKED = ("openpose", "softedge", "depth", "lineart", "lineart_anime")


def canny_preprocess(frames: np.ndarray, low: int = 100, high: int = 200) -> np.ndarray:
    """Canny edges of each [0, 1] frame, as three equal channels in {0, 1}."""
    import cv2

    outs = []
    for f in frames:
        edges = cv2.Canny((f * 255).astype(np.uint8), low, high)
        outs.append(np.stack([edges] * 3, -1).astype(np.float32) / 255.0)
    return np.stack(outs)


def tile_preprocess(frames: np.ndarray, resample_rate: float = 1.0) -> np.ndarray:
    """Down- then up-resampled frames (a blur); the identity at rate 1.0,
    the reference's default."""
    if resample_rate == 1.0:
        return frames.copy()
    import cv2

    n, h, w, _ = frames.shape
    lo = (max(1, int(round(w * resample_rate))), max(1, int(round(h * resample_rate))))
    outs = [cv2.resize(cv2.resize(f, lo, interpolation=cv2.INTER_LINEAR), (w, h),
                       interpolation=cv2.INTER_LINEAR) for f in frames]
    return np.stack(outs).astype(np.float32)


def ip2p_preprocess(frames: np.ndarray) -> np.ndarray:
    return frames.copy()


def control_preprocess(frames: np.ndarray, control_type: str,
                       model_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                       **kw) -> np.ndarray:
    """frames (N, H, W, 3) in [0, 1] -> control images (N, H, W, 3) in [0, 1]."""
    if control_type == "none":
        raise ValueError("control_type 'none' has no preprocessing")
    if control_type == "canny":
        return canny_preprocess(frames, **kw)
    if control_type == "tile":
        return tile_preprocess(frames, **kw)
    if control_type == "ip2p":
        return ip2p_preprocess(frames)
    if control_type in MODEL_BACKED:
        if model_fn is None:
            raise NotImplementedError(
                f"'{control_type}' preprocessing needs a local model; pass "
                f"model_fn (e.g. a MiDaS/HED port loaded from a checkpoint)")
        return model_fn(frames)
    raise KeyError(f"unknown control type {control_type!r}; known: {sorted(CONTROLNET_DICT)}")
