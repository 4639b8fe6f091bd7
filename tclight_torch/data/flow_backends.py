"""Optical-flow backends of the data layer (counterpart of
tclight_tpu/data/flow_backends.py).

Only the weight-free OpenCV Farneback backend is ported. The RAFT and
MemFlow networks are not (ROADMAP A9): their flows are read from the data
parser's flow cache, and computing them raises NotImplementedError.

Flows are (N, H, W, 2) as [dx, dy].
"""

from __future__ import annotations

import numpy as np

__all__ = ["compute_flow_pairs"]


def _farneback_pair(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    import cv2

    ga = cv2.cvtColor((a * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
    gb = cv2.cvtColor((b * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
    flow = cv2.calcOpticalFlowFarneback(
        ga, gb, None, pyr_scale=0.5, levels=4, winsize=21, iterations=3,
        poly_n=7, poly_sigma=1.5, flags=0)
    return flow.astype(np.float32)


def compute_flow_pairs(frames: np.ndarray, direction: str = "future",
                       backend: str = "farneback") -> np.ndarray:
    """Flows between consecutive frames. "future": flow[i] maps frame i ->
    i+1 (the last is zero); "past": flow[i] maps frame i -> i-1 (the first
    is zero)."""
    if backend in ("raft", "memflow"):
        raise NotImplementedError(
            f"flow backend {backend!r} is not ported yet (ROADMAP A9): its flows "
            "must be in the flow cache next to the video; or use "
            "data.flow_model=farneback")
    if backend != "farneback":
        raise ValueError(f"unknown flow backend {backend}")
    n, h, w, _ = frames.shape
    flows = np.zeros((n, h, w, 2), np.float32)
    for i in range(n - 1):
        if direction == "future":
            flows[i] = _farneback_pair(frames[i], frames[i + 1])
        else:
            flows[i + 1] = _farneback_pair(frames[i + 1], frames[i])
    return flows
