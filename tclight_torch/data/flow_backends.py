"""Optical-flow backends of the data layer (counterpart of
tclight_tpu/data/flow_backends.py):

- "raft": the port's RAFT (`models.raft.RAFTFlowModel`), passed in by the
  caller;
- "memflow": the checkpoint-exact MemFlowNet GMA-SK2 streaming core
  (`models.memflow_sk.InferenceCoreSK`, `load_memflow_core`), warm-started
  pair by pair;
- "farneback": OpenCV's dense flow, which needs no weights.

The networks come through the `raft` argument (the data parser's slot, as
in the JAX package); without one, "raft" and "memflow" raise ValueError.
Flows are (N, H, W, 2) as [dx, dy].
"""

from __future__ import annotations

import numpy as np

__all__ = ["compute_flow_pairs", "load_memflow_core", "available_backends"]


def _farneback_pair(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    import cv2

    ga = cv2.cvtColor((a * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
    gb = cv2.cvtColor((b * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
    flow = cv2.calcOpticalFlowFarneback(
        ga, gb, None, pyr_scale=0.5, levels=4, winsize=21, iterations=3,
        poly_n=7, poly_sigma=1.5, flags=0)
    return flow.astype(np.float32)


def compute_flow_pairs(frames: np.ndarray, direction: str = "future",
                       backend: str = "farneback", raft=None) -> np.ndarray:
    """Flows between consecutive frames. "future": flow[i] maps frame i ->
    i+1 (the last is zero); "past": flow[i] maps frame i -> i-1 (the first
    is zero). `raft` is the loaded network of the "raft" (a RAFTFlowModel)
    or "memflow" (an InferenceCoreSK) backend."""
    n, h, w, _ = frames.shape
    flows = np.zeros((n, h, w, 2), np.float32)
    if backend == "raft":
        if raft is None:
            raise ValueError("raft backend requires a loaded RAFT model")
        if direction == "future":
            flows[: n - 1] = raft.batched_flow(frames[:-1], frames[1:])
        else:
            flows[1:] = raft.batched_flow(frames[1:], frames[:-1])
        return flows
    if backend == "memflow":
        if raft is None:
            raise ValueError("memflow backend requires a loaded InferenceCoreSK "
                             "(pass it via the dataparser's `raft` slot)")
        raft.reset()
        # streaming with warm starts, pair by pair in the chosen direction
        for i in range(n - 1):
            if direction == "future":
                flows[i] = raft.step(frames[i], frames[i + 1])
            else:
                flows[i + 1] = raft.step(frames[i + 1], frames[i])
        return flows
    if backend != "farneback":
        raise ValueError(f"unknown flow backend {backend}")
    for i in range(n - 1):
        if direction == "future":
            flows[i] = _farneback_pair(frames[i], frames[i + 1])
        else:
            flows[i + 1] = _farneback_pair(frames[i + 1], frames[i])
    return flows


def load_memflow_core(ckpt_path, device="cuda"):
    """A `MemFlowNet_things.pth` (or `.safetensors`) checkpoint -> the
    streaming InferenceCoreSK on `device`."""
    from tclight_torch.models import bridge
    from tclight_torch.models.convert import load_torch_state_dict
    from tclight_torch.models.memflow_sk import (InferenceCoreSK, MemFlowNetSK,
                                                 MemFlowSKConfig, convert_memflow_params)

    cfg = MemFlowSKConfig()
    model = MemFlowNetSK(cfg)
    model.load_state_dict(bridge.memflow_sk_state_dict(
        convert_memflow_params(load_torch_state_dict(ckpt_path), cfg)))
    return InferenceCoreSK(model, device=device)


def available_backends() -> list[str]:
    return ["farneback", "raft", "memflow"]
