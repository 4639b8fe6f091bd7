"""Video data parser (counterpart of tclight_tpu/data/dataparsers.py):
frame loading, flows cached on disk next to the video, soft backward
masks and pixel tracks; `make_data_parser` also builds the synthetic-scene
parsers of data/synthetic.py.

The flow cache is the JAX package's: `<stem>_{future,past}_flow_<backend>/
NNNNN.npy`, one (H, W, 2) f32 array per frame, so a cache written by either
package is read by the other. Tracks are numbered by the native host code
(`tclight_torch.native`), as the JAX data layer numbers them whenever its
native library loads.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Sequence

import numpy as np

from tclight_torch.data.flow_backends import compute_flow_pairs
from tclight_torch.utils.logging import get_logger
from tclight_torch.utils.video_io import load_video

log = get_logger()


class VideoDataParser:
    """`flow_backend` overrides the config's `flow_model`; `raft` is the
    loaded flow network of the "raft" or "memflow" backend, which computes
    the flows that miss the cache (without one such a miss raises)."""

    def __init__(self, cfg, flow_backend: str | None = None, raft=None):
        self.cfg = cfg
        self.rgb_path = cfg.get("rgb_path")
        self.height = cfg.get("height")
        self.width = cfg.get("width")
        self.fps = cfg.get("fps", 25)
        self.flow_backend = flow_backend or cfg.get("flow_model", "farneback")
        self.raft = raft
        self.unq_inv: np.ndarray | None = None
        self.n_unique: int | None = None
        self._data_cache = None

    def load_video(self, frame_ids: Sequence[int] | None = None,
                   path: str | None = None) -> np.ndarray:
        """(N, H, W, 3) float32 frames in [0, 1] of the parser's video, or of
        the video or image at `path` (the fbc background), at the parser's
        size."""
        return load_video(path or self.rgb_path, self.height, self.width, frame_ids=frame_ids)

    def _flow_cache_dir(self, direction: str) -> Path:
        stem = Path(self.rgb_path).with_suffix("")
        return Path(f"{stem}_{direction}_flow_{self.flow_backend}")

    def load_flow(self, frames: np.ndarray, frame_ids: Sequence[int],
                  direction: str) -> np.ndarray:
        """Per-frame flows in `direction`, read from the disk cache or
        computed (and cached) for the frames that miss it."""
        cache = self._flow_cache_dir(direction)
        flows = np.zeros(frames.shape[:3] + (2,), np.float32)
        missing = []
        for j, fid in enumerate(frame_ids):
            f = cache / f"{fid:05d}.npy"
            if f.exists():
                flows[j] = np.load(f)
            else:
                missing.append(j)
        if missing:
            log.info("computing %d %s flows with %s", len(missing), direction,
                     self.flow_backend)
            computed = compute_flow_pairs(frames, direction, self.flow_backend,
                                          raft=self.raft)
            cache.mkdir(parents=True, exist_ok=True)
            for j in missing:
                flows[j] = computed[j]
                np.save(cache / f"{frame_ids[j]:05d}.npy", computed[j])
        return flows

    def load_data(self, frame_ids: Sequence[int], device="cuda"):
        """Returns (rgbs, None, None, future_flows, past_flows, mask_bwds),
        host numpy arrays, and sets self.unq_inv / self.n_unique. The soft
        masks are computed on `device`.

        Memoized (single slot) on the frame set and device: a Generator
        serves many prompts per video."""
        from tclight_torch import native
        from tclight_torch.ops.flow import get_soft_mask_bwds_chunked

        key = (tuple(frame_ids), str(device))
        if self._data_cache is not None and self._data_cache[0] == key:
            _, out, self.unq_inv, self.n_unique = self._data_cache
            return out
        t0 = time.perf_counter()
        rgbs = self.load_video(frame_ids=frame_ids)
        future = self.load_flow(rgbs, frame_ids, "future")
        past = self.load_flow(rgbs, frame_ids, "past")
        t1 = time.perf_counter()
        mask_bwds = get_soft_mask_bwds_chunked(rgbs, future, past, chunk=8,
                                               device=device)
        t2 = time.perf_counter()
        flow_ids = native.get_flowid_native(rgbs, future, mask_bwds)
        self.unq_inv, self.n_unique = native.unique_inverse_native(flow_ids)
        t3 = time.perf_counter()
        log.info("unique tracks: %d / %d pixels (video+flows %.1fs, soft masks "
                 "%.1fs, tracks %.1fs)", self.n_unique, flow_ids.size,
                 t1 - t0, t2 - t1, t3 - t2)
        out = (rgbs, None, None, future, past, mask_bwds)
        self._data_cache = (key, out, self.unq_inv, self.n_unique)
        return out


def make_data_parser(data_cfg, **kw):
    """The parser of `data_cfg.scene_type`: "video", or one of the
    synthetic scenes "sceneflow", "carla" and "interiornet"
    (data/synthetic.py). `kw` goes to the parser (flow_backend, raft)."""
    scene_type = str(data_cfg.get("scene_type", "video")).lower()
    if scene_type == "video":
        return VideoDataParser(data_cfg, **kw)
    if scene_type in ("sceneflow", "carla", "interiornet"):
        from tclight_torch.data import synthetic

        return synthetic.make_parser(scene_type, data_cfg, **kw)
    raise NotImplementedError(f"scene type {scene_type}")
