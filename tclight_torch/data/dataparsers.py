"""Video data parser (counterpart of tclight_tpu/data/dataparsers.py).

This slice ports frame loading only; flows, soft masks and pixel tracks,
which feed the post-optimization, come with it in a later slice.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from tclight_torch.utils.video_io import load_video


class VideoDataParser:
    def __init__(self, cfg):
        self.cfg = cfg
        self.rgb_path = cfg.get("rgb_path")
        self.height = cfg.get("height")
        self.width = cfg.get("width")
        self.fps = cfg.get("fps", 25)

    def load_video(self, frame_ids: Sequence[int] | None = None) -> np.ndarray:
        """(N, H, W, 3) float32 frames in [0, 1]."""
        return load_video(self.rgb_path, self.height, self.width, frame_ids=frame_ids)
