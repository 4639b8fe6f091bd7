"""Logging and cost accounting (counterpart of tclight_tpu/utils/logging.py):
one stdlib logger, and the wall-time + device-memory record that the run
config keeps (generate.py:577-611 of the reference)."""

from __future__ import annotations

import logging
import sys
import time
from typing import Any

import torch

_LOGGERS: dict[str, logging.Logger] = {}


def get_logger(name: str = "tclight_torch") -> logging.Logger:
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            fmt="%(asctime)s [%(levelname)s] %(name)s: %(message)s",
            datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    _LOGGERS[name] = logger
    return logger


class CostTracker:
    """Wall time and peak device memory (MB; 0 on the CPU) of one run."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.start_time = time.perf_counter()
        self.records: dict[str, Any] = {}

    def finish(self, n_frames: int, height: int, width: int) -> dict[str, Any]:
        total = time.perf_counter() - self.start_time
        peak = (torch.cuda.max_memory_allocated(self.device) / 2**20
                if self.device.type == "cuda" else 0.0)
        self.records = {
            "total_time": total,
            "sec_per_frame": total / max(n_frames, 1),
            "max_memory_allocated": peak,
            "total_frames": n_frames,
            "resolution": f"{width}x{height}",
        }
        return self.records
