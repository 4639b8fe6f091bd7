"""Logging, timing and cost accounting (counterpart of
tclight_tpu/utils/logging.py): one stdlib logger; `timer`, a context
manager and decorator (cosmos1/utils/misc.py:139-183); device memory under
the JAX package's keys; a torch.profiler trace; a call timed to the end of
its device work; a call timed on the card by CUDA events
(`cuda_event_ms`); and the wall-time + device-memory record that the run
config keeps (generate.py:577-611 of the reference)."""

from __future__ import annotations

import contextlib
import functools
import logging
import sys
import time
from pathlib import Path
from typing import Any, Callable, Iterator

import torch

from tclight_torch.utils.device import resolve_device

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


class timer(contextlib.ContextDecorator):
    """`with timer("step"):` or `@timer("step")`: logs the elapsed seconds
    (host clock: the caller synchronizes the device where it matters)."""

    def __init__(self, message: str, logger: logging.Logger | None = None):
        self.message = message
        self.logger = logger or get_logger()
        self.elapsed: float | None = None

    def __enter__(self) -> "timer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.elapsed = time.perf_counter() - self._start
        self.logger.info("%s took %.3f s", self.message, self.elapsed)


def device_memory_stats(device: torch.device | str = "cuda") -> dict[str, float]:
    """Current and peak allocated memory and the card's size, in MB, under
    the JAX package's keys; {} for a CPU device."""
    device = resolve_device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    mb = 1.0 / 2**20
    return {
        "bytes_in_use(M)": stats.get("allocated_bytes.all.current", 0) * mb,
        "peak_bytes_in_use(M)": stats.get("allocated_bytes.all.peak", 0) * mb,
        "bytes_limit(M)": total * mb,
    }


@contextlib.contextmanager
def profile_trace(log_dir: str | Path, device: torch.device | str = "cuda"
                  ) -> Iterator[torch.profiler.profile]:
    """torch.profiler over the block, host and (on a CUDA device) card
    activity, its Chrome trace written under `log_dir` as
    `<worker>.<ms>.pt.trace.json`. Yields the profile (`key_averages()`)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    device = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _cuda_devices(obj: Any) -> set[torch.device]:
    """The CUDA devices of the tensors in nested tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        return {obj.device} if obj.is_cuda else set()
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return set().union(*map(_cuda_devices, obj))
    return set()


def block_and_time(fn: Callable[..., Any]) -> Callable[..., tuple[Any, float]]:
    """Wrap fn to return (out, seconds), the seconds running to the end of
    the device work that made out's tensors."""

    @functools.wraps(fn)
    def wrapped(*args: Any, **kw: Any) -> tuple[Any, float]:
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        for device in _cuda_devices(out):
            torch.cuda.synchronize(device)
        return out, time.perf_counter() - t0

    return wrapped


def cuda_event_ms(fn: Callable[[], Any], reps: int, repeats: int = 1) -> tuple[float, float]:
    """Milliseconds a call of fn() takes on the card: a warm-up call, then
    `repeats` times `reps` calls between two CUDA events, each divided by
    `reps`. Returns the median of the repeats and their spread (max - min,
    0 for one). Raises without a card: a device time comes only from one."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_event_ms: no CUDA device")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    times.sort()
    mid = len(times) // 2
    median = times[mid] if len(times) % 2 else (times[mid - 1] + times[mid]) / 2
    return median, times[-1] - times[0]


class CostTracker:
    """Wall time and peak device memory (MB; 0 on the CPU) of one run."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.start_time = time.perf_counter()
        self.records: dict[str, Any] = {}

    def finish(self, n_frames: int, height: int, width: int) -> dict[str, Any]:
        total = time.perf_counter() - self.start_time
        peak = device_memory_stats(self.device).get("peak_bytes_in_use(M)", 0.0)
        self.records = {
            "total_time": total,
            "sec_per_frame": total / max(n_frames, 1),
            "max_memory_allocated": peak,
            "total_frames": n_frames,
            "resolution": f"{width}x{height}",
        }
        return self.records
