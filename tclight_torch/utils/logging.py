"""Logging, timing and cost accounting (counterpart of
tclight_tpu/utils/logging.py): one stdlib logger; `timer`, a context
manager and decorator (cosmos1/utils/misc.py:139-183); device memory under
the JAX package's keys; a torch.profiler trace; a call timed to the end of
its device work; a call timed on the card by CUDA events
(`cuda_event_ms`); the wall-time + device-memory record that the run
config keeps (generate.py:577-611 of the reference); and the program's
spans (`span`), recorded only while a torch.profiler session runs and
written into `profile_trace`'s Chrome trace beside the kernels."""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import socket
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


class _NoSpan:
    """The span handed out while no profiler runs: shared, records nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None

    @staticmethod
    def end() -> int:
        return time.perf_counter_ns()


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("rec", "name", "step", "t0", "t1", "id", "parent")

    def __init__(self, rec: "SpanRecorder", name: str, step: int | None, t0: int | None):
        self.rec, self.name, self.step, self.t0, self.t1 = rec, name, step, t0, None

    def __enter__(self) -> "_Span":
        rec = self.rec
        self.id = rec._next_id
        rec._next_id += 1
        self.parent, step = rec._open[-1] if rec._open else (None, None)
        if self.step is None:
            self.step = step
        rec._open.append((self.id, self.step))
        if self.t0 is None:
            self.t0 = time.perf_counter_ns()
        return self

    def end(self) -> int:
        """Close the span now (its `with` block may run on); returns the
        clock reading, in ns."""
        self.t1 = time.perf_counter_ns()
        return self.t1

    def __exit__(self, *exc: Any) -> None:
        t1 = self.t1 if self.t1 is not None else time.perf_counter_ns()
        self.rec._open.pop()
        self.rec.records.append((self.id, self.parent, self.name, self.step, self.t0, t1))


class SpanRecorder:
    """The program's spans on one thread: `with recorder.span("slot"):`
    records (id, parent id, name, step index, t0_ns, t1_ns) on
    `time.perf_counter_ns`'s clock into `records`, but only while a
    torch.profiler session runs (any activity); otherwise it hands out a
    shared object that records nothing. A span's step index is its own
    `step` or its parent's. A span that an exception leaves is closed at
    that moment. `records` is cleared at the first span of a new profiler
    session (the first that finds the profiler on after one found it off)
    and by `clear()`; a reader takes it as it is."""

    def __init__(self) -> None:
        self.records: list[tuple] = []
        self._open: list[tuple[int, int | None]] = []  # (id, step) of the open spans
        self._next_id = 0
        self._live = False  # the profiler was on at the last span

    def span(self, name: str, step: int | None = None, t0: int | None = None):
        """A context manager timing its block; `t0` (perf_counter_ns) is its
        start where the caller already read the clock."""
        if not _profiler_enabled():
            if self._live:
                self._live = False
            return _NO_SPAN
        if not self._live:
            self._live = True
            self.records = []
        return _Span(self, name, step, t0)

    def clear(self) -> None:
        self.records = []


_profiler_enabled = torch.autograd._profiler_enabled
SPANS = SpanRecorder()
span = SPANS.span


def _clock_anchor() -> tuple[str, float, float]:
    """A record_function event and the perf_counter_ns interval around it,
    in us: the tightest of three (the first call is slow). Returns (event
    name, start us, end us)."""
    best = None
    for k in range(3):
        name = f"tclight_torch.clock_anchor.{k}"
        a = time.perf_counter_ns()
        with torch.profiler.record_function(name):
            pass
        b = time.perf_counter_ns()
        if best is None or b - a < best[2] - best[1]:
            best = (name, a * 1e-3, b * 1e-3)
    return best


def write_spans_into_chrome_trace(path: str | Path, records: list[tuple],
                                  anchor: tuple[str, float, float]) -> None:
    """Add `records` to the Chrome trace at `path` as complete events of
    category `tclight_span` on a thread of their own ("tclight_torch
    spans", sorted first), mapped onto the trace's clock through the
    `anchor` event (`_clock_anchor`): its middle is the middle of the clock
    readings around it. A trace without the anchor is left as it is."""
    path = Path(path)
    trace = json.loads(path.read_text())
    events = trace.get("traceEvents", [])
    name, a_us, b_us = anchor
    ev = next((e for e in events if e.get("ph") == "X" and e.get("name") == name), None)
    if ev is None:
        return
    dur = float(ev.get("dur", 0.0))
    offset = float(ev["ts"]) + 0.5 * dur - 0.5 * (a_us + b_us)
    pid = ev["pid"]
    tid = 1 + max((e["tid"] for e in events if isinstance(e.get("tid"), int)), default=0)
    events += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": "tclight_torch spans"}},
               {"ph": "M", "name": "thread_sort_index", "pid": pid, "tid": tid,
                "args": {"sort_index": -1}}]
    for sid, parent, sname, step, t0, t1 in records:
        events.append({"ph": "X", "cat": "tclight_span", "name": sname, "pid": pid, "tid": tid,
                       "ts": t0 * 1e-3 + offset, "dur": (t1 - t0) * 1e-3,
                       "args": {"id": sid, "parent": parent, "step": step}})
    trace["traceEvents"] = events
    path.write_text(json.dumps(trace))


@contextlib.contextmanager
def profile_trace(log_dir: str | Path, device: torch.device | str = "cuda"
                  ) -> Iterator[torch.profiler.profile]:
    """torch.profiler over the block, host and (on a CUDA device) card
    activity, its Chrome trace written under `log_dir` as
    `<worker>.<ms>.pt.trace.json` with the program's spans of the block in
    it (`write_spans_into_chrome_trace`). Yields the profile
    (`key_averages()`)."""
    from torch.profiler import ProfilerActivity, profile

    device = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    anchor: list = []

    def write(prof: torch.profiler.profile) -> None:
        log_dir.mkdir(parents=True, exist_ok=True)
        path = log_dir / (f"{socket.gethostname()}_{os.getpid()}."
                          f"{int(time.time() * 1000)}.pt.trace.json")
        prof.export_chrome_trace(str(path))
        write_spans_into_chrome_trace(path, SPANS.records, anchor[0])

    with profile(activities=activities, on_trace_ready=write) as prof:
        SPANS.clear()
        anchor.append(_clock_anchor())
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
