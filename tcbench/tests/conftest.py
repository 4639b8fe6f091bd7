"""Shared helpers of the benchmark's tests: the tiny cells under data/ run
the harness end to end on the CPU (the program's plain kernel versions)."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from tcbench import run

DATA = Path(__file__).resolve().parent / "data"
TINY_BENCH = {
    "end_to_end": [{"name": "sampling_s_per_frame", "unit": "s/frame"},
                   {"name": "setup_s", "unit": "s"}, {"name": "peak_device_gib", "unit": "GiB"}],
    "per_layer": [{"name": "step_mfu.sampling", "unit": "%"},
                  {"name": "device_idle_share.sampling", "unit": "%"}],
}


@pytest.fixture
def tiny_run():
    """run_cell on a tiny cell on the CPU, with a short window."""

    def go(workload: str = "tiny-sample", seed: int = 2**31 + 77, seconds: float = 1.0,
           trace: bool = False, variant: str | None = None) -> dict:
        return run.run_cell(workload, seed, seconds, trace, TINY_BENCH, files=DATA,
                            device="cpu", variant=variant)

    return go


def load(path: Path) -> dict:
    return json.loads(Path(path).read_text())
