"""Every cell's configuration, traffic, stage and metric files are found by
the names BENCHMARK.json gives, and the files hold what the harness reads."""

from __future__ import annotations

import importlib
import importlib.util
import math
import re

import pytest

from tcbench import run
from tcbench.reference import weights

from .conftest import load

BENCH = load(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_are_found_by_name(cell):
    w = load(run.TCBENCH / "workloads" / f"{cell['name']}.json")
    assert w["config"] == cell["config"] and w["traffic"] == cell["traffic"]
    assert w["chips"] == cell["chips"] == 1
    config = load(run.TCBENCH / "configs" / f"{w['config']}.json")
    assert config["name"] == w["config"]
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert entry["file"] == f"tcbench/configs/{w['config']}.json"
    assert entry["reduced"] == config["reduced"] == []
    traffic = load(run.TCBENCH / "traffic" / f"{w['traffic']}.json")
    assert hasattr(importlib.import_module(f"tcbench.traffic.{traffic['generator']}"), "latents")
    stage = importlib.import_module(f"tcbench.stages.{w['stage']}")
    assert hasattr(stage, "Stage")
    assert set(w["limits"]) and all(v > 0 for v in w["limits"].values())


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_are_found_by_name(metric):
    path = run.TCBENCH / "metrics" / f"{metric['name']}.py"
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)
    moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
    cells = {c["name"] for c in BENCH["workloads"]}
    assert set(metric["workloads"]) <= set(moved.get("workloads", cells)) <= cells


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_every_cell_reports_setup_a_rate_and_a_layer(cell):
    w = load(run.TCBENCH / "workloads" / f"{cell['name']}.json")
    e2e = {m["name"] for m in run.cell_metrics(BENCH, "end_to_end", cell["name"])}
    assert {"setup_s", "peak_device_gib", w["rate_metric"]} == e2e
    assert run.cell_metrics(BENCH, "per_layer", cell["name"])


def test_names_and_bounds_keep_to_the_contract():
    names = [m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k]]
    names += [c["name"] for c in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s", "sampling_s_per_frame"}
    assert len((run.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_weights_cover_the_published_widths(config):
    model = load(run.ROOT / config["file"])["model"]
    assert model["block_out_channels"] == [320, 640, 1280, 1280]
    assert model["num_heads"] == 8 and model["context_dim"] == 768
    n = sum(math.prod(s) for _, s in weights.unet_shapes(model))
    assert n == 859_532_484  # SD1.5's UNet with IC-Light's 8-channel conv_in
