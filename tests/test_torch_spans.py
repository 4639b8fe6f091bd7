"""The program's spans on the sampling path (`utils.logging.span`): they
record only under torch.profiler, nest step > xy / yt > yt_window > slot >
unet > tome / attention with one slot a plan slot, change no output, close
where an exception leaves them, and time each step with the step's own
stopwatch; `profile_trace` writes them into its Chrome trace."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tclight_torch.config import ConfigDict
from tclight_torch.pipeline import generator as generator_mod
from tclight_torch.pipeline.generator import Generator
from tclight_torch.pipeline.iclight import build_tiny_iclight
from tclight_torch.utils import logging as tlogging

torch.set_num_threads(2)

N_FRAMES, LAT, STEPS = 6, 8, 2
PIPELINE = {"step", "xy", "yt", "yt_window", "slot", "scheduler"}


def _generator(alpha_t: float = 0.3) -> Generator:
    cfg = ConfigDict({
        "work_dir": "unused",
        "data": {"scene_type": "video", "rgb_path": "unused", "height": 8 * LAT,
                 "width": 8 * LAT, "fps": 8},
        "generation": {"n_timesteps": STEPS, "chunk_size": 4, "chunk_ord": "mix-4",
                       "local_merge_ratio": 0.5, "merge_global": True,
                       "global_merge_ratio": 0.5, "max_downsample": 2, "alpha_t": alpha_t,
                       "win_size_t": 4, "prompt": {"p": "warm light"}},
        "post_opt": {"apply_opt": False}, "seed": 5})
    return Generator(build_tiny_iclight(num_inference_steps=STEPS, device="cpu"), cfg,
                     device="cpu")


def _inputs():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((N_FRAMES, LAT, LAT, 4), generator=g)
    conds = torch.randn((N_FRAMES, LAT, LAT, 4), generator=g)
    emb = tuple(torch.randn((1, 77, 32), generator=g) for _ in range(4))
    return x, conds, emb[:2], emb[2:]


def _sample(gen: Generator) -> torch.Tensor:
    x, conds, embeds, embeds_t = _inputs()
    return gen.ddim_sample(x, embeds, conds, embeds_t=embeds_t, seed=11)


def _traced(gen: Generator, fn=_sample):
    # a session begun right after another, with no span between them to see
    # the profiler off, keeps the records until cleared
    tlogging.SPANS.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn(gen)
    return out, list(tlogging.SPANS.records)


def test_spans_nest_through_the_sampling_path(monkeypatch):
    plans = []
    make = generator_mod.chunklib.make_chunk_plan

    def recording(*args, **kwargs):
        plans.append(make(*args, **kwargs))
        return plans[-1]
    monkeypatch.setattr(generator_mod.chunklib, "make_chunk_plan", recording)
    _, recs = _traced(_generator())
    by_id = {r[0]: r for r in recs}
    assert len(by_id) == len(recs)
    name = {r[0]: r[2] for r in recs}

    def parent_name(r):
        return name.get(r[1])

    steps = sorted((r for r in recs if r[2] == "step"), key=lambda r: r[4])
    assert [r[3] for r in steps] == list(range(STEPS)) and all(r[1] is None for r in steps)
    for r in recs:
        sid, parent, n, step, t0, t1 = r
        assert t0 <= t1
        if parent is not None:
            p = by_id[parent]
            assert p[4] <= t0 and t1 <= p[5] and step == p[3]
        expected = {"step": None, "xy": "step", "yt": "step", "scheduler": "step",
                    "yt_window": "yt", "slot": {"xy", "yt_window"}, "unet": "slot",
                    "tome": "unet", "attention": "unet"}[n]
        if isinstance(expected, set):
            assert parent_name(r) in expected, r
        else:
            assert parent_name(r) == expected, r
    names = {r[2] for r in recs}
    assert names == PIPELINE | {"unet", "tome", "attention"}
    # one slot span per plan slot, the plans in the order they were drawn
    # (each step's xy plan, then its yt windows')
    passes = sorted((r for r in recs if r[2] in ("xy", "yt_window")), key=lambda r: r[4])
    assert len(passes) == len(plans)
    for r, plan in zip(passes, plans):
        assert sum(1 for s in recs if s[1] == r[0] and s[2] == "slot") == plan.n_slots
    # each UNet forward merges (two tome spans a merging block) and attends
    unets = [r for r in recs if r[2] == "unet"]
    assert len(unets) == sum(p.n_slots for p in plans)
    assert all(any(s[1] == u[0] and s[2] == "tome" for s in recs) for u in unets)
    assert all(any(s[1] == u[0] and s[2] == "attention" for s in recs) for u in unets)
    assert not tlogging.SPANS._open


def test_spans_off_record_nothing_and_change_nothing():
    gen = _generator()
    traced, recs = _traced(gen)
    assert recs
    tlogging.SPANS.clear()
    plain = _sample(gen)
    assert tlogging.SPANS.records == []
    assert torch.equal(plain, traced)
    # the first span of the next session clears what the last one left
    tlogging.SPANS.records.append("stale")
    with profile(activities=[ProfilerActivity.CPU]):
        again = _sample(gen)
    assert torch.equal(again, traced)
    assert sorted(r[2] for r in tlogging.SPANS.records) == sorted(r[2] for r in recs)
    # the span handed out while no profiler runs is one shared object
    assert tlogging.span("slot") is tlogging.span("unet")


def test_a_span_cut_by_an_exception_is_closed():
    gen = _generator(alpha_t=0.0)

    class Stop(Exception):
        pass

    def sync():
        if len(gen._last_step_times) == 1:
            raise Stop
    gen._sync = sync
    tlogging.SPANS.clear()
    with pytest.raises(Stop), profile(activities=[ProfilerActivity.CPU]):
        _sample(gen)
    recs = tlogging.SPANS.records
    steps = sorted((r for r in recs if r[2] == "step"), key=lambda r: r[4])
    assert [r[3] for r in steps] == [0, 1]
    sched = next(r for r in recs if r[2] == "scheduler" and r[3] == 1)
    assert steps[1][4] < sched[5] <= steps[1][5]
    assert not tlogging.SPANS._open


def test_step_times_are_the_step_spans():
    """`stage_times["step_times"]` (from `_last_step_times`) keeps one
    host-clock duration a step, and under the profiler it is the step span's."""
    gen = _generator()
    _, recs = _traced(gen)
    steps = sorted((r for r in recs if r[2] == "step"), key=lambda r: r[4])
    assert gen._last_step_times == [(r[5] - r[4]) * 1e-9 for r in steps]
    _sample(gen)
    assert len(gen._last_step_times) == STEPS and all(t > 0 for t in gen._last_step_times)


def test_step_times_stay_in_the_run_config(tmp_path):
    from tclight_torch.data.dataparsers import VideoDataParser
    from tclight_torch.utils.video_io import save_frames

    size, n = 32, 4
    rng = np.random.default_rng(0)
    save_frames(rng.uniform(0.2, 0.8, (n, size, size, 3)).astype(np.float32), tmp_path / "vid")
    cfg = ConfigDict({
        "work_dir": str(tmp_path / "wd"),
        "data": {"scene_type": "video", "rgb_path": str(tmp_path / "vid"),
                 "height": size, "width": size, "fps": 8},
        "generation": {"n_timesteps": STEPS, "chunk_size": 4, "prompt": {"p": "warm light"},
                       "local_merge_ratio": 0.0, "global_merge_ratio": 0.0},
        "post_opt": {"apply_opt": False}, "seed": 3})
    gen = Generator(build_tiny_iclight(num_inference_steps=STEPS, device="cpu"), cfg,
                    data_parser=VideoDataParser(cfg.data), device="cpu")
    gen(None, str(tmp_path / "out"), list(range(n)))
    st = gen.stage_times
    assert len(st["step_times"]) == STEPS and all(t > 0 for t in st["step_times"])
    assert sum(st["step_times"]) <= st["sampling"]


def test_profile_trace_writes_the_spans_on_the_trace_clock(tmp_path):
    gen = _generator(alpha_t=0.0)
    with tlogging.profile_trace(tmp_path, device="cpu"):
        _sample(gen)
    recs = list(tlogging.SPANS.records)
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "tclight_span"]
    assert len(spans) == len(recs) and {e["name"] for e in spans} == {r[2] for r in recs}
    # on the trace's clock: each UNet span holds the convolutions it ran
    # (the host ops of its thread), and the spans sit on a thread of their own
    convs = [e for e in events if e.get("ph") == "X" and e.get("name") == "aten::conv2d"]
    unets = [e for e in spans if e["name"] == "unet"]
    assert convs and unets
    for c in convs:
        assert any(u["ts"] <= c["ts"] and c["ts"] + c["dur"] <= u["ts"] + u["dur"]
                   for u in unets), c
    tid = spans[0]["tid"]
    assert all(e["tid"] == tid for e in spans)
    assert not any(e.get("tid") == tid for e in events if e.get("cat") not in
                   ("tclight_span", None))
    assert any(e.get("ph") == "M" and e.get("tid") == tid
               and e["args"].get("name") == "tclight_torch spans" for e in events)
